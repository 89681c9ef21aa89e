"""Per-sensor observation transforms for continuous-env frames.

Role of the reference's habitat ObservationTransformers
(bevbert_ce/habitat_extensions/obs_transformers.py:19-264:
CenterCropperPerSensor / ResizerPerSensor / CubeMap2Equirect, configured per
sensor key like ``rgb_0..rgb_11`` -> 224 crops for CLIP, depth -> 256). Here
observations are plain dicts of numpy arrays, so the transforms are pure
functions; a transform list applies in order like apply_obs_transforms_batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

Size = Union[int, Tuple[int, int]]


def _hw(size: Size) -> Tuple[int, int]:
    if isinstance(size, (int, np.integer)):
        return int(size), int(size)
    assert len(size) == 2
    return int(size[0]), int(size[1])


def center_crop(img: np.ndarray, size: Size) -> np.ndarray:
    """(..., H, W, C) center crop; pads symmetrically with zeros when the
    target exceeds the frame (matching torchvision's behaviour the reference
    relies on)."""
    th, tw = _hw(size)
    h, w = img.shape[-3], img.shape[-2]
    if th > h or tw > w:
        ph, pw = max(th - h, 0), max(tw - w, 0)
        pad = [(0, 0)] * (img.ndim - 3) + [
            (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2), (0, 0)]
        img = np.pad(img, pad)
        h, w = img.shape[-3], img.shape[-2]
    y0, x0 = (h - th) // 2, (w - tw) // 2
    return img[..., y0:y0 + th, x0:x0 + tw, :]


def _area_slabs(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """Adaptive-pool slab bounds: output cell i averages input
    [floor(i*n/out), ceil((i+1)*n/out)) — torch interpolate(mode="area") ==
    adaptive_avg_pool semantics."""
    i = np.arange(n_out, dtype=np.int64)
    starts = (i * n_in) // n_out
    ends = -((-(i + 1) * n_in) // n_out)
    return starts, ends


def _area_sum_axis(x: np.ndarray, n_out: int, axis: int):
    """Slab SUMS along ``axis`` (f64) plus the per-slab sizes. Sums, not
    means: dividing per axis (mean-of-means) rounds twice and lands a ulp off
    torch's one 2D-block division, which flips integer-truncation boundaries;
    the caller divides once by the full block size."""
    starts, ends = _area_slabs(x.shape[axis], n_out)
    cs = np.cumsum(x, axis=axis, dtype=np.float64)
    pad = [(0, 0)] * x.ndim
    pad[axis] = (1, 0)
    cs = np.pad(cs, pad)
    return np.take(cs, ends, axis=axis) - np.take(cs, starts, axis=axis), \
        (ends - starts).astype(np.float64)


def resize(img: np.ndarray, size: Size) -> np.ndarray:
    """(..., H, W, C) area-interpolation resize — exact numpy counterpart of
    the reference's ``F.interpolate(img.float(), size, mode="area")`` followed
    by a cast back to the input dtype (ResizerPerSensor._transform_obs, ref
    obs_transformers.py:143-171); torch parity pinned in
    tests/test_obs_transforms.py."""
    th, tw = _hw(size)
    h, w = img.shape[-3], img.shape[-2]
    if (h, w) == (th, tw):
        return img
    sums, nh = _area_sum_axis(img, th, img.ndim - 3)
    sums, nw = _area_sum_axis(sums, tw, img.ndim - 2)
    shape_h = [1] * img.ndim
    shape_h[img.ndim - 3] = th
    shape_w = [1] * img.ndim
    shape_w[img.ndim - 2] = tw
    out = sums / (nh.reshape(shape_h) * nw.reshape(shape_w))
    return out.astype(img.dtype)


class CenterCropperPerSensor:
    """sensor key -> crop size; keys absent from an observation are skipped
    (ref obs_transformers.py:20-98)."""

    def __init__(self, sensor_crops: Sequence[Tuple[str, Size]]):
        self.sensor_crops = {k: _hw(v) for k, v in sensor_crops}

    def __call__(self, obs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        for k, size in self.sensor_crops.items():
            if k in obs and obs[k].shape[-3:-1] != size:
                obs[k] = center_crop(obs[k], size)
        return obs


class ResizerPerSensor:
    """sensor key -> target size (ref obs_transformers.py:100-175)."""

    def __init__(self, sensor_resizes: Sequence[Tuple[str, Size]]):
        self.sensor_resizes = {k: _hw(v) for k, v in sensor_resizes}

    def __call__(self, obs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        for k, size in self.sensor_resizes.items():
            if k in obs and obs[k].shape[-3:-1] != size:
                obs[k] = resize(obs[k], size)
        return obs


# ---------------------------------------------------------------------------
# Cubemap -> equirectangular projection (ref obs_transformers.py:194-264:
# Cube2Equirect / CubeMap2Equirect over habitat_baselines' ProjectionConverter)

# habitat's fixed sensor order for cubemap stitching (ref :219-222)
CUBE_FACE_ORDER = ("back", "down", "front", "left", "right", "up")

# world->camera rotations for each 90-degree FOV face camera. Habitat camera
# convention: looks along -z, +y up, +x right. A direction d (world) lands on
# face f when, in f's frame, dc = R_f @ d has dc_z < 0 and |dc_x|,|dc_y| <=
# -dc_z (the 90-degree frustum).
_FACE_ROTATIONS = {
    "front": np.eye(3),
    "back":  np.diag([-1.0, 1.0, -1.0]),                       # yaw 180
    "left":  np.array([[0.0, 0, -1], [0, 1, 0], [1, 0, 0]]),   # looks -x
    "right": np.array([[0.0, 0, 1], [0, 1, 0], [-1, 0, 0]]),   # looks +x
    "up":    np.array([[1.0, 0, 0], [0, 0, 1], [0, -1, 0]]),   # looks +y
    "down":  np.array([[1.0, 0, 0], [0, 0, -1], [0, 1, 0]]),   # looks -y
}


def cube_face_directions(face: str, hw: Size) -> np.ndarray:
    """(H, W, 3) unit world-direction of every pixel of a 90-degree-FOV face
    camera (pixel centres; row 0 = top). Shared by the projector and its
    tests (render an analytic panorama onto faces, then stitch)."""
    h, w = _hw(hw)
    R = _FACE_ROTATIONS[face]
    # NDC in [-1, 1] at pixel centres; v grows downward, camera +y is up
    u = (np.arange(w) + 0.5) / w * 2.0 - 1.0
    v = (np.arange(h) + 0.5) / h * 2.0 - 1.0
    dc = np.stack(
        [np.broadcast_to(u[None, :], (h, w)),
         np.broadcast_to(-v[:, None], (h, w)),
         -np.ones((h, w))], axis=-1,
    )
    d = dc @ R  # camera->world: R is orthonormal, so R^-1 = R^T; dc @ R == R.T @ dc
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


class CubeMap2Equirect:
    """Stitch six 90-degree-FOV face sensors into one equirectangular frame
    (ref obs_transformers.py:212-264 + habitat_baselines ProjectionConverter).

    ``sensor_uuids`` lists the faces in habitat's fixed Back, Down, Front,
    Left, Right, Up order; the result overwrites ``target_uuids`` (default:
    the first sensor's uuid, like the reference) and removes the other five.
    Sensors whose uuid contains ``depth_key`` sample with nearest-neighbour
    (averaging depth across a face seam fabricates geometry); colour sensors
    sample bilinearly, matching grid_sample in the reference's converter.

    The (face, y, x) sampling grid depends only on the output shape, so it is
    precomputed once at construction — the per-frame work is one gather + one
    weighted sum over numpy arrays.
    """

    def __init__(
        self,
        sensor_uuids: Sequence[str],
        eq_shape: Tuple[int, int],
        target_uuids: Optional[Sequence[str]] = None,
        depth_key: str = "depth",
    ):
        assert len(sensor_uuids) % 6 == 0, "six face sensors per output"
        self.sensor_uuids = list(sensor_uuids)
        self.eq_shape = (int(eq_shape[0]), int(eq_shape[1]))
        self.target_uuids = (
            list(target_uuids) if target_uuids is not None
            else [self.sensor_uuids[0]]
        )
        self.depth_key = depth_key
        self._grid = None  # (face_idx, fy, fx) lazily sized to the face input

    def _build_grid(self, face_hw: Tuple[int, int]):
        eh, ew = self.eq_shape
        fh, fw = face_hw
        # equirect pixel centres: longitude [-pi, pi) across width (0 at the
        # centre column = front), latitude +pi/2 (top) .. -pi/2 (bottom)
        lon = ((np.arange(ew) + 0.5) / ew * 2.0 - 1.0) * np.pi
        lat = (0.5 - (np.arange(eh) + 0.5) / eh) * np.pi
        d = np.stack(
            [np.cos(lat)[:, None] * np.sin(lon)[None, :],
             np.broadcast_to(np.sin(lat)[:, None], (eh, ew)),
             -np.cos(lat)[:, None] * np.cos(lon)[None, :]], axis=-1,
        )  # (eh, ew, 3) world directions, habitat camera convention
        face_idx = np.zeros((eh, ew), np.int8)
        fy = np.zeros((eh, ew), np.float32)
        fx = np.zeros((eh, ew), np.float32)
        best = np.full((eh, ew), -np.inf, np.float32)
        for i, face in enumerate(CUBE_FACE_ORDER):
            dc = d @ _FACE_ROTATIONS[face].T
            depth = -dc[..., 2]
            # dominant-axis test with ties broken by the deepest view ray
            # keeps every direction on exactly one face
            inside = (depth >= np.abs(dc[..., 0]) - 1e-9) & (
                depth >= np.abs(dc[..., 1]) - 1e-9) & (depth > best)
            u = np.where(inside, dc[..., 0] / np.maximum(depth, 1e-9), 0.0)
            v = np.where(inside, -dc[..., 1] / np.maximum(depth, 1e-9), 0.0)
            face_idx = np.where(inside, i, face_idx)
            # NDC -> pixel coordinates (inverse of cube_face_directions)
            fy = np.where(inside, (v + 1.0) * 0.5 * fh - 0.5, fy).astype(np.float32)
            fx = np.where(inside, (u + 1.0) * 0.5 * fw - 0.5, fx).astype(np.float32)
            best = np.where(inside, depth, best)
        self._grid = (face_idx, fy, fx)

    def _stitch(self, faces: np.ndarray, nearest: bool) -> np.ndarray:
        """faces: (6, fh, fw, C) in CUBE_FACE_ORDER -> (eh, ew, C)."""
        if self._grid is None or self._grid[1].shape != self.eq_shape:
            self._build_grid(faces.shape[1:3])
        face_idx, fy, fx = self._grid
        fh, fw = faces.shape[1:3]
        if nearest:
            y = np.clip(np.rint(fy).astype(np.int64), 0, fh - 1)
            x = np.clip(np.rint(fx).astype(np.int64), 0, fw - 1)
            return faces[face_idx, y, x]
        y0 = np.clip(np.floor(fy).astype(np.int64), 0, fh - 1)
        x0 = np.clip(np.floor(fx).astype(np.int64), 0, fw - 1)
        y1 = np.minimum(y0 + 1, fh - 1)
        x1 = np.minimum(x0 + 1, fw - 1)
        wy = np.clip(fy - y0, 0.0, 1.0)[..., None]
        wx = np.clip(fx - x0, 0.0, 1.0)[..., None]
        f = faces.astype(np.float32)
        top = f[face_idx, y0, x0] * (1 - wx) + f[face_idx, y0, x1] * wx
        bot = f[face_idx, y1, x0] * (1 - wx) + f[face_idx, y1, x1] * wx
        return (top * (1 - wy) + bot * wy).astype(faces.dtype)

    def __call__(self, obs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        for group in range(len(self.sensor_uuids) // 6):
            uuids = self.sensor_uuids[group * 6:(group + 1) * 6]
            if not all(u in obs for u in uuids):
                continue
            faces = np.stack([np.asarray(obs[u]) for u in uuids])
            squeeze = faces.ndim == 3  # (6, H, W) depth without channel dim
            if squeeze:
                faces = faces[..., None]
            target = (self.target_uuids[group]
                      if group < len(self.target_uuids) else uuids[0])
            out = self._stitch(faces, nearest=self.depth_key in target)
            obs[target] = out[..., 0] if squeeze else out
            for u in uuids:
                if u != target:
                    obs.pop(u, None)
        return obs


def apply_obs_transforms(transforms: List, obs_batch: List[Dict]) -> List[Dict]:
    """Apply a transform pipeline to every observation in a batch
    (ref habitat_baselines apply_obs_transforms_batch)."""
    for transform in transforms:
        obs_batch = [transform(ob) for ob in obs_batch]
    return obs_batch
