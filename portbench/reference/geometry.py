"""Host-side geometry library (pure numpy).

Provides the angular / SE(3) / polar-grid primitives used by both the data
layer and the device-side BEV projector. Behaviour parity with the reference:

- ``se3_from_xyzhe``        ~ transfrom3D (reference pretrain_src/model/bev_utils.py:7-36)
- ``bev_polar_pos``         ~ bevpos_polar (bev_utils.py:39-58)
- ``angle_features``        ~ get_angle_fts (pretrain_src/data/common.py:43-49)
- ``view_rel_angles``       ~ get_view_rel_angles (common.py:51-68)
- ``rel_pos_features``      ~ calculate_vp_rel_pos_fts (common.py:111-128)
- ``normalize_angle``       ~ normalize_angle (common.py:130-135)
- ``camera_intrinsics``     ~ ProjectorUtils.compute_intrinsic_matrix (bev_utils.py:91-100)
- ``pixel_ray_scales``      ~ ProjectorUtils.compute_scaling_params (bev_utils.py:103-137)

All functions are pure and trivially vectorised; golden tests in
tests/test_geometry.py pin the numerics.

A frozen copy of the program's ``geometry.py`` for the benchmark's reference:
later changes to the program do not reach it.
"""

from __future__ import annotations

import math

import numpy as np

MAX_DIST = 30.0   # distance normaliser (ref pretrain_src/data/dataset.py:19)
MAX_STEP = 10.0   # step-count normaliser (dataset.py:20)
ANCHOR_HEADINGS = np.radians(np.arange(12) * 30.0)  # 12 discrete camera headings


def rot_x(theta: np.ndarray) -> np.ndarray:
    """Batched rotation about the x axis (elevation). theta: (...,)."""
    c, s = np.cos(theta), np.sin(theta)
    o, z = np.ones_like(c), np.zeros_like(c)
    rows = [
        [o, z, z],
        [z, c, -s],
        [z, s, c],
    ]
    return np.stack([np.stack(r, axis=-1) for r in rows], axis=-2)


def rot_y(theta: np.ndarray) -> np.ndarray:
    """Batched rotation about the y axis (heading, y-up convention)."""
    c, s = np.cos(theta), np.sin(theta)
    o, z = np.ones_like(c), np.zeros_like(c)
    rows = [
        [c, z, s],
        [z, o, z],
        [-s, z, c],
    ]
    return np.stack([np.stack(r, axis=-1) for r in rows], axis=-2)


def se3_from_xyzhe(xyzhe: np.ndarray) -> np.ndarray:
    """(N, 5) [x, y, z, heading, elevation] -> (N, 4, 4) camera-to-world.

    Rotation is R_y(heading) @ R_x(elevation) in the y-up MP3D/Habitat camera
    frame, translation is (x, y, z). Matches transfrom3D
    (reference pretrain_src/model/bev_utils.py:7-36) bit-for-bit.
    """
    xyzhe = np.asarray(xyzhe, dtype=np.float32)
    n = xyzhe.shape[0]
    R = rot_y(xyzhe[:, 3]) @ rot_x(xyzhe[:, 4])
    T = np.zeros((n, 4, 4), dtype=np.float64)
    T[:, :3, :3] = R
    T[:, :3, 3] = xyzhe[:, :3]
    T[:, 3, 3] = 1.0
    return T.astype(np.float32)


def bev_polar_pos(map_dim: int) -> np.ndarray:
    """(map_dim, map_dim, 3) per-cell polar encoding (cos, sin, dist/max).

    Cell centres measured from the grid centre with the row axis flipped so +y
    points 'up'; distance normalised by map_dim/2. Centre cell gets (0, 0, 0).
    Parity with bevpos_polar (bev_utils.py:39-58).
    """
    centres = np.arange(map_dim, dtype=np.float32) + 0.5 - map_dim / 2.0
    y = -centres[:, None] * np.ones((1, map_dim), dtype=np.float32)  # flip rows
    x = np.ones((map_dim, 1), dtype=np.float32) * centres[None, :]
    dist = np.sqrt(x * x + y * y)
    with np.errstate(divide="ignore", invalid="ignore"):
        cos = np.where(dist > 0, x / dist, 0.0)
        sin = np.where(dist > 0, y / dist, 0.0)
    return np.stack([cos, sin, dist / (map_dim / 2.0)], axis=-1).astype(np.float32)


def angle_features(headings, elevations, angle_feat_size: int = 4) -> np.ndarray:
    """(N,) headings/elevations -> (N, angle_feat_size) [sin h, cos h, sin e, cos e]
    tiled to angle_feat_size. Parity with get_angle_fts (common.py:43-49)."""
    headings = np.asarray(headings, dtype=np.float32)
    elevations = np.asarray(elevations, dtype=np.float32)
    base = np.stack(
        [np.sin(headings), np.cos(headings), np.sin(elevations), np.cos(elevations)],
        axis=-1,
    ).astype(np.float32)
    reps = angle_feat_size // 4
    return np.concatenate([base] * reps, axis=-1) if reps > 1 else base


def view_rel_angles(base_view_id: int = 0) -> np.ndarray:
    """(36, 2) heading/elevation of each of the 36 pano views relative to
    base_view_id. View layout: 3 elevation rings (-30, 0, +30 deg) x 12
    headings of 30 deg. Parity with get_view_rel_angles (common.py:51-68)."""
    ids = np.arange(36)
    headings = (ids % 12) * math.radians(30.0)
    elevations = (ids // 12 - 1) * math.radians(30.0)
    base_h = (base_view_id % 12) * math.radians(30.0)
    base_e = (base_view_id // 12 - 1) * math.radians(30.0)
    out = np.stack([headings - base_h, elevations - base_e], axis=-1)
    return out.astype(np.float32)


def rel_pos_features(a, b, base_heading: float = 0.0, base_elevation: float = 0.0):
    """Relative (heading, elevation, euclidean distance) from point a to b in
    MP3D world coordinates (the simulator's transposed x-y convention:
    heading = arcsin(dx / xy_dist), reflected when dy < 0).
    Parity with calculate_vp_rel_pos_fts (common.py:111-128)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    d = b - a
    xy = max(float(np.hypot(d[0], d[1])), 1e-8)
    xyz = max(float(np.linalg.norm(d[:3])), 1e-8)
    heading = float(np.arcsin(np.clip(d[0] / xy, -1.0, 1.0)))
    if d[1] < 0:
        heading = math.pi - heading
    elevation = float(np.arcsin(np.clip(d[2] / xyz, -1.0, 1.0)))
    return heading - base_heading, elevation - base_elevation, xyz


def rel_pos_features_batch(a, bs, base_heading: float = 0.0,
                           base_elevation: float = 0.0):
    """Vectorised rel_pos_features: point ``a`` to EACH row of ``bs``.

    Returns (headings, elevations, distances) as (N,) float64 arrays with
    identical math to the scalar version (the pretrain host pipeline calls
    this once per node table instead of once per node)."""
    a = np.asarray(a, dtype=np.float64)
    bs = np.asarray(bs, dtype=np.float64).reshape(-1, 3)
    d = bs - a[None, :3]
    xy = np.maximum(np.hypot(d[:, 0], d[:, 1]), 1e-8)
    xyz = np.maximum(np.linalg.norm(d, axis=1), 1e-8)
    heading = np.arcsin(np.clip(d[:, 0] / xy, -1.0, 1.0))
    heading = np.where(d[:, 1] < 0, math.pi - heading, heading)
    elevation = np.arcsin(np.clip(d[:, 2] / xyz, -1.0, 1.0))
    return heading - base_heading, elevation - base_elevation, xyz


def normalize_angle(x):
    """Map radians into (-pi, pi]. Parity with common.py:130-135."""
    x = np.asarray(x, dtype=np.float64) % (2.0 * math.pi)
    return np.where(x > math.pi, x - 2.0 * math.pi, x)


def nearest_anchor(query: float, anchors: np.ndarray = ANCHOR_HEADINGS) -> int:
    """Index of the anchor heading closest (on the circle) to query.
    Parity with nearest_anchor (dataset.py:25-28)."""
    return int(np.argmax(np.cos(query - anchors)))


def camera_intrinsics(width: int, height: int, vfov: float) -> np.ndarray:
    """3x3 pinhole intrinsics from a vertical FOV (radians); hfov scales with
    aspect ratio. Parity with bev_utils.py:91-100."""
    hfov = width / height * vfov
    fx = width / (2.0 * math.tan(hfov / 2.0))
    fy = height / (2.0 * math.tan(vfov / 2.0))
    return np.array(
        [[fx, 0.0, width / 2.0], [0.0, fy, height / 2.0], [0.0, 0.0, 1.0]],
        dtype=np.float32,
    )


def pixel_ray_scales(width: int, height: int, vfov: float):
    """Per-pixel (x_scale, y_scale) such that a depth d un-projects to camera
    coords (d * x_scale, d * y_scale, d). Rays pass through pixel centres
    (the +0.5). Parity with compute_scaling_params (bev_utils.py:103-137)."""
    K = camera_intrinsics(width, height, vfov)
    us = np.arange(width, dtype=np.float32) + 0.5
    vs = np.arange(height, dtype=np.float32) + 0.5
    x_scale = (us[None, :] - K[0, 2]) / K[0, 0] * np.ones((height, 1), np.float32)
    y_scale = (vs[:, None] - K[1, 2]) / K[1, 1] * np.ones((1, width), np.float32)
    return x_scale, y_scale


def bev_camera_poses(position_xyz, num_views: int = 12) -> np.ndarray:
    """(num_views, 5) xyzhe of the BEV source cameras at a viewpoint.

    World axes are remapped MP3D (x, y, z) -> (x, z, -y) so that 'up' is +y,
    cameras sweep counter-clockwise in 30-degree steps, and elevation pi flips
    the camera into the y-up render convention.
    Parity with get_bev_inputs (dataset.py:405-411).
    """
    x, y, z = (float(v) for v in position_xyz[:3])
    xyzhe = np.zeros((num_views, 5), dtype=np.float32)
    xyzhe[:, 0] = x
    xyzhe[:, 1] = z
    xyzhe[:, 2] = -y
    xyzhe[:, 3] = -np.arange(num_views) * math.radians(360.0 / num_views)
    xyzhe[:, 4] = math.pi
    return xyzhe


def world_to_ego_cand_cells(
    cand_positions: np.ndarray,
    centre_xyz: np.ndarray,
    heading: float,
    bev_dim: int,
    bev_res: float,
) -> np.ndarray:
    """Map candidate world positions into egocentric BEV cell indices.

    cand_positions: (K, 3) MP3D world xyz. Returns (K,) flat cell indices,
    clamped to the grid. Parity with get_bev_inputs (dataset.py:420-437).
    """
    pts = np.asarray(cand_positions, dtype=np.float32)[:, [0, 2, 1]] * np.array(
        [1.0, 1.0, -1.0], dtype=np.float32
    )
    centre = np.asarray(centre_xyz, dtype=np.float32)[[0, 2, 1]] * np.array(
        [1.0, 1.0, -1.0], dtype=np.float32
    )
    pts = pts - centre[None, :]
    # Rotate points by R_y(+heading) into the ego frame — the same rotation the
    # device splat applies to the point cloud (ref pretrain_cmt.py:136 with
    # T_w2c built from +cur_heading at dataset.py:415-417; the candidate path
    # at dataset.py:421-430 matches because numpy's transpose(0,1) on a 2-D
    # matrix is the identity, cancelling its -heading).
    R = rot_y(np.float32(heading))
    ego = pts @ R.T
    cells = np.round(ego[:, [0, 2]] / bev_res) + (bev_dim - 1) // 2
    cells = np.clip(cells, 0, bev_dim - 1).astype(np.int64)
    return cells[:, 1] * bev_dim + cells[:, 0]


def world_to_ego_cells_stop_centre(
    cand_positions: np.ndarray,
    centre_xyz: np.ndarray,
    heading: float,
    bev_dim: int,
    bev_res: float,
) -> np.ndarray:
    """Candidate cells with the [stop] cell (grid centre) prepended at index 0
    (ref dataset.py:437-438)."""
    if len(cand_positions):
        cells = world_to_ego_cand_cells(
            cand_positions, centre_xyz, heading, bev_dim, bev_res
        )
    else:
        cells = np.zeros((0,), np.int64)
    centre = (bev_dim * bev_dim - 1) // 2
    return np.concatenate([[centre], cells]).astype(np.int64)
