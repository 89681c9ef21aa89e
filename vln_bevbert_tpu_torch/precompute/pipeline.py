"""Offline feature precompute pipeline (port of
``vln_bevbert_tpu/precompute/pipeline.py``).

Role of precompute_features/: drive a renderer over every
(scan, viewpoint), push frames through a frozen image encoder, and write the
four HDF5 products the training stack consumes (36-view pooled features,
12-view patch-grid features, 14x14 depth stored as metres/10, 14x14 semantic
labels — grid_habitat_clip.py:74-140, grid_depth.py:58-110, grid_sem.py).

Pluggable pieces:
- ``ImageSource``: yields per-viewpoint frames. The reference drives
  MatterSim for poses + habitat for pixels (C++ sims, absent here);
  ``SyntheticImageSource`` generates deterministic frames so the pipeline is
  runnable/testable, and a real binding implements the same iterator.
- ``Encoder``: pooled 36-view features + 12-view patch grids.
  ``DeviceClipEncoder`` runs the port's CLIP tower (``models/clip.py``) on
  the card; ``ClipEncoder``/``ImageNetViTEncoder`` wrap transformers towers
  (frozen, local cache only); ``RandomProjectionEncoder`` is a
  dependency-free stand-in.

The single-writer structure of the reference's multiprocessing fan-out
(grid_habitat_clip.py:130-160) collapses to a plain loop here (feature
extraction is device-bound, not worker-bound). ``dump_depth_features`` runs
the port's DDPPO tower (``models/depth_encoder.py``). h5py, torch's
towers and transformers are imported where they are used.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np


class SyntheticImageSource:
    """Deterministic random frames per (scan, viewpoint)."""

    def __init__(self, scan_viewpoints: Dict[str, Iterable[str]],
                 image_hw: int = 224, grid_hw: int = 14, num_views: int = 12,
                 num_sem: int = 40, seed: int = 0):
        self.scan_viewpoints = {k: list(v) for k, v in scan_viewpoints.items()}
        self.image_hw = image_hw
        self.grid_hw = grid_hw
        self.num_views = num_views
        self.num_sem = num_sem
        self.seed = seed

    def __iter__(self) -> Iterator[Tuple[str, str, dict]]:
        for scan, vps in self.scan_viewpoints.items():
            for vp in vps:
                import zlib

                # crc32, not hash(): string hashing is salted per
                # interpreter, which would make re-runs non-reproducible
                rng = np.random.default_rng(
                    zlib.crc32(f"{scan}|{vp}|{self.seed}".encode())
                )
                yield scan, vp, {
                    "views36": rng.integers(
                        0, 255, (36, self.image_hw, self.image_hw, 3)
                    ).astype(np.uint8),
                    # normalised [0, 1] depth per discretized view, the shape
                    # the habitat depth sensor produces (save_habitat_img.py:88)
                    "views36_depth": rng.uniform(
                        0.0, 1.0, (36, self.image_hw, self.image_hw, 1)
                    ).astype(np.float32),
                    "ring12": rng.integers(
                        0, 255, (self.num_views, self.image_hw, self.image_hw, 3)
                    ).astype(np.uint8),
                    "depth": rng.uniform(
                        0.2, 9.0, (self.num_views, self.grid_hw, self.grid_hw)
                    ).astype(np.float32),
                    "sem": rng.integers(
                        0, self.num_sem, (self.num_views, self.grid_hw, self.grid_hw)
                    ).astype(np.uint8),
                }


class RandomProjectionEncoder:
    """Deterministic linear projection of downsampled pixels — a stand-in
    encoder with the correct interface and shapes."""

    def __init__(self, pooled_dim: int = 512, grid_dim: int = 768,
                 grid_hw: int = 14, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.grid_hw = grid_hw
        self._w_pool = rng.normal(scale=0.02, size=(768, pooled_dim)).astype(np.float32)
        self._w_grid = rng.normal(scale=0.02, size=(48, grid_dim)).astype(np.float32)

    def _patch(self, imgs, hw):
        n, h, w, _ = imgs.shape
        ph, pw = h // hw, w // hw
        x = imgs[:, : ph * hw, : pw * hw].astype(np.float32) / 255.0
        x = x.reshape(n, hw, ph, hw, pw, 3).mean((2, 4))  # (n, hw, hw, 3)
        return x

    def encode_views(self, views36: np.ndarray) -> np.ndarray:
        x = self._patch(views36, 16).reshape(36, -1)  # (36, 768)
        return (x @ self._w_pool).astype(np.float32)

    def encode_grids(self, ring12: np.ndarray) -> np.ndarray:
        x = self._patch(ring12, self.grid_hw)  # (12, hw, hw, 3)
        n = x.shape[0]
        x = np.concatenate([x] * 16, axis=-1).reshape(n, self.grid_hw ** 2, 48)
        return (x @ self._w_grid).astype(np.float32)


class ClipEncoder:
    """Frozen CLIP ViT-B/16 vision tower via transformers (the reference's
    vendored OpenAI CLIP, precompute_features/clip/). Requires locally cached
    weights (zero-egress environments can't download)."""

    def __init__(self, model_name: str = "openai/clip-vit-base-patch16",
                 grid_hw: int = 14):
        import torch
        from transformers import CLIPVisionModel

        self.torch = torch
        self.model = CLIPVisionModel.from_pretrained(model_name, local_files_only=True).eval()
        self.grid_hw = grid_hw

    def _forward(self, imgs: np.ndarray):
        torch = self.torch
        x = torch.from_numpy(imgs.astype(np.float32) / 255.0).permute(0, 3, 1, 2)
        mean = torch.tensor([0.4815, 0.4578, 0.4082])[None, :, None, None]
        std = torch.tensor([0.2686, 0.2613, 0.2758])[None, :, None, None]
        with torch.no_grad():
            out = self.model((x - mean) / std)
        return out

    def encode_views(self, views36: np.ndarray) -> np.ndarray:
        return self._forward(views36).pooler_output.numpy()

    def encode_grids(self, ring12: np.ndarray) -> np.ndarray:
        hidden = self._forward(ring12).last_hidden_state.numpy()
        return hidden[:, 1:, :]  # drop CLS -> (12, grid_hw^2, 768)


class ImageNetViTEncoder:
    """Frozen ImageNet-supervised ViT-B/16 via transformers — the reference's
    timm variant (precompute_features/grid_mp3d_imagenet.py builds
    pth_vit_base_patch16_224_imagenet.hdf5 with timm's vit_base_patch16_224).
    Requires locally cached weights."""

    IMAGENET_MEAN = (0.5, 0.5, 0.5)   # timm vit_base_patch16_224 defaults
    IMAGENET_STD = (0.5, 0.5, 0.5)

    def __init__(self, model_name: str = "google/vit-base-patch16-224",
                 grid_hw: int = 14):
        import torch
        from transformers import ViTModel

        self.torch = torch
        self.model = ViTModel.from_pretrained(model_name, local_files_only=True).eval()
        self.grid_hw = grid_hw

    def _forward(self, imgs: np.ndarray):
        torch = self.torch
        x = torch.from_numpy(imgs.astype(np.float32) / 255.0).permute(0, 3, 1, 2)
        mean = torch.tensor(self.IMAGENET_MEAN)[None, :, None, None]
        std = torch.tensor(self.IMAGENET_STD)[None, :, None, None]
        with torch.no_grad():
            return self.model((x - mean) / std)

    def encode_views(self, views36: np.ndarray) -> np.ndarray:
        # timm's pooled feature is the pre-logits CLS token
        return self._forward(views36).last_hidden_state[:, 0].numpy()

    def encode_grids(self, ring12: np.ndarray) -> np.ndarray:
        return self._forward(ring12).last_hidden_state[:, 1:, :].numpy()


class DeviceClipEncoder:
    """The frozen CLIP tower (``models/clip.py``) on ``device``, with the
    JAX package's ``JaxClipEncoder`` API: uint8 frames in, numpy features
    out. Its widths are read off ``params``, a ``ClipVisionTower`` state
    dict (``ce.frozen.load_clip_params``, which also reads an HF model
    directory or name from the local cache). Each call is one forward of
    the tower in float32 over the batch of frames."""

    def __init__(self, params, grid_hw: int = 14, device="cuda"):
        import torch

        from ..models.clip import ClipVisionTower, tower_config

        self.torch = torch
        self.device = torch.device(device)
        self.tower = ClipVisionTower(**tower_config(params), device=self.device)
        self.tower.load_state_dict(params)
        self.tower.eval().requires_grad_(False)
        self.grid_hw = grid_hw
        self.feat_size = self.tower.hidden_size

    def forward(self, imgs: np.ndarray) -> dict:
        """(N, H, W, 3) uint8 frames -> the tower's outputs on the device."""
        from ..models.clip import preprocess

        x = self.torch.from_numpy(preprocess(imgs)).to(self.device)
        with self.torch.inference_mode():
            return self.tower(x)

    def encode_views(self, views36: np.ndarray) -> np.ndarray:
        return self.forward(views36)["pooled"].cpu().numpy()

    def encode_grids(self, ring12: np.ndarray) -> np.ndarray:
        return self.forward(ring12)["grid"].cpu().numpy()


def build_feature_files(source, encoder, out_dir: str,
                        progress_every: int = 50,
                        save_raw_images: bool = False,
                        pack: bool = True) -> Dict[str, str]:
    """Write the HDF5 products the training stack consumes; with
    ``save_raw_images``, also dump the raw 12-view rgb/depth frames (the
    reference's save_habitat_img.py / save_depth_img.py products, used to
    re-encode with a different tower without re-rendering).

    ``pack`` also emits the mmap sidecars (H5FeatureDB.build_pack) beside
    the four training products, so cold training starts serve features by
    mmap slice instead of per-key h5py reads (raw dumps are excluded: they
    are gzip re-encode intermediates, not on the training hot path)."""
    import h5py

    os.makedirs(out_dir, exist_ok=True)
    paths = {
        "img_ft": os.path.join(out_dir, "view_fts.hdf5"),
        "rgb": os.path.join(out_dir, "grid_fts.hdf5"),
        "depth": os.path.join(out_dir, "depth.hdf5"),
        "sem": os.path.join(out_dir, "sem.hdf5"),
    }
    if save_raw_images:
        paths["raw_rgb"] = os.path.join(out_dir, "raw_rgb.hdf5")
        paths["raw_depth"] = os.path.join(out_dir, "raw_depth.hdf5")
    files = {k: h5py.File(p, "w") for k, p in paths.items()}
    try:
        for n, (scan, vp, frames) in enumerate(source):
            key = f"{scan}_{vp}"
            files["img_ft"][key] = encoder.encode_views(frames["views36"])
            files["rgb"][key] = encoder.encode_grids(frames["ring12"]).astype(np.float16)
            files["depth"][key] = (frames["depth"] / 10.0).astype(np.float16)
            files["sem"][key] = frames["sem"]
            if save_raw_images:
                files["raw_rgb"].create_dataset(
                    key, data=frames["ring12"], compression="gzip",
                    compression_opts=1,
                )
                files["raw_depth"][key] = frames["depth"].astype(np.float16)
            if progress_every and (n + 1) % progress_every == 0:
                print(f"precompute: {n + 1} viewpoints done", flush=True)
    finally:
        for f in files.values():
            f.close()
    if pack:
        from ..data.feature_db import CONSUMER_DTYPE, H5FeatureDB

        # big-row stores (grids) are skipped by build_pack itself
        # (PACK_MAX_ROW_BYTES)
        for k in ("img_ft", "rgb", "depth", "sem"):
            db = H5FeatureDB(paths[k], dtype=CONSUMER_DTYPE[k])
            db.build_pack()
            db.close()
    return paths


def dump_raw_view_images(source, out_file: str, img_type: str = "rgb",
                         vfov: int = 60, progress_every: int = 50) -> str:
    """The reference's save_habitat_img.py product: one dataset per
    (scan, viewpoint) key holding the 36 discretized views —
    ``(36, H, W, 3)`` uint8 **BGR** for rgb (save_habitat_img.py:86 reverses
    the channel order before storing, :132) or ``(36, H, W, 1)`` float32
    normalised depth (:88, :134) — gzip-compressed with image geometry attrs.

    Sources provide ``views36`` (RGB) / ``views36_depth`` frames; a real
    renderer binding yields the same keys.
    """
    import h5py

    if img_type not in ("rgb", "depth"):
        raise ValueError(f"img_type must be rgb|depth, got {img_type}")
    os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
    frame_key = "views36" if img_type == "rgb" else "views36_depth"
    with h5py.File(out_file, "w") as outf:
        for n, (scan, vp, frames) in enumerate(source):
            imgs = frames[frame_key]
            if img_type == "rgb":
                data = imgs[..., ::-1]  # RGB -> BGR, as stored by the ref
                dset = outf.create_dataset(
                    f"{scan}_{vp}", data=data, dtype="uint8",
                    compression="gzip")
            else:
                dset = outf.create_dataset(
                    f"{scan}_{vp}", data=imgs.astype(np.float32),
                    dtype="float32", compression="gzip")
            dset.attrs["scanId"] = scan
            dset.attrs["viewpointId"] = vp
            dset.attrs["image_w"] = imgs.shape[2]
            dset.attrs["image_h"] = imgs.shape[1]
            dset.attrs["vfov"] = vfov
            if progress_every and (n + 1) % progress_every == 0:
                print(f"raw {img_type} dump: {n + 1} viewpoints", flush=True)
    return out_file


def dump_depth_features(img_db: str, out_file: str, params=None, vfov: int = 60,
                        progress_every: int = 50, device="cuda") -> str:
    """The reference's save_depth_feature.py product: read a raw depth image
    db (``dump_raw_view_images(img_type='depth')`` / save_habitat_img.py
    layout), push every viewpoint's 36 views through the frozen DDPPO depth
    tower, and store the spatially mean-pooled features —
    ``torch.mean(x, (2,3))`` over the (36, 128, 4, 4) encoder output →
    ``(36, 128)`` float32 (resnet_encoder.py:107, save_depth_feature.py:
    48-133) — with scanId/viewpointId/image_w/image_h/vfov attrs.

    The 36 views ride the batch dimension of one forward on ``device``;
    ``params`` is a ``DdppoDepthEncoder`` state dict, e.g. from
    ``ce.frozen.load_depth_params`` (random from seed 0 when omitted, for
    pipeline tests). The tower is sized by the first viewpoint's frames.
    """
    import h5py

    from ..ce.frozen import DeviceDepthEncoder
    from ..models.depth_encoder import DdppoDepthEncoder

    enc = None
    os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
    with h5py.File(img_db, "r") as inf, h5py.File(out_file, "w") as outf:
        keys = sorted(inf.keys())
        for n, key in enumerate(keys):
            depth = inf[key][...].astype(np.float32)
            if depth.ndim == 3:
                depth = depth[..., None]
            if enc is None:
                if params is None:
                    import torch

                    with torch.random.fork_rng(devices=[]):
                        torch.manual_seed(0)
                        params = DdppoDepthEncoder(input_size=depth.shape[1]).state_dict()
                enc = DeviceDepthEncoder(params, input_size=depth.shape[1], device=device)
            fts = enc(depth)                                 # pooled, ref :107
            dset = outf.create_dataset(key, data=fts, dtype="float32",
                                       compression="gzip")
            src = inf[key]
            dset.attrs["scanId"] = src.attrs.get("scanId", key.split("_")[0])
            dset.attrs["viewpointId"] = src.attrs.get(
                "viewpointId", key.split("_", 1)[-1])
            dset.attrs["image_w"] = depth.shape[2]
            dset.attrs["image_h"] = depth.shape[1]
            dset.attrs["vfov"] = vfov
            if progress_every and (n + 1) % progress_every == 0:
                print(f"depth features: {n + 1}/{len(keys)}", flush=True)
    return out_file
