"""Frozen-weight loading for CE (port of ``vln_bevbert_tpu/ce/frozen.py``).

The reference's CE trainer loads three frozen towers at init: the
transformer waypoint predictor (``torch.load(...)['predictor']
['state_dict']``, bevbert_ce/vlnce_baselines/ss_trainer_BEV.py:236-243),
the DDPPO point-nav depth ResNet-50 (resnet_encoders.py:39-50) and CLIP
ViT-B/16 (Policy_ViewSelection_BEV.py:36-341). This module turns checkpoint
*files* into state dicts of the port's ``WaypointPredictor``,
``DdppoDepthEncoder`` and ``ClipVisionTower``, so ``cli/ce_train.py``'s
``--waypoint_ckpt``, ``--ddppo_ckpt`` and ``--clip_ckpt`` wire the
published weights. It reads torch files (``.pt``/``.pth`` or none) in the
reference's layouts or the port's own, ``.npz`` flat flax trees, and (CLIP)
a HuggingFace model directory from transformers' local cache; an orbax
directory, which only the JAX package writes, is refused.
``DeviceDepthEncoder`` runs the DDPPO tower for the habitat binding.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from ..convert import flax_to_state_dict
from ..models.clip import hf_clip_to_state_dict
from ..models.depth_encoder import DdppoDepthEncoder, encoder_config, load_ddppo_ckpt


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """'a/b/c' or 'a.b.c' -> nested dicts, for ``.npz`` flat flax trees."""
    tree: Dict[str, Any] = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/") if "/" in k else k.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(v)
    return tree


def load_ckpt_file(path: str) -> Dict[str, Any]:
    """Read a checkpoint file into a flat-or-nested dict of numpy arrays:
    ``.npz`` -> its arrays (keys may be '/'- or '.'-separated); anything
    else -> ``torch.load(map_location='cpu')``, tensors as numpy (the
    reference's format for its frozen checkpoints)."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory: the port reads torch or .npz checkpoint "
                         "files, not orbax directories")
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    obj = torch.load(path, map_location="cpu", weights_only=False)

    def to_np(x):
        if isinstance(x, dict):
            return {k: to_np(v) for k, v in x.items()}
        if isinstance(x, torch.Tensor):
            return x.detach().float().numpy()
        return x

    return to_np(obj)


def load_waypoint_params(path: str) -> Dict[str, torch.Tensor]:
    """Waypoint-predictor checkpoint file -> ``WaypointPredictor`` state dict.

    Accepts the reference's published format (``['predictor']['state_dict']``,
    ss_trainer_BEV.py:239), a bare torch state dict in that layout, a flax
    tree saved flat as ``.npz`` (the JAX predictor's names), or the port's
    own state dict.
    """
    obj = load_ckpt_file(path)
    if isinstance(obj, dict) and "predictor" in obj:
        obj = obj["predictor"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    ks = list(obj)
    if any("visual_fc_depth" in k or "waypoint_TRM" in k for k in ks):
        from .waypoint_predictor import load_waypoint_ckpt

        return load_waypoint_ckpt(obj)
    return _own_layout(obj, "depth_fc.weight", "waypoint")


def _own_layout(obj: Dict[str, Any], probe: str, what: str) -> Dict[str, torch.Tensor]:
    """A flat flax tree (``.npz``) or the port's own state dict -> the
    port's state dict; ``probe`` is a key it must hold."""
    ks = list(obj)
    if any(k.rsplit("/", 1)[-1].rsplit(".", 1)[-1] in ("kernel", "scale") for k in ks):
        obj = flax_to_state_dict(_unflatten(obj))
    if probe not in obj:
        raise ValueError(f"unrecognised {what} checkpoint layout: keys {ks[:8]}")
    return {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in obj.items()}


def load_depth_params(path: str) -> Dict[str, torch.Tensor]:
    """DDPPO point-nav checkpoint file -> ``DdppoDepthEncoder`` state dict:
    the reference's torch checkpoint (``actor_critic.net.visual_encoder.*``
    under ``state_dict``, or stripped ``backbone.*``/``compression.*``), a
    flax tree saved flat as ``.npz``, or the port's own state dict."""
    obj = load_ckpt_file(path)
    if any("visual_encoder" in k or k.startswith("backbone.")
           for k in obj.get("state_dict", obj)):
        return load_ddppo_ckpt(obj)
    return _own_layout(obj, "conv1.weight", "DDPPO")


def load_clip_params(path: str) -> Dict[str, torch.Tensor]:
    """CLIP vision checkpoint -> ``ClipVisionTower`` state dict.

    ``path`` may be a torch state-dict file in HF ``CLIPVisionModel``
    layout, a flax tree saved flat as ``.npz``, the port's own state dict,
    or a HuggingFace model directory or name, read from transformers' local
    cache only (``local_files_only``: no download)."""
    if os.path.isfile(path) or (
        os.path.isdir(path) and not os.path.exists(os.path.join(path, "config.json"))
    ):
        obj = load_ckpt_file(path)
        if any("vision_model" in k or "embeddings.patch_embedding" in k for k in obj):
            return hf_clip_to_state_dict(obj)
        return _own_layout(obj, "patch_embedding.weight", "CLIP")
    from transformers import CLIPVisionModel

    hf = CLIPVisionModel.from_pretrained(path, local_files_only=True)
    return hf_clip_to_state_dict({k: v.detach().numpy() for k, v in hf.state_dict().items()})


class DeviceDepthEncoder:
    """The frozen DDPPO depth tower on ``device``, for the habitat binding
    (counterpart of JAX's ``JaxDepthEncoder``). Its widths are read off
    ``params`` for ``input_size`` square frames (256: the VLN-CE depth
    sensor). Calling it maps raw depth frames ``(V, H, W[, 1])`` to the
    spatially mean-pooled features ``(V, C)``, as JAX's does (the
    reference pools the encoder output for its precomputed features,
    resnet_encoders.py:107); ``spatial`` gives the unpooled map
    ``(V, C, h, w)`` (``feat_shape``), which the waypoint predictor takes."""

    def __init__(self, params, input_size: int = 256, device="cuda"):
        self.device = torch.device(device)
        self.model = DdppoDepthEncoder(**encoder_config(params, input_size), device=self.device)
        self.model.load_state_dict(params)
        self.model.eval().requires_grad_(False)
        self.feat_shape = self.model.feat_shape

    def encode(self, depth: np.ndarray) -> torch.Tensor:
        """(V, H, W[, 1]) depth -> the (V, C, h, w) map, on the device."""
        with torch.inference_mode():
            return self.model(torch.as_tensor(np.asarray(depth, np.float32)).to(self.device))

    def spatial(self, depth: np.ndarray) -> np.ndarray:
        return self.encode(depth).cpu().numpy()

    def __call__(self, depth: np.ndarray) -> np.ndarray:
        return self.encode(depth).mean((2, 3)).cpu().numpy()
