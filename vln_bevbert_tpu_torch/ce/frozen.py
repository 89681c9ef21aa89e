"""Frozen-weight loading for CE (port of the waypoint part of
``vln_bevbert_tpu/ce/frozen.py``).

The reference's CE trainer loads the transformer waypoint predictor
checkpoint at init (``torch.load(...)['predictor']['state_dict']``,
bevbert_ce/vlnce_baselines/ss_trainer_BEV.py:236-243). This module turns a
checkpoint *file* into a state dict of the port's ``WaypointPredictor``, so
``cli/ce_train.py --waypoint_ckpt`` wires the published weights. It reads
torch files (``.pt``/``.pth`` or none) and ``.npz`` flat trees; an orbax
directory, which only the JAX package writes, is refused. The DDPPO and
CLIP loaders belong to the Habitat sensor stack and are not ported yet.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from ..convert import flax_to_state_dict


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
    if any(k.rsplit("/", 1)[-1].rsplit(".", 1)[-1] in ("kernel", "scale") for k in ks):
        obj = flax_to_state_dict(_unflatten(obj))
    if not any(k.startswith("depth_fc.") for k in obj):
        raise ValueError(f"unrecognised waypoint checkpoint layout: keys {ks[:8]}")
    return {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in obj.items()}
