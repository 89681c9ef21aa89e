"""The reference's DAgger pieces: the rollout's egocentric BEV, the rollout's
fused navigation logits, and a replay update's episode loss, in plain
float32 tensor operations on the model of ``model.py``.

They follow the program from the episodes it recorded: the host variables
of each step (panorama slots, the global map's aggregation matrix, node
tables, candidate cells, the fusion map, the teacher's targets) and the
point clouds each step gathers (``step_sel``) are the program's rollout
bookkeeping, taken as they were recorded. The BEV features are worked out
again from the raw observations (depth, grid features, pose), and
everything on the device is computed again from them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from .bev import Projector
from .geometry import se3_from_xyzhe
from .model import NavModel, cross_entropy, fp8_round

IGNORE_ID = -100
#: the bundle's keys without a batch axis after the step axis
_STEPLESS = ("txt_ids", "txt_masks", "step_idx")


def rows_of(rb: Dict[str, np.ndarray], rows) -> Dict[str, np.ndarray]:
    """The bundle restricted to ``rows`` of its batch."""
    out = {}
    for k, v in rb.items():
        if k == "step_idx":
            out[k] = v
        elif k in _STEPLESS:
            out[k] = v[rows]
        else:
            out[k] = v[:, rows]
    return out


def camera_poses(obs: Sequence[dict], num_views: int) -> np.ndarray:
    """(B, V, 4, 4) camera-to-world of each row's agent-relative camera ring
    (a copy of the agent's ``lift`` pose arithmetic)."""
    xyzhe = np.zeros((len(obs), num_views, 5), np.float32)
    for i, ob in enumerate(obs):
        x, y, z = ob["position"]
        xyzhe[i, :, 0], xyzhe[i, :, 1], xyzhe[i, :, 2] = x, z, -y
        xyzhe[i, :, 3] = -(np.arange(num_views) * (2 * math.pi / num_views) + ob["heading"])
        xyzhe[i, :, 4] = math.pi
    return se3_from_xyzhe(xyzhe.reshape(-1, 5)).reshape(len(obs), num_views, 4, 4)


def ego_pose(ob: dict) -> tuple:
    """(T_w2c (4, 4), S_w2c (3,)) of the map centred on the agent."""
    x, y, z = ob["position"]
    T = se3_from_xyzhe(np.array([[0, 0, 0, ob["heading"], 0]], np.float32))[0]
    return T, np.array([x, z, -y], np.float32)


def rollout_bev(projector: Projector, steps_obs: List[List[dict]], step_sel: np.ndarray,
                step_ok: np.ndarray, t: int, device, fp8: bool = False) -> torch.Tensor:
    """(B, cells, F) BEV of rollout step ``t``: row i splats the point
    clouds of its steps ``step_sel[i][step_ok[i]]`` (each lifted from that
    step's observation) into the frame of its observation at ``t``. With
    ``fp8`` the features are rounded through float8 first (the control)."""
    rows = []
    for i, ob in enumerate(steps_obs[t]):
        sel = [int(s) for s, ok in zip(step_sel[i], step_ok[i]) if ok]
        past = [steps_obs[s][i] for s in sel]
        depth = torch.from_numpy(np.stack([p["depth"] for p in past]).astype(np.float32) * 10.0)
        T_c2w = torch.from_numpy(camera_poses(past, depth.shape[1]))
        pts, no_depth = projector.lift(depth.to(device), T_c2w.to(device))
        T, S = ego_pose(ob)
        pts = pts.reshape(1, -1, 3)
        cell, valid = projector.cells(pts, torch.from_numpy(T)[None].to(device),
                                      torch.from_numpy(S)[None].to(device))
        feats = torch.from_numpy(np.stack([np.asarray(p["rgb"], np.float32) for p in past]))
        feats = feats.reshape(1, -1, feats.shape[-1]).to(device)
        if fp8:
            feats = fp8_round(feats)
        bev, _, _ = projector.splat(cell, valid & ~no_depth.reshape(1, -1), feats)
        rows.append(bev[0])
    return torch.stack(rows)


def _dev(rb: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
                ).to(device) for k, v in rb.items()}


def nav_inputs(dev: Dict[str, torch.Tensor], t: int, txt, tokens, bev) -> Dict[str, torch.Tensor]:
    out = {"txt_embeds": txt, "txt_masks": dev["txt_masks"],
           "gmap_img_embeds": torch.matmul(dev["gmap_agg"][t].float(), tokens),
           "bev_fts": bev, "bev_masks": torch.ones(bev.shape[:2], dtype=torch.bool,
                                                   device=bev.device)}
    for k in ("gmap_step_ids", "gmap_pos_fts", "gmap_masks", "gmap_pair_dists",
              "gmap_visited_masks", "bev_pos_fts", "bev_nav_masks", "bev_cand_idxs",
              "local_masks", "fuse_map"):
        out[k] = dev[k][t]
    return out


def encode(model: NavModel, dev: Dict[str, torch.Tensor]):
    """(text tokens, the panorama tokens of every step as (B, T*P, D) float32)."""
    T, B = dev["view_fts"].shape[:2]
    txt = model.bert.encode_text(dev["txt_ids"], dev["txt_masks"])
    flat = lambda k: dev[k].reshape(T * B, *dev[k].shape[2:])  # noqa: E731
    pano, masks = model.bert.encode_pano_rows(flat("view_fts"), flat("loc_fts"),
                                              flat("nav_types"), flat("view_lens"))
    P, D = pano.shape[1:]
    steps = (pano * masks[..., None]).reshape(T, B, P, D)
    return txt, steps.transpose(0, 1).reshape(B, T * P, D).float()


def skipped(targets: np.ndarray) -> np.ndarray:
    """(T,) the steps whose every row's target is ignored (the bundle's padding)."""
    return (np.asarray(targets) == IGNORE_ID).all(axis=1)


def rollout_logits(model: NavModel, rb: Dict[str, np.ndarray], bevs: torch.Tensor,
                   n_steps: int, device) -> List[torch.Tensor]:
    """Each recorded step's fused logits (B, N) in eval mode: the rollout's
    forward, the node embeddings contracted from the steps seen so far."""
    dev = _dev(rb, device)
    with torch.no_grad():
        txt, tokens = encode(model, dev)
        P = dev["view_fts"].shape[2]
        out = []
        for t in range(n_steps):
            seen = tokens.clone()
            seen[:, (t + 1) * P:] = 0.0
            out.append(model.navigation(nav_inputs(dev, t, txt, seen, bevs[t])))
    return out


def episode_loss(model: NavModel, rb: Dict[str, np.ndarray], bevs: torch.Tensor,
                 ml_weight: float, device) -> torch.Tensor:
    """The replay's imitation loss (training mode): per step not skipped, the
    summed cross-entropy of the fused logits, scaled by ``ml_weight / B``."""
    dev = _dev(rb, device)
    txt, tokens = encode(model, dev)
    B = dev["view_fts"].shape[1]
    total = torch.zeros((), device=device)
    for t, skip in enumerate(skipped(rb["targets"])):
        if skip:
            continue
        logits = model.navigation(nav_inputs(dev, t, txt, tokens, bevs[t]))
        total = total + cross_entropy(logits, dev["targets"][t].long())[0].sum()
    return total * ml_weight / B
