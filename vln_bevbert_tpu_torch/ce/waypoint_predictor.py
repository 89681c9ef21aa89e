"""Waypoint predictor for continuous environments (port of
``vln_bevbert_tpu/ce/waypoint_predictor.py``).

The reference's frozen BinaryDistPredictor_TRM
(bevbert_ce/vlnce_baselines/waypoint_pred/TRM_net.py:9-90): 12 per-view
depth encodings (128x4x4 DDPPO features) -> hidden-size tokens -> 2
post-norm BERT layers whose attention is restricted to each view's +-1 ring
neighbours by an additive -10000 bias -> per-view logits reshaped to a
120-angle x 12-distance heatmap, rolled by ``HEATMAP_OFFSET`` so that angle 0
is the agent's heading. The reference's ``mergefeats_LayerNorm`` is built
but never applied in its forward, so there is none here either.

The module's names mirror the JAX tree (``depth_fc``, ``trm_layer_{0,1}``,
``cls_fc1``, ``cls_fc2``), so ``convert.load_flax_params`` carries JAX
parameters across; ``load_waypoint_ckpt`` maps the published torch
checkpoint onto the same names. The NMS peak extraction and the train-time
waypoint sampling are host numpy, copied from the JAX module: they draw from
the caller's ``np.random.Generator`` in the same order.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import ModelConfig
from ..models.bert import BertLayer, Dense

NUM_ANGLES = 120
NUM_IMGS = 12
NUM_CLASSES = 12   # distance bins
HEATMAP_OFFSET = 5
TRM_NEIGHBOR = 1


def ring_neighbor_bias(num_imgs: int = NUM_IMGS,
                       neighbor: int = TRM_NEIGHBOR) -> np.ndarray:
    """(1, 1, V, V) additive bias: 0 within +-neighbor on the circular ring,
    -10000 elsewhere (ref utils.get_attention_mask, applied as
    (1-mask)*-10000 in waypoint_bert.py BertImgModel.forward)."""
    ok = np.zeros((num_imgs, num_imgs), bool)
    for i in range(num_imgs):
        for d in range(-neighbor, neighbor + 1):
            ok[i, (i + d) % num_imgs] = True
    return np.where(ok, 0.0, -10000.0)[None, None].astype(np.float32)


class WaypointPredictor(nn.Module):
    """depth_fts (B*V, 128, 4, 4) -> heatmap logits (B, NUM_ANGLES,
    NUM_CLASSES) float32. Layers compute in ``cfg.dtype``, as the JAX
    module's do."""

    def __init__(self, cfg: ModelConfig, depth_feat_size: int = 128 * 4 * 4, device=None):
        super().__init__()
        hid = cfg.hidden_size
        self.depth_fc = Dense(cfg, depth_feat_size, hid, device)
        self.trm_layer_0 = BertLayer(cfg, device)
        self.trm_layer_1 = BertLayer(cfg, device)
        self.cls_fc1 = Dense(cfg, hid, hid, device)
        self.cls_fc2 = Dense(cfg, hid, NUM_CLASSES * (NUM_ANGLES // NUM_IMGS), device)
        self.register_buffer("ring_bias", torch.as_tensor(ring_neighbor_bias(), device=device),
                             persistent=False)

    def forward(self, depth_fts: torch.Tensor) -> torch.Tensor:
        bv = depth_fts.shape[0]
        b = bv // NUM_IMGS
        x = F.relu(self.depth_fc(depth_fts.reshape(bv, -1)))
        x = x.reshape(b, NUM_IMGS, -1)
        x = self.trm_layer_1(self.trm_layer_0(x, self.ring_bias), self.ring_bias)
        y = self.cls_fc2(F.relu(self.cls_fc1(x)))
        y = y.reshape(b, NUM_ANGLES, NUM_CLASSES).float()
        # each camera points at the centre of its angular sector
        return torch.roll(y, -HEATMAP_OFFSET, dims=1)


def load_waypoint_ckpt(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's BinaryDistPredictor_TRM state dict -> a state dict of
    ``WaypointPredictor``.

    Checkpoint layout (TRM_net.py:27-60): visual_fc_depth.1 (the Linear after
    Flatten), waypoint_TRM.bert.encoder.layer.{0,1} (pytorch_transformers
    post-norm BERT layers), vis_classifier.{0,2}. Torch's Linear already
    holds (out, in) weights, as ``Dense`` does; query, key and value stack
    into the fused ``qkv``. The unused rgb-branch parameters (visual_fc_rgb,
    visual_merge, mergefeats_LayerNorm) are dropped.
    """
    sd = {}
    for k, v in state_dict.items():
        if k.startswith("module."):
            k = k[len("module."):]
        sd[k] = torch.as_tensor(np.asarray(v, np.float32))

    out: Dict[str, torch.Tensor] = {}

    def copy(dst, src):
        out[f"{dst}.weight"] = sd[f"{src}.weight"]
        out[f"{dst}.bias"] = sd[f"{src}.bias"]

    copy("depth_fc", "visual_fc_depth.1")
    copy("cls_fc1", "vis_classifier.0")
    copy("cls_fc2", "vis_classifier.2")
    for i in range(2):
        p, q = f"waypoint_TRM.bert.encoder.layer.{i}", f"trm_layer_{i}"
        qkv = [f"{p}.attention.self.{n}" for n in ("query", "key", "value")]
        out[f"{q}.attn.att.qkv.weight"] = torch.cat([sd[f"{n}.weight"] for n in qkv], 0)
        out[f"{q}.attn.att.qkv.bias"] = torch.cat([sd[f"{n}.bias"] for n in qkv], 0)
        copy(f"{q}.attn.out_dense", f"{p}.attention.output.dense")
        copy(f"{q}.attn.out_ln", f"{p}.attention.output.LayerNorm")
        copy(f"{q}.ffn.inter", f"{p}.intermediate.dense")
        copy(f"{q}.ffn.out_dense", f"{p}.output.dense")
        copy(f"{q}.ffn.out_ln", f"{p}.output.LayerNorm")
    return out


def _suppression_mask(ai: np.ndarray, di: np.ndarray, n_ang: int, n_dist: int,
                      sigma: Tuple[float, float]) -> np.ndarray:
    """(B, n_ang, n_dist) rectangle masks around each (ai, di) peak —
    the ref's ``neighborhoods`` with circular_x on the distance axis
    (utils.py:7-33; their x = ix % width = distance bin). The circularity is
    asymmetric there: min(|dx|, |dx + range|), mirrored verbatim. The angle
    center is FRACTIONAL: the ref computes y = ix / shape[-1] with torch
    true division (utils.py:54), i.e. ai + di/n_dist, so for distance bin
    d > 0 the suppressed angle rows are [ai - sigma + d/n_dist ... ai +
    sigma + d/n_dist] rounded inward — mirrored exactly."""
    dx = np.arange(n_dist)[None, None, :] - di[:, None, None].astype(np.float64)
    dx = np.minimum(np.abs(dx), np.abs(dx + n_dist))
    y_mu = ai[:, None, None] + di[:, None, None] / float(n_dist)
    dy = np.abs(np.arange(n_ang)[None, :, None] - y_mu)
    return ((dx <= sigma[0]) & (dy <= sigma[1])).astype(np.float64)


def nms_peaks(pred: np.ndarray, max_predictions: int = 5,
              sigma: Tuple[float, float] = (7.0, 5.0)) -> np.ndarray:
    """Iterative NMS over (B, A, D) maps, the ref's utils.nms (utils.py:36-64):
    keep the global max, multiply the working map by (1 - rectangle), repeat;
    sigma = (distance halfwidth, angle halfwidth). Returns the map with only
    peak values kept."""
    b, A, D = pred.shape
    out = np.zeros_like(pred)
    supp = pred.astype(np.float64).copy()
    rows = np.arange(b)
    for _ in range(max_predictions):
        flat = supp.reshape(b, -1)
        ix = flat.argmax(axis=1)
        ai, di = ix // D, ix % D
        out[rows, ai, di] = pred[rows, ai, di]
        supp *= 1.0 - _suppression_mask(ai, di, A, D, sigma)
    out[out < 0] = 0
    return out


def heatmap_to_peaks(heatmap_logits: np.ndarray,
                     max_predictions: int = 5) -> np.ndarray:
    """Softmax over the whole map, wrap-pad the angle axis by one row each
    side, NMS, un-pad (ref Policy_ViewSelection_BEV.py:213-231). Returns the
    (B, A, D) peak map."""
    b, A, D = heatmap_logits.shape
    flat = heatmap_logits.reshape(b, -1)
    prob = np.exp(flat - flat.max(axis=1, keepdims=True))
    prob /= prob.sum(axis=1, keepdims=True)
    prob = prob.reshape(b, A, D)
    wrapped = np.concatenate([prob[:, -1:], prob, prob[:, :1]], axis=1)
    return nms_peaks(wrapped, max_predictions=max_predictions)[:, 1:-1, :]


def sample_waypoints(heatmap_logits: np.ndarray, peak_map: np.ndarray,
                     rng: np.random.Generator):
    """Train-time waypoint augmentation (ref Policy_ViewSelection_BEV.py:
    233-263): for each NMS peak, sample an (angle, distance) cell from the
    softmax over its camera's 10x12 heatmap region instead of the peak
    itself. Returns per-sample (angle_idxes, distance_idxes) lists."""
    b = heatmap_logits.shape[0]
    # undo the HEATMAP_OFFSET roll so regions align with cameras
    regional = np.roll(heatmap_logits, HEATMAP_OFFSET, axis=1)
    regional = regional.reshape(b, NUM_IMGS, (NUM_ANGLES // NUM_IMGS) * NUM_CLASSES)
    angle_idxes, distance_idxes = [], []
    for j in range(b):
        ai = np.nonzero(peak_map[j])[0]
        img_idxes = (ai + 5) // 10
        img_idxes[img_idxes == NUM_IMGS] = 0
        sa, sd = [], []
        for img in img_idxes:
            logits = regional[j, img]
            p = np.exp(logits - logits.max())
            p /= p.sum()
            act = int(rng.choice(len(p), p=p))
            pointer = (img - 1) * 10 + 5 if img != 0 else 0
            sa.append(act // NUM_CLASSES + pointer)
            sd.append(act % NUM_CLASSES)
        angle_idxes.append(np.asarray(sa, np.int64))
        distance_idxes.append(np.asarray(sd, np.int64))
    return angle_idxes, distance_idxes


def extract_waypoints(heatmap_logits: np.ndarray, max_predictions: int = 5,
                      max_candidates: int = 5, in_train: bool = False,
                      rng: np.random.Generator = None):
    """Heatmap -> per-sample candidate (angles, distances, scores).

    Angles are clockwise offsets from the agent heading (bin a -> a*3deg);
    distance bin d -> (d+1)*0.25 metres. Candidates come back in angle order
    (the ref iterates output_map.nonzero()); train mode replaces each peak
    with a regional sample (waypoint augmentation).
    """
    b = heatmap_logits.shape[0]
    peaks = heatmap_to_peaks(heatmap_logits, max_predictions=max_predictions)
    if in_train:
        assert rng is not None
        ang_lists, dist_lists = sample_waypoints(heatmap_logits, peaks, rng)
    else:
        ang_lists = [np.nonzero(peaks[k])[0] for k in range(b)]
        dist_lists = [np.nonzero(peaks[k])[1] for k in range(b)]
    angles, dists, scores = [], [], []
    for k in range(b):
        ai, di = ang_lists[k][:max_candidates], dist_lists[k][:max_candidates]
        angles.append(ai * (2.0 * math.pi / NUM_ANGLES))
        dists.append((di + 1) * 0.25)
        scores.append(peaks[k][ai % NUM_ANGLES, di])
    return angles, dists, scores
