"""The reference's stages of a greedy rollout, each fed the program's own
inputs to that stage, so that rounding does not compound through the
rollout's three chained forwards:

- text tokens: the language encoder on the rollout's token ids;
- panorama tokens: the panorama encoder on each step's panorama variable;
- node embeddings: each step's aggregation matrix (``gmap_agg``) times the
  program's panorama tokens of the steps so far (the host contraction);
- BEV: each step's egocentric map worked out again from the raw
  observations (``nav.rollout_bev``);
- fused logits and the fusion gate: the navigation forward fed the
  program's text tokens, node embeddings, BEV and host variables;
- the distance probe: the navigation forward on the last checked step's
  inputs with the graph distances stretched (``stretch``) so that the
  largest distance bias of the attention is ``PROBE_BIAS``. At random
  N(0, 0.02) weights that bias is ~0.003 on the real distances, far below
  the bf16 rounding of the forward: only a bias that outweighs the content
  of the attention shows a program that drops it (on the card, a largest
  bias of 1, 3, 10 and 30 put the dropped bias at 0.6-1.8x, 1.7-4.5x,
  6-12x and 14-19x of the program's own gap).

``Stages`` holds one side's outputs of every step of the checked rollouts;
``gaps`` reads each stage's gap to the reference, normalised by the
reference stage's scale over its valid entries in the step (the RMS, or for
logits their standard deviation), never per row, and keeps the worst step.
The chained logits (every stage fed the reference's own outputs) give the
end-to-end ``logit_gap`` and ``prob_gap``, which are logged only.

Faults for the control script (``FAULTS``), each computed in the program's
place: the stop logit raised by 0.5, the BEV scaled by 1.25, the navigation
forward without the graph-distance attention bias (``gmap_pair_dists``
zeroed) and with the fusion gate fixed at 0.5.

Plain float32 tensor operations of ``model.py``; the caller switches TF32
off.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .bev import Projector
from .model import NavModel, fp8_round, sap_logits
from .nav import rollout_bev

FAULTS = ("stop_raised", "bev_scaled", "no_distance_bias", "gate_fixed")
#: the distance probe's largest attention bias
PROBE_BIAS = 30.0
#: fused logits at or below this are masked (the model's -10000 fill)
MASKED = -1000.0
#: the navigation forward's host inputs, as the rollout hands them over
NAV_KEYS = ("txt_masks", "gmap_step_ids", "gmap_pos_fts", "gmap_masks", "gmap_pair_dists",
            "gmap_visited_masks", "bev_pos_fts", "bev_masks", "bev_nav_masks",
            "bev_cand_idxs", "local_masks", "fuse_map")


@dataclass
class Stages:
    """One side's stage outputs over the checked rollouts, float32 on the
    host: per rollout the text tokens (B, L, D), and per step the panorama
    tokens (B, P, D), node embeddings (B, N, D), BEV (B, C, F), fused logits
    (B, N) and fusion gate (B, 1)."""

    text: List[torch.Tensor] = field(default_factory=list)
    pano: List[List[torch.Tensor]] = field(default_factory=list)
    nodes: List[List[torch.Tensor]] = field(default_factory=list)
    bev: List[List[torch.Tensor]] = field(default_factory=list)
    logits: List[List[torch.Tensor]] = field(default_factory=list)
    gate: List[List[torch.Tensor]] = field(default_factory=list)
    probe: Optional[torch.Tensor] = None


def stretch(pair_dists: np.ndarray, sprel_weight: float) -> np.ndarray:
    """The distances scaled so that the largest distance bias
    (``sprel_weight * distance``) is ``PROBE_BIAS``."""
    top = float(np.abs(pair_dists).max()) * abs(sprel_weight)
    return pair_dists * (PROBE_BIAS / max(top, 1e-12))


def program_stages(rollouts: List[dict]) -> Stages:
    """The program's outputs as the benchmark's tap kept them."""
    out = Stages()
    for ro in rollouts:
        out.text.append(ro["text"])
        out.pano.append([p["out"] for p in ro["pano"]])
        out.nodes.append([n["embeds"] for n in ro["nav"]])
        out.bev.append([n["bev_fts"] for n in ro["nav"]])
        out.logits.append([n["logits"] for n in ro["nav"]])
        out.gate.append([n["gate"] for n in ro["nav"]])
        if "probe" in ro:
            out.probe = ro["probe"]["logits"]
    return out


def on_device(x, device, dtype=None) -> torch.Tensor:
    """A host array or tensor as a tensor on ``device`` (in ``dtype``)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device=device, dtype=dtype or t.dtype)


def tokens_so_far(pano: List[torch.Tensor], t: int, steps: int) -> torch.Tensor:
    """(B, steps * P, D) float32: the panorama tokens of steps 0..t in their
    slots, zeros after (the rollout's host store)."""
    B, P, D = pano[0].shape
    out = torch.zeros(B, steps * P, D, dtype=torch.float32, device=pano[0].device)
    for s in range(t + 1):
        out[:, s * P:(s + 1) * P] = pano[s]
    return out


def navigation(model: NavModel, batch: Dict[str, torch.Tensor], fault: Optional[str] = None):
    """(fused logits (B, N), fusion gate (B, 1)) of one step; ``fault``
    ``no_distance_bias`` zeroes the graph distances, ``gate_fixed`` fixes
    the gate at 0.5."""
    if fault == "no_distance_bias":
        batch = {**batch, "gmap_pair_dists": torch.zeros_like(batch["gmap_pair_dists"])}
    gmap = model.bert.global_encoder(
        batch["txt_embeds"], batch["txt_masks"], batch["gmap_img_embeds"],
        batch["gmap_step_ids"], batch["gmap_pos_fts"], batch["gmap_masks"],
        batch["gmap_pair_dists"])
    bev = model.bert.encode_bev(batch["txt_embeds"], batch)
    fuse = model.sap_fuse_linear
    if fault == "gate_fixed":
        fuse = lambda x: torch.zeros_like(x[..., :1])  # noqa: E731  sigmoid(0) = 0.5
    gate = torch.sigmoid(fuse(torch.cat([gmap[:, 0], bev[:, model.cfg.bev_center]], -1)))
    fused = sap_logits(model.global_sap_head, model.local_sap_head, fuse,
                       model.cfg.bev_center, gmap, bev, batch)[2]
    return fused, gate.float()


@torch.no_grad()
def reference_stages(model: NavModel, projector: Projector, rollouts: List[dict], steps: int,
                     device, fault: Optional[str] = None, fp8: bool = False,
                     chained: bool = False) -> Stages:
    """The reference's stage outputs, each on the program's inputs to that
    stage (``model`` in eval mode, at its own ``Numerics``). ``fp8``: the
    control's rounding of the host-side stages too (the node contraction's
    tokens and the BEV's features). ``chained``: instead, every stage fed
    the reference's own outputs, from the token ids and the observations
    (the end-to-end chain)."""
    out = Stages()
    for ro in rollouts:
        lang = ro["lang"]
        ids, masks = on_device(lang["txt_ids"], device), on_device(lang["txt_masks"], device)
        text = model.bert.encode_text(ids, masks).float()
        out.text.append(text.cpu())
        pano, nodes, bevs, logits, gates = [], [], [], [], []
        for t, p in enumerate(ro["pano"]):
            x = {k: on_device(v, device) for k, v in p["in"].items()}
            tok, slot_ok = model.bert.encode_pano_rows(x["view_fts"], x["loc_fts"],
                                                       x["nav_types"], x["view_lens"])
            pano.append((tok.float() * slot_ok[..., None]).cpu())
        for t, n in enumerate(ro["nav"]):
            source = pano if chained else [q["out"] for q in ro["pano"]]
            toks = tokens_so_far([q.to(device) for q in source], t, steps)
            if fp8:
                toks = fp8_round(toks)
            node = torch.matmul(on_device(n["gmap_agg"], device), toks)
            nodes.append(node.cpu())
            sel, ok = ro["gathers"][t]
            bev = rollout_bev(projector, ro["obs"], sel, ok, t, device, fp8=fp8)
            bevs.append(bev.cpu())
            batch = {k: on_device(n["in"][k], device) for k in NAV_KEYS}
            batch["txt_embeds"] = text if chained else on_device(ro["text"], device, torch.float32)
            batch["gmap_img_embeds"] = node if chained else on_device(n["embeds"], device)
            batch["bev_fts"] = bev if chained else on_device(n["bev_fts"], device)
            fused, gate = navigation(model, batch, fault)
            logits.append(fused.cpu())
            gates.append(gate.cpu())
        out.pano.append(pano)
        out.nodes.append(nodes)
        out.bev.append(bevs)
        out.logits.append(logits)
        out.gate.append(gates)
        if "probe" in ro:
            batch = {k: on_device(v, device, torch.float32 if k == "txt_embeds" else None)
                     for k, v in ro["probe"]["in"].items()}
            out.probe = navigation(model, batch, fault)[0].cpu()
    return out


def rms_gap(x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor) -> float:
    """RMS of ``x - y`` over the valid entries over the RMS of ``y`` there
    (``valid`` broadcasts over the trailing axes)."""
    valid = valid.reshape(valid.shape + (1,) * (y.dim() - valid.dim())).expand_as(y)
    d, r = (x - y)[valid].double(), y[valid].double()
    return float(d.square().mean().sqrt() / r.square().mean().sqrt().clamp_min(1e-30))


def std_gap(x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor) -> float:
    """RMS of ``x - y`` over the valid entries over the standard deviation
    of ``y`` there."""
    d, r = (x - y)[valid].double(), y[valid].double()
    return float(d.square().mean().sqrt() / r.std(unbiased=False).clamp_min(1e-30))


def gaps(got: Stages, ref: Stages, rollouts: List[dict],
         chained: Optional[Stages] = None) -> Dict[str, tuple]:
    """Each stage's worst step: ``text_gap``, ``pano_gap`` (valid slots),
    ``node_gap`` (valid map entries), ``bev_gap`` (every cell), ``nav_gap``
    (logits the reference does not mask), ``gate_gap`` (the largest
    difference of a row's gate), ``probe_gap`` (the distance probe's
    logits, as ``nav_gap``); with ``chained``, the end-to-end
    ``logit_gap`` (the median step's relative norm of the logit difference)
    and ``prob_gap`` (the widest gap of the action probabilities). Each as
    (value, where)."""
    out: Dict[str, tuple] = {}

    def worst(name, value, where):
        if name not in out or value > out[name][0]:
            out[name] = (value, where)

    for r, ro in enumerate(rollouts):
        masks = torch.from_numpy(np.asarray(ro["lang"]["txt_masks"]))
        worst("text_gap", rms_gap(got.text[r], ref.text[r], masks), f"rollout {r + 1}")
        for t, p in enumerate(ro["pano"]):
            where = f"rollout {r + 1} step {t + 1}"
            lens = torch.from_numpy(np.asarray(p["in"]["view_lens"]))
            slots = torch.arange(ref.pano[r][t].shape[1])[None, :] < lens[:, None]
            worst("pano_gap", rms_gap(got.pano[r][t], ref.pano[r][t], slots), where)
        for t, n in enumerate(ro["nav"]):
            where = f"rollout {r + 1} step {t + 1}"
            nodes = torch.from_numpy(np.asarray(n["in"]["gmap_masks"]))
            worst("node_gap", rms_gap(got.nodes[r][t], ref.nodes[r][t], nodes), where)
            cells = torch.ones(ref.bev[r][t].shape[:2], dtype=torch.bool)
            worst("bev_gap", rms_gap(got.bev[r][t], ref.bev[r][t], cells), where)
            y = ref.logits[r][t]
            worst("nav_gap", std_gap(got.logits[r][t], y, y > MASKED), where)
            worst("gate_gap", float((got.gate[r][t] - ref.gate[r][t]).abs().max()), where)
    if ref.probe is not None:
        out["probe_gap"] = (std_gap(got.probe, ref.probe, ref.probe > MASKED),
                            "the last checked step, distances stretched")
    if chained is not None:
        steps = []
        for r, (a, b) in enumerate(zip(got.logits, chained.logits)):
            for t, (x, y) in enumerate(zip(a, b)):
                where = f"rollout {r + 1} step {t + 1}"
                live = y > MASKED
                steps.append((float((x[live] - y[live]).norm() / y[live].norm().clamp_min(1e-30)),
                              where))
                worst("prob_gap", float((torch.softmax(x, -1) - torch.softmax(y, -1)).abs().max()),
                      where)
        out["logit_gap"] = sorted(steps)[len(steps) // 2]
    return out


def stop_raised(logits: torch.Tensor) -> torch.Tensor:
    out = logits.clone()
    out[:, 0] += 0.5
    return out


def faulty(got: Stages, fault: str) -> Stages:
    """The program's outputs with a fault planted where the answer is
    produced: ``stop_raised`` (the stop logit + 0.5) or ``bev_scaled`` (the
    BEV x 1.25); the model's faults are ``reference_stages``'s ``fault``."""
    out = Stages(got.text, got.pano, got.nodes, got.bev, got.logits, got.gate, got.probe)
    if fault == "stop_raised":
        out.logits = [[stop_raised(x) for x in steps] for steps in got.logits]
        out.probe = None if got.probe is None else stop_raised(got.probe)
    elif fault == "bev_scaled":
        out.bev = [[b * 1.25 for b in steps] for steps in got.bev]
    else:
        raise ValueError(f"{fault!r} is planted in the reference's forward")
    return out
