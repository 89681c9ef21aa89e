"""Work counted from shapes, never from the program: model FLOPs, the bytes
the dropout sites must move, and the bytes the BEV splat must move.

- ``StepCounts``: one counting pass of the reference's forward and backward
  on the ``meta`` device (no memory, no arithmetic) per batch signature,
  under ``torch.utils.flop_counter.FlopCounterMode`` (2 FLOPs per
  multiply-add of every matrix product, forward and backward), at the
  program's stated precision (bfloat16 activations over float32
  parameters) so that each dropout site's input and output have the
  program's dtype. A site moves its input once and its output once
  forward, and the gradient once in and once out where the loss reaches its
  output (there the program's kernel runs again on the gradient).
- ``splat_bytes``: the bytes one splat must move: every point's cell index
  (int32) read once, each valid point's feature row (and int32 label) read
  once, and the (cells x (features [+ labels] + 1)) float32 sums written
  once. Which points are valid depends on the depths and poses, so it is
  counted from them with the reference's lift.
- ``H100``: the published peaks (NVIDIA H100 SXM data sheet, dense).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference.model import Dropout

#: NVIDIA H100 SXM: bf16 dense tensor-core FLOP/s and HBM3 bytes/s
H100 = {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}

Signature = Tuple[Tuple[str, Tuple[int, ...], str], ...]


def signature(batch: Dict[str, np.ndarray]) -> Signature:
    return tuple(sorted((k, tuple(np.shape(v)), str(np.asarray(v).dtype))
                        for k, v in batch.items()))


def meta_batch(sig: Signature) -> Dict[str, torch.Tensor]:
    out = {}
    for key, shape, dtype in sig:
        dt = torch.bool if dtype == "bool" else getattr(torch, dtype)
        out[key] = torch.empty(shape, dtype=dt, device="meta")
    return out


def count(model: torch.nn.Module, fn: Callable[[], torch.Tensor],
          backward: bool) -> Tuple[float, float]:
    """(FLOPs, dropout bytes) of ``fn()`` on ``model`` (on ``meta``), and of
    the backward of its result with ``backward``."""
    moved = [0.0]

    def site(x: torch.Tensor, y: torch.Tensor) -> None:
        moved[0] += x.numel() * x.element_size() + y.numel() * y.element_size()
        if y.requires_grad:
            n = 2 * y.numel() * y.element_size()
            y.register_hook(lambda g, n=n: moved.__setitem__(0, moved[0] + n))

    drops = [m for m in model.modules() if isinstance(m, Dropout)]
    for m in drops:
        m.hook = site
    try:
        with FlopCounterMode(display=False) as fc:
            out = fn()
            if backward:
                out.backward()
    finally:
        for m in drops:
            m.hook = None
    return float(fc.get_total_flops()), moved[0]


class StepCounts:
    """(FLOPs, dropout bytes) of one training step per (task, batch
    signature): ``loss_of(task, batch)`` runs ``model``'s loss (the
    reference, built on ``meta``) on a meta batch."""

    def __init__(self, model: torch.nn.Module,
                 loss_of: Callable[[str, Dict[str, torch.Tensor]], torch.Tensor]):
        self.model, self.loss_of = model, loss_of
        self.cache: Dict[Tuple[str, Signature], Tuple[float, float]] = {}

    def __call__(self, task: str, sig: Signature) -> Tuple[float, float]:
        if (task, sig) not in self.cache:
            self.cache[task, sig] = count(
                self.model, lambda: self.loss_of(task, meta_batch(sig)), True)
        return self.cache[task, sig]


def splat_bytes(valid_points: int, n_points: int, feat_dim: int, feat_bytes: int,
                num_cells: int, out_cols: int, with_labels: bool) -> float:
    """Bytes one batch row's splat must move (see the module's note)."""
    row = feat_dim * feat_bytes + (4 if with_labels else 0)
    return float(4 * n_points + valid_points * row + num_cells * out_cols * 4)


def roofline_pct(n_bytes: float, device_s: float) -> float:
    """The least time those bytes take at the HBM peak, over the measured time, in %."""
    return 100.0 * (n_bytes / H100["hbm_bytes"]) / device_s


def mfu_pct(flops: float, seconds: float) -> float:
    return 100.0 * flops / (seconds * H100["bf16_flops"])
