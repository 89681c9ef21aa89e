"""The reference's training steps: the loss, its backward, the float32
global-norm clip and AdamW, in plain float32 tensor operations.

``AdamW`` is the textbook update (float32 moments, bias corrections, decoupled
weight decay on the parameters ``model.decayed`` names) under the
configuration's learning-rate schedule (linear warm-up then linear decay, or
constant). ``Readings`` are what a run compares: each step's loss, each
leaf's gradient norm as the optimizer received it at the first step, and
each leaf's change after the last step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from .model import decayed


def lr_at(optim: dict, count: int) -> float:
    """The learning rate of update ``count`` (0-based)."""
    lr = optim["learning_rate"]
    if optim.get("lr_schedule", "linear") == "constant":
        return lr
    warmup, total = optim["warmup_steps"], optim["num_train_steps"]
    if count < warmup:
        return lr * count / max(warmup, 1)
    decay = max(total - warmup, 1)
    return lr * (1.0 - min(count - warmup, decay) / decay)


class AdamW:
    def __init__(self, named: Sequence[tuple], optim: dict, decay_all: bool = False,
                 count: int = 0):
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.optim = optim
        self.b1, self.b2 = optim["betas"]
        self.decay = [decay_all or decayed(n) for n in self.names]
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = count  # updates made before this optimizer's first

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        lr = lr_at(self.optim, self.count)
        self.count += 1
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        wd = self.optim["weight_decay"]
        for p, g, m, v, d in zip(self.params, grads, self.m, self.v, self.decay):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (m / c1) / ((v / c2).sqrt() + 1e-8)
            if d and wd:
                u = u + wd * p
            p.sub_(lr * u)


def clip_(grads: List[torch.Tensor], max_norm: float) -> None:
    """Scale by ``max_norm / max(norm, max_norm)`` over the global norm."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    for g in grads:
        g.mul_(max_norm / torch.clamp_min(norm, max_norm))


@dataclass
class Readings:
    """One side's numbers over a run's first steps."""

    losses: List[float] = field(default_factory=list)
    grad_norms: Dict[str, float] = field(default_factory=dict)    # first step, by leaf
    grad_abs: Dict[str, torch.Tensor] = field(default_factory=dict)  # its |g|, on the host
    change_norms: Dict[str, float] = field(default_factory=dict)  # after the last step


class Stepper:
    """The reference's training steps from ``model``'s current parameters:
    ``step(loss_fn)`` runs one (``loss_fn`` returns the step's loss,
    differentiable in the parameters); ``readings()`` reads them.
    ``decay_all`` decays every parameter (the fine-tuning agent's AdamW),
    else those ``model.decayed`` names. ``start_count`` is the update count
    of the first step (the schedule's and the bias corrections' step)."""

    def __init__(self, model: torch.nn.Module, optim: dict, clip: float,
                 decay_all: bool = False, start_count: int = 0):
        self.named = list(model.named_parameters())
        self.start = [p.detach().clone() for _, p in self.named]
        self.opt = AdamW(self.named, optim, decay_all, start_count)
        self.clip = clip
        self.out = Readings()

    def step(self, loss_fn: Callable[[], torch.Tensor]) -> None:
        for _, p in self.named:
            p.grad = None
        loss = loss_fn()
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for _, p in self.named]
        clip_(grads, self.clip)
        if not self.out.losses:
            self.out.grad_norms = {n: float(g.norm()) for (n, _), g in zip(self.named, grads)}
            self.out.grad_abs = {n: g.abs().cpu() for (n, _), g in zip(self.named, grads)}
        self.opt.step(grads)
        self.out.losses.append(float(loss.detach()))
        for _, p in self.named:
            p.grad = None

    def readings(self) -> Readings:
        self.out.change_norms = {n: float((p.detach() - p0).norm())
                                 for (n, p), p0 in zip(self.named, self.start)}
        return self.out


def train_steps(model: torch.nn.Module, loss_fns: Sequence[Callable[[], torch.Tensor]],
                optim: dict, clip: float, decay_all: bool = False,
                start_count: int = 0) -> Readings:
    """One ``Stepper`` step per ``loss_fns`` entry, then the readings."""
    stepper = Stepper(model, optim, clip, decay_all, start_count)
    for loss_fn in loss_fns:
        stepper.step(loss_fn)
    return stepper.readings()


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: Sequence[str]) -> Dict[str, float]:
    """``|prog - ref| / max(ref, median ref)`` of each of ``leaves``."""
    med = float(np.median([ref[n] for n in leaves]))
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in leaves}


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   leaves: Sequence[str]) -> tuple:
    """(gap, leaf) of the leaf with the largest ``leaf_gaps``."""
    gaps = leaf_gaps(prog, ref, leaves)
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                    leaves: Sequence[str]) -> tuple:
    """(gap, leaf) of the median leaf by ``leaf_gaps``."""
    gaps = leaf_gaps(prog, ref, leaves)
    leaf = sorted(gaps, key=gaps.get)[len(gaps) // 2]
    return gaps[leaf], leaf


def median_leaf_elem_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                         leaves: Sequence[str]) -> tuple:
    """(gap, leaf): over ``leaves``, the median of ``|| |g_prog| - |g_ref| ||
    / || g_ref ||``, element by element."""
    gaps = {n: float((prog[n] - ref[n]).norm() / ref[n].norm().clamp_min(1e-30)) for n in leaves}
    leaf = sorted(gaps, key=gaps.get)[len(gaps) // 2]
    return gaps[leaf], leaf


def compare(prog: Readings, ref: Readings) -> Dict[str, tuple]:
    """The numbers a training cell compares: the worst step's relative loss
    gap, and the first step's; the worst leaf's gap of first-step gradient norms; the median
    leaf's element-by-element gap of the first step's gradient magnitudes;
    the worst and the median leaf's gap of change norms. The last three over
    the leaves whose reference gradient is at least a thousandth of the
    median leaf's (a leaf whose gradient is nought to rounding, such as a
    key bias under softmax, moves by round-off alone). Each as (value,
    where); a cell's limits file names those it holds to a limit."""
    loss = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog.losses, ref.losses)]
    step = int(np.argmax(loss))
    names = list(ref.grad_norms)
    grad_med = float(np.median([ref.grad_norms[n] for n in names]))
    moving = [n for n in names if ref.grad_norms[n] >= 1e-3 * grad_med]
    return {
        "loss_gap": (loss[step], f"step {step + 1}"),
        "loss_first_gap": (loss[0], "step 1"),
        "grad_gap": worst_leaf_gap(prog.grad_norms, ref.grad_norms, names),
        "grad_elem_gap": median_leaf_elem_gap(prog.grad_abs, ref.grad_abs, moving),
        "change_gap": worst_leaf_gap(prog.change_norms, ref.change_norms, moving),
        "change_median_gap": median_leaf_gap(prog.change_norms, ref.change_norms, moving),
    }


def seeded_weights(named_shapes: Sequence[tuple], kinds: Dict[str, str], seed: int,
                   device, std: float = 0.02) -> Dict[str, torch.Tensor]:
    """Float32 weights from ``seed`` in one draw: every "normal" leaf a slice
    of one N(0, std) buffer made by a generator on ``device``, in the order
    of ``named_shapes``; biases 0 and LayerNorm scales 1."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed)
    normal = [(n, s) for n, s in named_shapes if kinds[n] == "normal"]
    total = sum(math.prod(s) for _, s in normal)
    buf = torch.empty(total, device=device).normal_(0.0, std, generator=gen)
    out, offset = {}, 0
    for n, s in normal:
        k = math.prod(s)
        out[n] = buf[offset:offset + k].view(s)
        offset += k
    for n, s in named_shapes:
        if kinds[n] != "normal":
            out[n] = (torch.ones if kinds[n] == "ones" else torch.zeros)(s, device=device)
    return out
