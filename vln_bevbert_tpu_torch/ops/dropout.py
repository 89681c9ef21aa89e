"""Seeded dropout: the CUDA kernel ``csrc/dropout.cu`` and its plain version.

Port of ``vln_bevbert_tpu/ops/dropout.py``'s Pallas path (``_pallas_apply``
and the ``custom_vjp`` ``_dropout_sr``): one uint32 seed per leading row,
mask bits generated from it inside the kernel, and a backward that re-runs
the kernel on ``dy`` with the same seeds, so the only tensor saved for the
backward is the seed vector.

The bits are Philox4x32-10 keyed by (row seed, 0), one call per group of four
consecutive elements of a row (counter = group index); an element is kept iff
its 32 bits, read unsigned, are >= ``min(round(rate * 2**32), 2**32 - 1)``
and kept values are multiplied by ``1 / (1 - rate)``. ``dropout_ref``
computes the same function with int64 tensor arithmetic, bit for bit.

``Dropout`` in training mode draws its seeds with ``torch.randint`` from the
generator it was handed (a CUDA generator for CUDA tensors: no host sync) and
calls ``dropout``. Under data parallelism (``set_dropout_generator``'s
``rank`` and ``world``) it draws the seeds of the global rows and keeps its
rank's, so that every rank's masks are those of one process at the global
batch and every rank's generator advances alike; this takes the place of the
JAX kernel's ``custom_partitioning`` rule. Rows are batch-major unless
``step_rows(T)`` says that the leading axis is T steps of the batch
flattened step-major, as the replay's panorama is: the local row ``(t, j)``
of rank ``r`` is then global row ``t * B + r * b + j``. On CUDA tensors ``dropout`` calls the operator
``torch.ops.bevbert.seeded_dropout`` (``csrc/ops.cpp``), whose C++ autograd
saves only the seeds and relaunches the kernel on ``dy``; its checks and
launch run in C++, so a call costs one operator dispatch. CPU tensors take
the plain version, through a Python ``autograd.Function`` when a gradient is
needed. The mask stream differs from JAX's; only its distribution is part of
parity.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Iterator, Optional

import torch
from torch import nn

from .. import _build

_U32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def threshold_and_scale(rate: float) -> tuple[int, float]:
    """(unsigned 32-bit keep threshold, scale of kept values) for ``rate``."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
    return min(int(round(rate * 2 ** 32)), _U32), 1.0 / (1.0 - rate)


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit halves of the 64-bit product m * c, c uint32 values in
    int64. Built from 16-bit halves so that no partial product overflows."""
    m_hi, m_lo = m >> 16, m & 0xFFFF
    c_hi, c_lo = c >> 16, c & 0xFFFF
    mid = m_hi * c_lo + m_lo * c_hi
    low = m_lo * c_lo + ((mid & 0xFFFF) << 16)
    hi = (m_hi * c_hi + (mid >> 16) + (low >> 32)) & _U32
    return hi, low & _U32


def philox_bits(seeds: torch.Tensor, row_len: int) -> torch.Tensor:
    """(rows, row_len) int64 holding the uint32 mask bits of each row:
    Philox4x32-10 keyed by (seed, 0), counter (g, g >> 32, 0, 0) for group g,
    element o taking word o % 4 of group o // 4."""
    groups = torch.arange((row_len + 3) // 4, device=seeds.device, dtype=torch.int64)
    k0 = (seeds.to(torch.int64) & _U32)[:, None]
    k1 = torch.zeros_like(k0)
    c0 = (groups & _U32)[None, :].expand(len(seeds), -1)
    c1 = (groups >> 32)[None, :].expand(len(seeds), -1)
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _U32
        k1 = (k1 + _PHILOX_W[1]) & _U32
    return torch.stack([c0, c1, c2, c3], dim=-1).reshape(len(seeds), -1)[:, :row_len]


def dropout_ref(x: torch.Tensor, seeds: torch.Tensor, rate: float) -> torch.Tensor:
    """Plain version of the kernel on any device: the same mask from the same
    seeds (one per ``x.shape[0]`` row), the same rounding of kept values."""
    thresh, scale = threshold_and_scale(rate)
    bits = philox_bits(seeds, math.prod(x.shape[1:])).reshape(x.shape)
    return torch.where(bits >= thresh, x * scale, torch.zeros((), dtype=x.dtype,
                                                                device=x.device))


class _SeededDropout(torch.autograd.Function):
    """The CPU route: dy -> the plain version on dy with the same seeds;
    saves only the seeds."""

    @staticmethod
    def forward(ctx, x, seeds, rate):
        ctx.rate = rate
        ctx.save_for_backward(seeds)
        return dropout_ref(x, seeds, rate)

    @staticmethod
    def backward(ctx, dy):
        (seeds,) = ctx.saved_tensors
        return dropout_ref(dy.contiguous(), seeds, ctx.rate), None, None


def dropout(x: torch.Tensor, seeds: torch.Tensor, rate: float) -> torch.Tensor:
    """Seeded dropout of a contiguous ``x`` (R, ...) float32 or bfloat16 with
    ``seeds`` (R,) int32 holding uint32 bits, differentiable in ``x``; an
    input that needs no gradient records no backward and saves nothing. CUDA
    tensors launch ``csrc/dropout.cu`` through the operator or raise."""
    if x.device.type == "cuda":
        return _build.load().seeded_dropout(x, seeds, rate)
    if x.device.type != "cpu" or seeds.device.type != "cpu":
        raise ValueError(
            f"dropout: x on {x.device}, seeds on {seeds.device}; both must be on "
            "one CUDA device (or both on the CPU)"
        )
    if x.requires_grad and torch.is_grad_enabled():
        return _SeededDropout.apply(x, seeds, rate)
    return dropout_ref(x, seeds, rate)


def draw_seeds(rows: int, generator: torch.Generator, device) -> torch.Tensor:
    """``rows`` uniform uint32 seeds (int32 storage) drawn on ``device``."""
    return torch.randint(-2 ** 31, 2 ** 31, (rows,), generator=generator,
                         device=device, dtype=torch.int32)


#: leading rows of the inputs seen under ``step_rows``: steps x batch
_STEPS = contextvars.ContextVar("dropout_steps", default=1)


@contextlib.contextmanager
def step_rows(steps: int) -> Iterator[None]:
    """Inside the block, a Dropout's leading axis is ``steps`` steps of the
    batch, flattened step-major ((T, B) -> T * B)."""
    token = _STEPS.set(int(steps))
    try:
        yield
    finally:
        _STEPS.reset(token)


def rank_rows(full: torch.Tensor, rank: int, world: int, steps: int = 1) -> torch.Tensor:
    """Rank ``rank``'s rows of ``full``, drawn for ``world`` ranks' rows:
    a contiguous block of each of the ``steps`` steps."""
    per_step = full.reshape(steps, world, -1, *full.shape[1:])
    return per_step[:, rank].reshape(-1, *full.shape[1:]).contiguous()


class Dropout(nn.Module):
    """Identity in eval mode (the JAX modules' ``deterministic`` flag);
    in training mode seeded dropout of a rank >= 2 input, one seed per
    leading row. A rank-1 input takes ``torch.bernoulli``, as the JAX
    package keeps rank-1 inputs on its plain path. ``site`` names the call
    site in messages. ``rank`` of ``world`` draws for every rank's rows and
    keeps its own."""

    def __init__(self, rate: float, site: str = "generic"):
        super().__init__()
        self.rate = float(rate)
        self.site = site
        self.generator: Optional[torch.Generator] = None
        self.rank, self.world = 0, 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError(
                f"Dropout({self.site}) in training mode needs a generator: "
                "see set_dropout_generator"
            )
        rows = x.shape[0] * self.world
        if x.dim() < 2:
            keep = torch.bernoulli(
                torch.full((rows,), 1.0 - self.rate, device=x.device),
                generator=self.generator,
            ).bool()
            if self.world > 1:
                keep = rank_rows(keep, self.rank, self.world, _STEPS.get())
            return torch.where(keep, x * (1.0 / (1.0 - self.rate)), torch.zeros_like(x))
        seeds = draw_seeds(rows, self.generator, x.device)
        if self.world > 1:
            seeds = rank_rows(seeds, self.rank, self.world, _STEPS.get())
        return dropout(x.contiguous(), seeds, self.rate)


def set_dropout_generator(module: nn.Module, generator: Optional[torch.Generator],
                          rank: int = 0, world: int = 1) -> None:
    """Hand ``generator`` to every Dropout inside ``module``, as rank
    ``rank`` of ``world`` data-parallel ranks."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator
            m.rank, m.world = rank, world
