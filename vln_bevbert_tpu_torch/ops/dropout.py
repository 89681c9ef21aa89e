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
calls ``dropout``. ``dropout_apply`` takes the plain version only for tensors
that lie on the CPU; for CUDA tensors it launches the kernel or raises. The
mask stream differs from JAX's; only its distribution is part of parity.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
from torch import nn

_U32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_THREADS = 256  # csrc/dropout.cu:kThreads


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


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bevbert_dropout.argtypes = [p, p, p, ll, ll, ctypes.c_uint, ctypes.c_float,
                                    i, i, i, p]
    lib.bevbert_dropout.restype = i
    lib.bevbert_cuda_error_string.argtypes = [i]
    lib.bevbert_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    from .._build import load

    return _bind(load("dropout"))


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def dropout_apply(x: torch.Tensor, seeds: torch.Tensor, rate: float) -> torch.Tensor:
    """x (R, ...) float32 or bfloat16; seeds (R,) int32 holding uint32 bits.

    CPU tensors take ``dropout_ref``; CUDA tensors launch ``csrc/dropout.cu``
    or raise."""
    if x.device.type == "cpu" and seeds.device.type == "cpu":
        return dropout_ref(x, seeds, rate)
    if x.device.type != "cuda" or seeds.device != x.device:
        raise ValueError(
            f"dropout: x on {x.device}, seeds on {seeds.device}; both must be on "
            "one CUDA device (or both on the CPU)"
        )
    if x.dtype not in _DTYPES or seeds.dtype != torch.int32:
        raise TypeError(
            f"dropout: need float32 or bfloat16 x and int32 seeds, got {x.dtype} "
            f"and {seeds.dtype}"
        )
    if x.dim() < 1 or seeds.shape != x.shape[:1]:
        raise ValueError(
            f"dropout: need one seed per row of x, got x {tuple(x.shape)} and "
            f"seeds {tuple(seeds.shape)}"
        )
    if not (x.is_contiguous() and seeds.is_contiguous()):
        raise ValueError("dropout: x and seeds must be contiguous")
    thresh, scale = threshold_and_scale(rate)
    lib = _library()
    y = torch.empty_like(x)
    rows, row_len = x.shape[0], math.prod(x.shape[1:])
    if rows == 0 or row_len == 0:
        return y
    vec_bytes = 4 * x.element_size()
    vec = row_len % 4 == 0 and x.data_ptr() % vec_bytes == 0 and y.data_ptr() % vec_bytes == 0
    work = rows * -(-row_len // 4)
    grid = max(1, min(-(-work // _THREADS), 32 * _sm_count(x.device.index)))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bevbert_dropout(x.data_ptr(), y.data_ptr(), seeds.data_ptr(), rows,
                                  row_len, thresh, scale, _DTYPES[x.dtype], int(vec),
                                  grid, stream)
    if err != 0:
        raise RuntimeError(
            "dropout kernel launch failed: " + lib.bevbert_cuda_error_string(err).decode()
        )
    dropout_apply.launches += 1
    return y


dropout_apply.launches = 0  # kernel launches; chip_smoke.py resets and reads it


class _SeededDropout(torch.autograd.Function):
    """dy -> the same kernel on dy with the same seeds; saves only the seeds."""

    @staticmethod
    def forward(ctx, x, seeds, rate):
        ctx.rate = rate
        ctx.save_for_backward(seeds)
        return dropout_apply(x, seeds, rate)

    @staticmethod
    def backward(ctx, dy):
        (seeds,) = ctx.saved_tensors
        return dropout_apply(dy.contiguous(), seeds, ctx.rate), None, None


def dropout(x: torch.Tensor, seeds: torch.Tensor, rate: float) -> torch.Tensor:
    """Seeded dropout of a contiguous ``x``, differentiable in ``x``; an input
    that needs no gradient records no backward and saves nothing."""
    if x.requires_grad and torch.is_grad_enabled():
        return _SeededDropout.apply(x, seeds, rate)
    return dropout_apply(x, seeds, rate)


def draw_seeds(rows: int, generator: torch.Generator, device) -> torch.Tensor:
    """``rows`` uniform uint32 seeds (int32 storage) drawn on ``device``."""
    return torch.randint(-2 ** 31, 2 ** 31, (rows,), generator=generator,
                         device=device, dtype=torch.int32)


class Dropout(nn.Module):
    """Identity in eval mode (the JAX modules' ``deterministic`` flag);
    in training mode seeded dropout of a rank >= 2 input, one seed per
    leading row. A rank-1 input takes ``torch.bernoulli``, as the JAX
    package keeps rank-1 inputs on its plain path. ``site`` names the call
    site in messages."""

    def __init__(self, rate: float, site: str = "generic"):
        super().__init__()
        self.rate = float(rate)
        self.site = site
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError(
                f"Dropout({self.site}) in training mode needs a generator: "
                "see set_dropout_generator"
            )
        if x.dim() < 2:
            keep = torch.bernoulli(
                torch.full_like(x, 1.0 - self.rate, dtype=torch.float32),
                generator=self.generator,
            ).bool()
            return torch.where(keep, x * (1.0 / (1.0 - self.rate)), torch.zeros_like(x))
        seeds = draw_seeds(x.shape[0], self.generator, x.device)
        return dropout(x.contiguous(), seeds, self.rate)


def set_dropout_generator(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Hand ``generator`` to every Dropout inside ``module``."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator
