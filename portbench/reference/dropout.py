"""Seeded dropout as plain tensor arithmetic (a frozen copy of the function of
``vln_bevbert_tpu_torch/ops/dropout.py:dropout_ref``): one uint32 seed per
leading row; the mask bits are Philox4x32-10 keyed by (seed, 0), one call per
group of four consecutive elements of a row (counter = group index); an
element is kept iff its 32 bits, read unsigned, are >= ``min(round(rate *
2**32), 2**32 - 1)``, and kept values are scaled by ``1 / (1 - rate)``."""

from __future__ import annotations

import math

import torch

_U32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def threshold_and_scale(rate: float) -> tuple[int, float]:
    return min(int(round(rate * 2 ** 32)), _U32), 1.0 / (1.0 - rate)


def _mulhilo(m: int, c: torch.Tensor):
    m_hi, m_lo = m >> 16, m & 0xFFFF
    c_hi, c_lo = c >> 16, c & 0xFFFF
    mid = m_hi * c_lo + m_lo * c_hi
    low = m_lo * c_lo + ((mid & 0xFFFF) << 16)
    hi = (m_hi * c_hi + (mid >> 16) + (low >> 32)) & _U32
    return hi, low & _U32


def philox_bits(seeds: torch.Tensor, row_len: int) -> torch.Tensor:
    """(rows, row_len) int64 holding each element's uint32 bits."""
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


def keep_mask(shape, seeds: torch.Tensor, rate: float) -> torch.Tensor:
    """The bool mask of kept elements of a tensor of ``shape``; rows are
    computed in blocks to bound the int64 temporaries."""
    thresh, _ = threshold_and_scale(rate)
    row_len = math.prod(shape[1:])
    step = max(1, (1 << 24) // max(row_len, 1))
    parts = [philox_bits(seeds[i:i + step], row_len) >= thresh
             for i in range(0, len(seeds), step)]
    return torch.cat(parts).reshape(shape)


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seeds, rate):
        keep = keep_mask(x.shape, seeds, rate)
        scale = threshold_and_scale(rate)[1]
        ctx.save_for_backward(keep)
        ctx.scale = scale
        return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype, device=x.device))

    @staticmethod
    def backward(ctx, dy):
        (keep,) = ctx.saved_tensors
        return (torch.where(keep, dy * ctx.scale, torch.zeros((), dtype=dy.dtype,
                                                              device=dy.device)), None, None)


def seeded_dropout(x: torch.Tensor, seeds: torch.Tensor, rate: float) -> torch.Tensor:
    """Differentiable in ``x``; on the ``meta`` device (counting passes) a
    tensor of ``x``'s shape."""
    if x.device.type == "meta":
        return x * 1.0
    return _Dropout.apply(x, seeds, rate)
