"""Mask / additive-bias helpers (port of ``vln_bevbert_tpu/ops/masking.py``).

Masked keys get an additive bias of -10000, never ``-inf``: the value matches
the reference, is representable in bfloat16, and keeps a fully masked row
finite through the softmax.
"""

from __future__ import annotations

import torch

NEG_INF = -10000.0


def seq_mask(lens: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths -> (B, max_len) bool validity mask."""
    return torch.arange(max_len, device=lens.device)[None, :] < lens[:, None]


def attn_bias(mask: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, L) bool key mask -> (B, 1, 1, L) additive bias (0 valid / NEG_INF pad).

    Built in float32; attention casts it to the activation dtype."""
    return ((1.0 - mask.to(dtype)) * NEG_INF)[:, None, None, :]


def masked_fill_neg(x: torch.Tensor, invalid: torch.Tensor) -> torch.Tensor:
    """Set logits at invalid positions to NEG_INF."""
    return x.masked_fill(invalid, NEG_INF)
