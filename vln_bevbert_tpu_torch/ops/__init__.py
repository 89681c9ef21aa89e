"""Device ops: masking, BEV projector, the CUDA splat and dropout kernels."""

from .bev import BevProjector
from .masking import NEG_INF, attn_bias, masked_fill_neg, seq_mask

__all__ = ["seq_mask", "attn_bias", "masked_fill_neg", "NEG_INF", "BevProjector"]
