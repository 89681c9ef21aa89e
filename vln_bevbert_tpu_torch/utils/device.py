"""Devices and host -> device uploads."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(name) -> torch.device:
    """``name`` as a ``torch.device``; a CUDA device raises where CUDA is not
    available (there is no fallback to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name}: CUDA is not available")
    return device


def to_device(x, device: torch.device) -> torch.Tensor:
    """A numpy array (a tensor passes through) as a tensor on ``device``.

    CUDA uploads go through pinned memory with a non-blocking copy, so they
    queue behind the card's work; a copy from pageable memory would wait for
    it."""
    if isinstance(x, torch.Tensor):
        return x
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
