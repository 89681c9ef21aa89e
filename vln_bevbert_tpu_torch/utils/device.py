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
    """A numpy array or a tensor as a tensor on ``device``.

    CUDA uploads of host data go through pinned memory with a non-blocking
    copy, so they queue behind the card's work; a copy from pageable memory
    would wait for it. A host tensor already pinned is copied from as it
    lies. Any other tensor passes through."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu" or device.type != "cuda":
            return x
        t = x
    else:
        t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return (t if t.is_pinned() else t.pin_memory()).to(device, non_blocking=True)
    return t.to(device)
