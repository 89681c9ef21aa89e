"""Host -> device uploads."""

from __future__ import annotations

import numpy as np
import torch


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
