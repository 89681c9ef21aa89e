"""Plain dropout (the default path of ``vln_bevbert_tpu/ops/dropout.py``).

``Dropout`` is the identity in eval mode (the JAX modules' ``deterministic``
flag), and otherwise keeps each element with probability ``1 - rate``, drawn
by ``torch.bernoulli`` from the generator the module was handed, and scales
it by ``1 / (1 - rate)``. The mask stream differs from JAX's; only its
distribution is part of parity. ``site`` names the call site, so that a fused
dropout kernel can later be routed per site. The TPU's fused Pallas dropout
kernel is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class Dropout(nn.Module):
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
        keep = torch.bernoulli(
            torch.full_like(x, 1.0 - self.rate, dtype=torch.float32),
            generator=self.generator,
        ).bool()
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


def set_dropout_generator(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Hand ``generator`` to every Dropout inside ``module``."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator
