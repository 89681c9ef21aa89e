"""Seeded generators (port of ``vln_bevbert_tpu/utils/rng.py``).

The JAX package builds rbg-backed PRNG keys; the port hands an explicit
``torch.Generator`` to whatever draws random numbers (parameter init,
dropout). A generator lives on one device type, so draws for CUDA tensors
take a CUDA generator.
"""

from __future__ import annotations

import torch


def make_generator(seed: int, device="cpu") -> torch.Generator:
    """A generator on ``device`` (CPU or CUDA) seeded with ``seed``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


def train_generator(seed: int, device="cpu") -> torch.Generator:
    """The dropout generator of a training loop, on ``device``: a CUDA
    generator draws the per-row dropout seeds on the card, with no host sync.
    Its seed is drawn from ``make_generator(seed)``, so that its stream is
    not the one that initialised the parameters from the same ``seed``."""
    child = torch.randint(2 ** 62, (1,), generator=make_generator(seed)).item()
    return make_generator(child, device)
