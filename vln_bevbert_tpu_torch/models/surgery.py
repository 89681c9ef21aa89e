"""Parameter transfer between training stages (port of
``transfer_pretrained`` / ``count_transferred`` of
``vln_bevbert_tpu/models/surgery.py``).

The navigation model contains the pretraining backbone as the same ``bert``
submodule and the same SAP heads (``global_sap_head``, ``local_sap_head``,
``sap_fuse_linear``), so a stage transfer copies every entry whose name the
destination also has. The JAX functions walk nested flax trees; here both
sides are flat ``state_dict``s. The reference-checkpoint remaps (HF-BERT,
LXMERT, XLM-R) are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch


def _fits(src: Mapping[str, torch.Tensor], name: str, value: torch.Tensor) -> bool:
    return name in src and tuple(src[name].shape) == tuple(value.shape)


def transfer_pretrained(src: Mapping[str, torch.Tensor],
                        dst: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A new state dict shaped like ``dst``: each entry of ``src`` whose name
    is in ``dst`` with the same shape, and ``dst``'s own (fresh) value for
    every other name."""
    return {k: src[k] if _fits(src, k, v) else v for k, v in dst.items()}


def count_transferred(src: Mapping[str, torch.Tensor], dst: Mapping[str, torch.Tensor]) -> int:
    """How many entries of ``dst`` ``transfer_pretrained`` takes from ``src``."""
    return sum(_fits(src, k, v) for k, v in dst.items())
