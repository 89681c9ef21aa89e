"""BEV splat sums: the CUDA kernel ``csrc/splat.cu`` and its plain versions.

Port of ``vln_bevbert_tpu/ops/pallas_splat.py:splat_sums``: per batch row,
``out[c, d] = sum_n [cell[n] == c] * payload[n, d]``, with invalid points
carrying cell -1, for the payload ``[bf16(feats) | one_hot(sem) | 1]`` that
``ops/bev.py`` splats. The TPU kernel contracts a VMEM one-hot on the MXU;
the Hopper kernel sorts the points by cell and sums runs in registers,
reading each feature row where it lies (see the source's note), so the
payload never exists on the card.

- ``splat_sums_ref(cell, payload, C)``: the plain segment sum of a payload,
  an f32 ``index_add_``; the JAX function's counterpart.
- ``splat_sums_plain(cell, feats, C, ...)``: the kernel's plain version:
  gather the feature rows, build the payload, ``splat_sums_ref``.
- ``splat_sums(cell, feats, C, ...)``: the same function. CPU tensors take
  ``splat_sums_plain``; CUDA tensors launch the kernel through the operator
  ``torch.ops.bevbert.splat_sums`` (``csrc/ops.cpp``) or raise.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build


def splat_sums_ref(cell: torch.Tensor, payload: torch.Tensor, num_cells: int) -> torch.Tensor:
    """Plain segment sum: an f32 ``index_add_`` on any device.

    cell (B, N) int, payload (B, N, D) -> (B, num_cells, D) float32. Points
    whose cell lies outside [0, num_cells) add nothing."""
    b, n = cell.shape
    d = payload.shape[-1]
    cell = cell.long()
    valid = (cell >= 0) & (cell < num_cells)
    rows = torch.arange(b, device=cell.device)[:, None] * num_cells + cell
    dump = b * num_cells  # one extra row collects the invalid points
    rows = torch.where(valid, rows, torch.full_like(rows, dump))
    out = torch.zeros(dump + 1, d, dtype=torch.float32, device=payload.device)
    out.index_add_(0, rows.reshape(-1), payload.reshape(b * n, d).float())
    return out[:dump].reshape(b, num_cells, d)


def gather_rows(feats: torch.Tensor, step_sel: Optional[torch.Tensor]) -> torch.Tensor:
    """The points' feature rows (B, N, F): with ``step_sel`` (B, S), point n
    of row b is pixel n % P of step ``step_sel[b, n // P]`` of ``feats``
    (B, T, P, F); without it ``feats`` (B, N, F) holds them already."""
    if step_sel is None:
        return feats
    b, s = step_sel.shape
    rows = torch.arange(b, device=feats.device)[:, None]
    return feats[rows, step_sel.long()].reshape(b, s * feats.shape[2], feats.shape[3])


def splat_sums_plain(cell: torch.Tensor, feats: torch.Tensor, num_cells: int,
                     step_sel: Optional[torch.Tensor] = None,
                     sem_labels: Optional[torch.Tensor] = None,
                     num_sem: int = 0) -> torch.Tensor:
    """Plain version of the kernel on any device: the gathered rows rounded
    to bf16, the one-hot of ``sem_labels`` and a ones column, concatenated
    and summed by ``splat_sums_ref``."""
    feats = gather_rows(feats, step_sel)
    cols = [feats.to(torch.bfloat16)]
    if sem_labels is not None:
        cols.append(F.one_hot(sem_labels.long(), num_sem).to(torch.bfloat16))
    cols.append(torch.ones(*feats.shape[:2], 1, dtype=torch.bfloat16, device=feats.device))
    return splat_sums_ref(cell, torch.cat(cols, dim=-1), num_cells)


def splat_sums(cell: torch.Tensor, feats: torch.Tensor, num_cells: int,
               step_sel: Optional[torch.Tensor] = None,
               sem_labels: Optional[torch.Tensor] = None,
               num_sem: int = 0) -> torch.Tensor:
    """cell (B, N) int32, invalid points -1; feats (B, N, F), or (B, T, P, F)
    with ``step_sel`` (B, S) int32 and N = S * P; optional ``sem_labels``
    (B, N) int with ``num_sem`` classes.

    Returns (B, num_cells, F + num_sem + 1) float32: per cell the sums of
    the bf16-rounded features, the label counts and the point count (a view
    of a row-padded buffer on the card). CPU tensors take
    ``splat_sums_plain``; CUDA tensors launch ``csrc/splat.cu`` or raise."""
    if cell.device.type == "cpu" and feats.device.type == "cpu":
        return splat_sums_plain(cell, feats, num_cells, step_sel, sem_labels, num_sem)
    if cell.device.type != "cuda":
        raise ValueError(
            f"splat_sums: cell on {cell.device}, feats on {feats.device}; both must be "
            "on one CUDA device (or both on the CPU)"
        )
    sem = None if sem_labels is None else sem_labels.to(torch.int32)
    return _build.load().splat_sums(cell, feats, step_sel, sem, num_cells,
                                    num_sem if sem is not None else 0)
