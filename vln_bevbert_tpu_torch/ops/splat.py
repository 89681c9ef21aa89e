"""BEV splat sums: the CUDA kernel ``csrc/splat.cu`` and its plain version.

Port of ``vln_bevbert_tpu/ops/pallas_splat.py:splat_sums``: per batch row,
``out[c, d] = sum_n [cell[n] == c] * payload[n, d]``, with invalid points
carrying cell -1. The TPU kernel contracts a VMEM one-hot on the MXU; the
Hopper kernel computes the same sums as a scatter (see the source's note).

``splat_sums`` takes the plain version only for tensors that lie on the CPU.
For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch


def splat_sums_ref(cell: torch.Tensor, payload: torch.Tensor, num_cells: int) -> torch.Tensor:
    """Plain version: an f32 ``index_add_`` segment sum on any device.

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


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bevbert_splat_sums.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.bevbert_splat_sums.restype = i
    lib.bevbert_cuda_error_string.argtypes = [i]
    lib.bevbert_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    from .._build import load

    return _bind(load("splat"))


# Shared memory a block may use on Hopper (232,448 bytes of the SM's 256 KB).
_MAX_SMEM = 232448
_TILE_D = 64


def _num_splits(batch: int, n_points: int, d: int, device: torch.device) -> int:
    """Split the points so that the grid fills the card in one wave of two
    blocks per SM (two ~113 KB shared-memory tiles fit on an SM)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = batch * -(-d // _TILE_D)
    return max(1, min(-(-n_points // 1024), 2 * sms // tiles))


def splat_sums(cell: torch.Tensor, payload: torch.Tensor, num_cells: int) -> torch.Tensor:
    """cell (B, N) int32 (invalid points = -1); payload (B, N, D) bfloat16.

    Returns (B, num_cells, D) float32 per-cell sums. CPU tensors take
    ``splat_sums_ref``; CUDA tensors launch ``csrc/splat.cu`` or raise."""
    if cell.device.type == "cpu" and payload.device.type == "cpu":
        return splat_sums_ref(cell, payload, num_cells)
    if cell.device.type != "cuda" or payload.device != cell.device:
        raise ValueError(
            f"splat_sums: cell on {cell.device}, payload on {payload.device}; "
            "both must be on one CUDA device (or both on the CPU)"
        )
    if cell.dtype != torch.int32 or payload.dtype != torch.bfloat16:
        raise TypeError(
            f"splat_sums: need int32 cell and bfloat16 payload, got "
            f"{cell.dtype} and {payload.dtype}"
        )
    if cell.dim() != 2 or payload.dim() != 3 or payload.shape[:2] != cell.shape:
        raise ValueError(
            f"splat_sums: need cell (B, N) and payload (B, N, D), got "
            f"{tuple(cell.shape)} and {tuple(payload.shape)}"
        )
    if not (cell.is_contiguous() and payload.is_contiguous()):
        raise ValueError("splat_sums: cell and payload must be contiguous")
    b, n = cell.shape
    d = payload.shape[-1]
    if num_cells < 1 or d < 1 or num_cells * _TILE_D * 4 > _MAX_SMEM:
        raise ValueError(
            f"splat_sums: {num_cells} cells x {d} channels is outside the "
            f"kernel's range (1..{_MAX_SMEM // (_TILE_D * 4)} cells)"
        )
    lib = _library()
    out = torch.zeros(b, num_cells, d, dtype=torch.float32, device=cell.device)
    if b == 0 or n == 0:
        return out
    with torch.cuda.device(cell.device):
        stream = torch.cuda.current_stream(cell.device).cuda_stream
        err = lib.bevbert_splat_sums(
            cell.data_ptr(), payload.data_ptr(), out.data_ptr(),
            b, n, num_cells, d, _num_splits(b, n, d, cell.device), stream,
        )
    if err != 0:
        raise RuntimeError(
            "splat_sums kernel launch failed: "
            + lib.bevbert_cuda_error_string(err).decode()
        )
    splat_sums.launches += 1
    return out


splat_sums.launches = 0  # kernel launches; chip_smoke.py resets and reads it
