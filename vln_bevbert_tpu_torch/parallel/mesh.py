"""A rank's share of the data (port of ``vln_bevbert_tpu/parallel/mesh.py``).

JAX shards one global array over a ``dp`` mesh; here each rank is a process
that holds its own rows, and these plain functions cut them out. Rank ``r``
of ``world`` holds rows ``[r * b, (r + 1) * b)`` of a global batch of
``world * b`` rows, the rows that JAX's mesh puts on device ``r``.
Parameters and optimizer state are whole on every rank
(``replicate_module``).
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Iterator, Mapping, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..utils.device import to_device
from . import distributed

#: replay-bundle keys that are per-step schedule or rng state, not batched data
_BUNDLE_REPLICATED = ("step_idx", "rng", "rng_lang", "rng_pano")
#: replay-bundle keys with a leading batch axis (everything else is (T, B, ...))
_BUNDLE_BATCH_LEADING = ("txt_ids", "txt_masks")


def _rows(x, rank: int, world: int, axis: int = 0):
    n = x.shape[axis]
    if n % world:
        raise ValueError(f"{n} rows on axis {axis} do not split over {world} ranks")
    b = n // world
    index = (slice(None),) * axis + (slice(rank * b, (rank + 1) * b),)
    return x[index]


def shard_batch(batch: Mapping[str, Any], rank: int, world: int) -> Dict[str, Any]:
    """The rank's rows along axis 0 of every array (numpy or torch)."""
    return {k: _rows(v, rank, world) for k, v in batch.items()}


def shard_replay_bundle(rb: Mapping[str, Any], rank: int, world: int) -> Dict[str, Any]:
    """The rank's rows of a fine-tuning replay bundle: step-leading
    (T, B, ...) arrays split on axis 1, ``txt_ids``/``txt_masks`` on axis 0,
    ``step_idx`` and rng entries whole."""
    out = {}
    for k, v in rb.items():
        if k in _BUNDLE_REPLICATED:
            out[k] = v
        elif k in _BUNDLE_BATCH_LEADING:
            out[k] = _rows(v, rank, world)
        else:
            out[k] = _rows(v, rank, world, axis=1)
    return out


@torch.no_grad()
def replicate_module(module: nn.Module, src: int = 0) -> None:
    """Broadcast ``module``'s parameters and buffers from rank ``src``, one
    flat buffer per dtype. One process: nothing to do."""
    if not distributed.active():
        return
    tensors = [t for t in (*module.parameters(), *module.buffers())]
    by_dtype: Dict[torch.dtype, list] = collections.defaultdict(list)
    for t in tensors:
        by_dtype[t.dtype].append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def device_prefetch(iterator: Iterator[Tuple[Any, Mapping[str, Any]]], device,
                    depth: int = 2) -> Iterator[Tuple[Any, Dict[str, torch.Tensor]]]:
    """Keep ``depth`` batches uploaded ahead of their use: items are
    (tag, batch) tuples and only the batch goes to ``device``
    (``utils.device.to_device``: pinned, non-blocking on a card)."""
    device = torch.device(device)
    queue: collections.deque = collections.deque()
    for tag, batch in iterator:
        queue.append((tag, {k: to_device(v, device) for k, v in batch.items()}))
        if len(queue) >= depth:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
