"""Process-group helpers (port of ``vln_bevbert_tpu/parallel/distributed.py``).

JAX runs one program over a ``dp`` mesh and XLA inserts the gradient psum;
PyTorch runs one process per card, as the reference's NCCL DDP does
(pretrain_src/utils/misc.py:64-77). ``initialize`` joins the group that a
launcher (``torchrun``, ``torch.distributed.run``) describes in ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT``, or one
given by ``init_method``; without either it does nothing and every helper
below acts on one process. The backend follows the device, NCCL for
``cuda`` and gloo for ``cpu``; one that is not available raises.

The sum and max reductions act on the default group when it exists, also at
world size 1 under a launcher, so that a one-card ``torchrun`` run issues
the collectives that a larger one does.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

#: collective timeout of a group: a rank that hangs fails the others' next
#: collective after this long instead of blocking them for good
DEFAULT_TIMEOUT_S = 600.0


def active() -> bool:
    """Whether this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def initialize(device="cuda", backend: Optional[str] = None,
               init_method: Optional[str] = None, rank: Optional[int] = None,
               world_size: Optional[int] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group and return this rank's device.

    Under a launcher (``RANK`` and ``WORLD_SIZE`` set) or with
    ``init_method`` the group is created, at world size 1 too; otherwise
    this is a no-op, as JAX's is on one host. ``rank`` and ``world_size``
    default to the launcher's variables. A ``cuda`` device without an index
    becomes ``cuda:LOCAL_RANK`` and the current device. ``backend`` defaults
    to NCCL for ``cuda`` and gloo for ``cpu``; a backend this build lacks
    raises. A group that exists already is kept."""
    device = torch.device(device)
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if device.type == "cuda" and device.index is None and (launched or init_method):
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if active() or not (launched or init_method):
        return device
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if not dist.is_available() or not dist.is_backend_available(backend):
        raise RuntimeError(f"torch.distributed backend {backend!r} is not available in "
                           f"this build of torch {torch.__version__}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        rank=int(os.environ["RANK"]) if rank is None else rank,
        world_size=int(os.environ["WORLD_SIZE"]) if world_size is None else world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return device


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if active():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def is_primary() -> bool:
    return rank() == 0


def barrier() -> None:
    if active():
        dist.barrier()


def all_reduce_(tensor: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Reduce ``tensor`` in place over the group (``op`` "sum" or "max");
    returns it. One process: the tensor as it is."""
    if active():
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX)
    return tensor


def _host_device() -> torch.device:
    """Where the group's collectives take a host value: the current card for
    NCCL, the CPU for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_host(values, op: str = "sum") -> np.ndarray:
    """A host array (int64 or float64) reduced over the group, as numpy;
    one collective. One process: the array as it is."""
    arr = np.asarray(values)
    if not active():
        return arr
    t = torch.from_numpy(np.array(arr)).to(_host_device())  # a copy: reduced in place
    return all_reduce_(t, op).cpu().numpy()


def all_gather_objects(obj: Any) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order (the reference's
    all_gather, pretrain_src/utils/distributed.py:91-131). One process:
    ``[obj]``."""
    if not active():
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def merge_results(list_of_lists: List[List[Any]], key: str = "instr_id") -> List[Any]:
    """Concatenate per-host prediction lists, de-duplicating on `key`
    (reference merge_dist_results, map_nav_src/utils/distributed.py:160-164)."""
    seen, out = set(), []
    for lst in list_of_lists:
        for item in lst:
            k = item.get(key) if isinstance(item, dict) else item
            if k not in seen:
                seen.add(k)
                out.append(item)
    return out
