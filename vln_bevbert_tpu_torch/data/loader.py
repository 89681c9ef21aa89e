"""Multi-task pretrain loading.

- ``MetaLoader``: samples which proxy task each step trains, from a
  *deterministic shared PRNG schedule* — every data-parallel host derives the
  same task for step t from (seed, t), replacing the reference's
  ``dist.broadcast(task_id, 0)`` synchronisation
  (reference pretrain_src/data/loader.py:54-59) with no collective.
- ``PretrainLoader``: per-task example sampling (end-viewpoint type ratios as
  in train_r2r.py:45-57) + static-shape batch assembly, with an optional
  background thread double-buffering host batch construction against device
  compute (the reference's PrefetchLoader role, loader.py:62-124).

Where CUDA is available and the batch is built in the process that made the
loader (its prefetch thread, or the caller), the collate allocates its
arrays in page-locked memory from PyTorch's caching host allocator
(``PinnedArrays``) and the batch holds those CPU tensors: the memory is
resident, so filling it faults in no page, and the dispatch copies from it
to the card without pinning a copy first. The allocator recycles a block
only once the copies queued from it have run. Elsewhere (the CPU, forked
workers, whose batches are pickled anyway) the batch holds numpy arrays.
The values are the same either way.

Spans (``utils/profiling.py``): ``loader.build`` around each batch's
construction, keyed by its step, on the thread that builds it, with its
children ``loader.items`` (the examples' ``get_input``) and
``loader.collate`` (``make_pretrain_batch``); ``loader.wait`` around the
consumer's wait for a built batch. Forked workers (``num_workers`` > 0)
build in other processes, whose spans the consumer's recorder never sees:
there only ``loader.wait`` is recorded.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..configs import ModelConfig, PretrainConfig, ShapeConfig
from ..parallel.mesh import shard_batch
from ..utils import profiling
from .batching import HostArrays, make_pretrain_batch
from .pathdata import TextPathData

#: a batch's host arrays: pinned CPU tensors or numpy arrays (module docstring)
HostBatch = Dict[str, Union[np.ndarray, torch.Tensor]]

# (pos_ratio, mid_ratio): end-vp is 'pos' w.p. pos_ratio, else 'neg_in_gt_path'
# up to mid_ratio, else 'neg_others' (ref SapDataset.__getitem__ tasks.py:318-326
# and the per-task ratios at train_r2r.py:45-57)
END_VP_POLICY = {
    "mlm": (0.75, 1.0),
    "mrc": (1.0, 1.0),
    "sap": (0.2, 0.6),
    "og": (1.0, 1.0),
    "sem": (0.2, 1.0),
    "masksem": (0.2, 1.0),
}


class PinnedArrays(HostArrays):
    """``make_pretrain_batch``'s arrays in page-locked memory from PyTorch's
    caching host allocator.

    ``empty`` returns a numpy view of a pinned tensor; ``tensors`` hands
    back the tensors that own the arrays. Those are the allocator's own
    tensors: a non-blocking copy from one records its event against the
    block, and the allocator hands the block out again only after the copy
    has run (a ``torch.from_numpy`` wrapper of the same memory would record
    nothing). ``copy`` runs on PyTorch's intra-op threads, which a forked
    worker may not use: only the process that made the loader collates
    here."""

    def __init__(self) -> None:
        self._owners: Dict[int, Tuple[np.ndarray, torch.Tensor]] = {}

    def empty(self, shape: Tuple[int, ...], dtype) -> np.ndarray:
        t = torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                        pin_memory=True)
        a = t.numpy()
        self._owners[id(a)] = (a, t)
        return a

    def copy(self, dst: np.ndarray, src: np.ndarray) -> None:
        torch.from_numpy(dst).copy_(torch.from_numpy(src))

    def tensors(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Each of ``arrays``, all from ``empty``, as the tensor that holds
        it."""
        return {key: self._owners[id(a)][1] for key, a in arrays.items()}


def pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of the host tensor ``t`` in a block of the caching host
    allocator."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


def sample_end_vp_type(task: str, rng: np.random.Generator) -> str:
    pos_ratio, mid_ratio = END_VP_POLICY[task.split("_")[0]]
    r = rng.uniform()
    if r < pos_ratio:
        return "pos"
    if r < mid_ratio:
        return "neg_in_gt_path"
    return "neg_others"


class MetaLoader:
    """Deterministic task schedule: task(step) = choice(tasks, p=mix) with a
    PRNG keyed by (seed, step).

    ``block_size`` > 1 samples the task once per block of consecutive steps
    (same marginal distribution as per-step i.i.d. sampling, since blocks are
    themselves i.i.d.). Switching between task executables has real cost on
    TPU runtimes (~90 ms/switch measured through this backend), so blocking
    is free throughput; block_size=1 reproduces the reference's per-step
    draw (pretrain_src/data/loader.py:54-59)."""

    def __init__(self, tasks: Sequence[str], mix_ratio: Sequence[float],
                 seed: int = 0, block_size: int = 1):
        assert len(tasks) == len(mix_ratio)
        self.tasks = list(tasks)
        p = np.asarray(mix_ratio, np.float64)
        self.p = p / p.sum()
        self.seed = seed
        self.block_size = max(int(block_size), 1)

    def task_for_step(self, step: int) -> str:
        rng = np.random.default_rng((self.seed, step // self.block_size))
        return self.tasks[int(rng.choice(len(self.tasks), p=self.p))]


class PretrainLoader:
    """Yields (task, static batch) tuples."""

    def __init__(
        self,
        nav_db: TextPathData,
        cfg: PretrainConfig,
        seed: int = 0,
        rank: int = 0,
        prefetch: int = 2,
        n_devices: int = 1,
        num_workers: int = 0,
        dp_rank: Optional[int] = None,
    ):
        """``cfg.train_batch_size`` is PER CHIP (matching the reference's
        per-GPU batch, configs/r2r_pretrain.json:8); the loader builds the
        global batch = per_chip x n_devices; with ``dp_rank`` it yields that
        data-parallel rank's rows of it (``parallel.mesh.shard_batch``). The
        global batch's draws run on every rank, so the ranks' batches,
        concatenated, are the global batch bit for bit. ``rank`` keys the
        draws, as in the JAX loader, and is the same on every dp rank.

        ``num_workers`` > 0 fans batch construction out over forked worker
        processes (the reference's DataLoader num_workers role,
        pretrain_src/data/loader.py:149-156) — batches are keyed by step so
        any worker count yields the identical stream. 0 keeps construction
        in-process (with the ``prefetch`` background thread)."""
        self.nav_db = nav_db
        self.cfg = cfg
        self.n_devices = max(int(n_devices), 1)
        if dp_rank is not None and not 0 <= dp_rank < self.n_devices:
            raise ValueError(f"dp_rank {dp_rank} outside {self.n_devices} devices")
        self.dp_rank = dp_rank
        self.meta = MetaLoader(
            cfg.tasks, cfg.mix_ratio, seed,
            block_size=getattr(cfg, "task_block_size", 1),
        )
        self.seed = seed
        self.rank = rank
        self.prefetch = prefetch
        self.num_workers = num_workers
        self._pid = os.getpid()

    @property
    def global_batch_size(self) -> int:
        return self.cfg.train_batch_size * self.n_devices

    def build_batch(
        self, step: int, task: Optional[str] = None
    ) -> Tuple[str, HostBatch]:
        with profiling.span("loader.build", key=step):
            return self._build_batch(step, task)

    def _build_batch(self, step: int, task: Optional[str]) -> Tuple[str, HostBatch]:
        if task is None:
            task = self.meta.task_for_step(step)
        base = task.split("_")[0]
        # per-step PRNG keying: batch(step) is a pure function of
        # (seed, rank, step), so parallel workers building different steps
        # produce the identical stream as sequential construction
        rng = np.random.default_rng((self.seed, self.rank, 17, step))
        idxs = rng.integers(0, len(self.nav_db), self.global_batch_size)
        with profiling.span("loader.items"):
            examples = [
                self.nav_db.get_input(
                    int(i),
                    sample_end_vp_type(task, rng),
                    rng,
                    return_act_label=base in ("sap", "sem", "masksem"),
                    return_obj_label=base == "og",
                    return_obj_probs=base == "mrc",
                )
                for i in idxs
            ]
        pinned = PinnedArrays() if self._pins() else None
        with profiling.span("loader.collate"):
            batch = make_pretrain_batch(
                examples, base, self.cfg.shapes, self.cfg.model, rng,
                mlm_prob=self.cfg.mlm_prob,
                bev_mrc_mask_prob=self.cfg.bev_mrc_mask_prob,
                obj_mrc_mask_prob=self.cfg.mrc_mask_prob,
                arrays=pinned or HostArrays(),
            )
        if pinned is not None:
            batch = pinned.tensors(batch)
        if self.dp_rank is not None:
            batch = shard_batch(batch, self.dp_rank, self.n_devices)
            if pinned is not None:
                # the rank's rows in blocks of their own, so that the global
                # batch's blocks go back to the allocator's cache
                batch = {k: pinned_copy(v) for k, v in batch.items()}
        return task, batch

    def _pins(self) -> bool:
        """Whether a batch built now goes to page-locked memory: CUDA is
        available and this is the process that made the loader (a forked
        worker may touch neither CUDA nor PyTorch's intra-op threads)."""
        return os.getpid() == self._pid and torch.cuda.is_available()

    def __iter__(self) -> Iterator[Tuple[str, HostBatch]]:
        if self.num_workers > 0:
            yield from self._iter_process_pool()
            return
        if self.prefetch <= 0:
            step = 0
            while True:
                yield self.build_batch(step)
                step += 1
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            step = 0
            while not stop.is_set():
                item = self.build_batch(step)
                # each batch is built once: it waits here for room, or the stop
                while not stop.is_set():
                    try:
                        q.put(item, timeout=1.0)
                        break
                    except queue.Full:
                        continue
                step += 1

        thread = threading.Thread(target=worker, name="loader-prefetch", daemon=True)
        thread.start()
        try:
            while True:
                with profiling.span("loader.wait"):
                    item = q.get()
                yield item
        finally:
            stop.set()

    def _iter_process_pool(self) -> Iterator[Tuple[str, HostBatch]]:
        """Forked worker processes build whole batches round-robin by step
        (worker w owns steps w, w+N, ...); the parent re-orders by step id.
        Real TPU VM hosts have ~100 vCPUs against this pipeline's single-core
        build cost — example synthesis is the pretrain host bottleneck
        (SURVEY 3.1 'h5py reads in workers')."""
        import multiprocessing as mp

        ctx = mp.get_context("fork")
        n = self.num_workers
        depth = max(self.prefetch, 1)
        out_q = ctx.Queue(maxsize=n * depth)
        stop_ev = ctx.Event()

        def worker(wid: int):
            step = wid
            while not stop_ev.is_set():
                task, batch = self.build_batch(step)
                out_q.put((step, task, batch))
                step += n

        procs = [
            ctx.Process(target=worker, args=(w,), daemon=True) for w in range(n)
        ]
        for p in procs:
            p.start()
        pending: Dict[int, Tuple[str, HostBatch]] = {}
        step = 0
        try:
            while True:
                while step not in pending:
                    with profiling.span("loader.wait"):
                        s, task, batch = out_q.get()
                    pending[s] = (task, batch)
                yield pending.pop(step)
                step += 1
        finally:
            stop_ev.set()
            for p in procs:
                p.terminate()
            for p in procs:
                p.join(timeout=2.0)


def make_synthetic_object_world(
    graphs, rng: np.random.Generator, n_items: int = 16,
    objects_per_vp: int = 2, obj_feat_size: int = 768, obj_prob_size: int = 1000,
):
    """REVERIE-style synthetic fixtures: per-viewpoint object records, the
    obj2vps goal table, and annotations with pos_vps / objId / obj pseudo
    labels (covers both REVERIE and SOON input schemas)."""
    obj_data, obj2vps = {}, {}
    oid = 0
    for scan, g in graphs.items():
        for vp in g.node_ids:
            ids = [str(oid + k) for k in range(objects_per_vp)]
            oid += objects_per_vp
            obj_data[f"{scan}_{vp}"] = {
                "fts": rng.normal(
                    size=(objects_per_vp, obj_feat_size + obj_prob_size)
                ).astype(np.float32),
                "directions": rng.uniform(-1, 1, (objects_per_vp, 2)).astype(np.float32),
                "sizes": rng.uniform(20, 120, (objects_per_vp, 2)).astype(np.float32),
                "obj_ids": ids,
            }
            for i in ids:
                obj2vps[f"{scan}_{i}"] = [vp]
    annos = make_synthetic_annotations(graphs, rng, n_items=n_items)
    for a in annos:
        scan, goal = a["scan"], a["path"][-1]
        objid = obj_data[f"{scan}_{goal}"]["obj_ids"][0]
        a["objId"] = objid
        a["pos_vps"] = obj2vps[f"{scan}_{objid}"]
        a["instr_id"] = f"{a['instr_id'].split('_')[0]}_{objid}_0"
        a["obj_pseudo_label"] = {"idx": 0}
    return annos, obj_data, obj2vps


def make_synthetic_annotations(
    graphs, rng: np.random.Generator, n_items: int = 32,
    min_len: int = 3, max_len: int = 7, txt_len=(10, 40),
    vocab_range=(1996, 29611),
) -> list:
    """Random R2R-style annotation items over synthetic scans: a shortest
    path between two random nodes + a random 'instruction' encoding."""
    items = []
    scans = list(graphs)
    for i in range(n_items):
        scan = scans[int(rng.integers(len(scans)))]
        g = graphs[scan]
        for _ in range(20):
            a, b = rng.choice(len(g), 2, replace=False)
            path = g.path(g.node_ids[a], g.node_ids[b])
            if min_len <= len(path) <= max_len:
                break
        enc = [101] + list(
            rng.integers(vocab_range[0], vocab_range[1], int(rng.integers(*txt_len)))
        ) + [102]
        items.append(
            {
                "instr_id": f"synt_{i}",
                "scan": scan,
                "path": path,
                "heading": float(rng.uniform(0, 2 * np.pi)),
                "instr_encoding": enc,
            }
        )
    return items
