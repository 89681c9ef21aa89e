"""Subprocess vector-env pool for continuous environments (host copy of
``vln_bevbert_tpu/ce/env_pool.py``).

Role of the reference's habitat ``VectorEnv`` construction
(bevbert_ce/vlnce_baselines/common/env_utils.py:35-126 —
NUM_ENVIRONMENTS=8 subprocess workers per rank, scenes split across workers):
simulator stepping and sensor synthesis run in worker processes so the
trainer's host thread (graph bookkeeping, batching) and the device pipeline
are not serialised behind the sim.

Design: each worker owns a contiguous range of the pool's episode slots and
hosts one inner env (any object exposing the ``SyntheticContinuousEnv``
surface — the synthetic world or a habitat binding). The pool presents the
*same* surface, so ``CEAgent`` runs on either unchanged. Slot-routed calls
fan out over pipes and gather; ``begin_observations``/``end_observations``
split the RPC so sensor work overlaps with device compute (the rollout calls
begin_ right after acting, end_ when it needs the next step's inputs).

Workers never touch CUDA: a worker imports only the port's host env
(``ce/env.py``, numpy), and spawn starts it in a fresh interpreter, so no
CUDA state of the parent is inherited.
"""

from __future__ import annotations

import multiprocessing as mp
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

_SLOT_METHODS = {
    "teleport", "stop", "rotate", "forward_step", "previous_step_collided",
    "geodesic", "dist_to_goal", "dists_to_goal", "eval_episode",
}


def _worker_loop(conn, factory: Callable[[], Any]):
    env = factory()
    try:
        while True:
            msg = conn.recv()
            cmd = msg[0]
            if cmd == "close":
                break
            try:
                if cmd == "call":
                    _, name, args, kwargs = msg
                    out = getattr(env, name)(*args, **kwargs)
                elif cmd == "attr":
                    out = getattr(env, msg[1])
                else:
                    raise ValueError(f"unknown command {cmd!r}")
                conn.send(("ok", out))
            except Exception as e:  # surface worker errors to the pool
                conn.send(("err", f"{type(e).__name__}: {e}"))
    finally:
        conn.close()


class WorkerHandle:
    def __init__(self, proc, conn, n_slots: int):
        self.proc = proc
        self.conn = conn
        self.n_slots = n_slots
        self.pending = 0

    def send(self, *msg):
        self.conn.send(msg)
        self.pending += 1

    def recv(self):
        status, out = self.conn.recv()
        self.pending -= 1
        if status == "err":
            raise RuntimeError(f"env worker failed: {out}")
        return out


class SubprocVectorEnv:
    """N worker processes x (batch/N) slots each, same surface as the inner
    env. ``factories`` build one inner env per worker (episodes pre-split
    by the caller, mirroring env_utils' scene split)."""

    def __init__(self, factories: Sequence[Callable[[], Any]], slots_per_worker: int,
                 batch_size: Optional[int] = None, split_size: Optional[int] = None):
        """Workers are spawned in fresh interpreters: once torch has
        initialised CUDA in the parent, a forked child cannot use the parent's
        CUDA context, and fork of a multithreaded process can deadlock.
        Factories must therefore be picklable. A data-parallel rank's pool
        hosts some of the workers of the global pool: ``batch_size`` and
        ``split_size`` are then the global pool's batch and episode count
        (by default its own)."""
        ctx = mp.get_context("spawn")
        self.workers: List[WorkerHandle] = []
        for factory in factories:
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=_worker_loop, args=(child, factory), daemon=True
            )
            proc.start()
            child.close()
            self.workers.append(WorkerHandle(proc, parent, slots_per_worker))
        self.slots_per_worker = slots_per_worker
        self.batch_size = batch_size or slots_per_worker * len(self.workers)
        self._split_size = split_size
        # mirror static attrs from worker 0's env
        for name in ("num_views", "grid_hw", "grid_feat_size",
                     "view_feat_size", "depth_feat_shape", "turn_unit",
                     "forward_unit"):
            setattr(self, name, self._attr(0, name))
        self._obs_inflight = False

    # ----------------------------------------------------------------- RPC
    def _attr(self, w: int, name: str):
        self.workers[w].send("attr", name)
        return self.workers[w].recv()

    def _route(self, slot: int):
        return divmod(slot, self.slots_per_worker)

    def _assert_no_inflight(self):
        # every RPC path must fail loudly while observation replies are
        # pending: a second request would mis-pair pipe messages and recv()
        # would silently return the observation payload
        assert not self._obs_inflight, (
            "RPC while observations are in flight — call "
            "end_observations() first (pipe messages would interleave)"
        )

    def _call_all(self, name: str, *args, **kwargs) -> List[Any]:
        self._assert_no_inflight()
        for w in self.workers:
            w.send("call", name, args, kwargs)
        return [w.recv() for w in self.workers]

    def __getattr__(self, name: str):
        # slot-routed passthrough for the control/oracle surface
        if name in _SLOT_METHODS:
            def call(slot, *args, **kwargs):
                self._assert_no_inflight()
                w, local = self._route(slot)
                self.workers[w].send("call", name, (local, *args), kwargs)
                return self.workers[w].recv()

            return call
        raise AttributeError(name)

    # ------------------------------------------------------------- surface
    def size(self) -> int:
        """The split's episode count (the global pool's, on a rank)."""
        own = sum(self._call_all("size"))
        return self._split_size or own

    def reset_epoch(self):
        self._call_all("reset_epoch")

    def reset(self) -> List[dict]:
        obs = self._call_all("reset")
        return [ob for chunk in obs for ob in chunk]

    def begin_observations(self):
        """Dispatch sensor synthesis to all workers without waiting."""
        if not self._obs_inflight:
            for w in self.workers:
                w.send("call", "observations", (), {})
            self._obs_inflight = True

    def end_observations(self) -> List[dict]:
        self.begin_observations()
        self._obs_inflight = False
        return [ob for w in self.workers for ob in w.recv()]

    def observations(self) -> List[dict]:
        return self.end_observations()

    @property
    def headings(self) -> np.ndarray:
        return np.concatenate(
            [np.asarray(h) for h in self._call_all("get_headings")]
        )

    @property
    def positions(self) -> np.ndarray:
        return np.concatenate(
            [np.asarray(p) for p in self._call_all("get_positions")], axis=0
        )

    @property
    def batch(self):
        return [ep for chunk in self._call_all("get_batch") for ep in chunk]

    def close(self):
        for w in self.workers:
            try:
                w.conn.send(("close",))
                w.conn.close()
            except (BrokenPipeError, OSError):
                pass
        for w in self.workers:
            w.proc.join(timeout=5)
            if w.proc.is_alive():
                w.proc.terminate()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _SyntheticEnvFactory:
    """Picklable worker factory (spawn-safe)."""

    def __init__(self, episodes, batch_size, seed, env_kwargs):
        self.episodes = episodes
        self.batch_size = batch_size
        self.seed = seed
        self.env_kwargs = env_kwargs

    def __call__(self):
        from .env import SyntheticContinuousEnv

        return SyntheticContinuousEnv(
            self.episodes, batch_size=self.batch_size, seed=self.seed, **self.env_kwargs,
        )


def make_synthetic_pool(episodes, num_workers: int, slots_per_worker: int,
                        seed: int = 0, rank: int = 0, world: int = 1,
                        **env_kwargs) -> SubprocVectorEnv:
    """Split episodes across workers (strided, like env_utils' scene split)
    and build a SubprocVectorEnv of SyntheticContinuousEnv workers;
    ``env_kwargs`` go to every worker's env.

    ``num_workers`` is the global pool's. Under data parallelism rank
    ``rank`` of ``world`` hosts workers ``[rank * n, (rank + 1) * n)``, n =
    ``num_workers / world``, each with its own episodes, seed and slots, so
    that its rows are the global pool's rows of those workers (slots lie in
    worker order)."""
    if num_workers % world or not 0 <= rank < world:
        raise ValueError(f"rank {rank} of {world} cannot host a share of {num_workers} "
                         "env workers")
    episodes = list(episodes)
    subsets = [episodes[w::num_workers] or episodes for w in range(num_workers)]
    n = num_workers // world
    factories = [
        _SyntheticEnvFactory(subsets[w], slots_per_worker, seed + w, env_kwargs)
        for w in range(rank * n, (rank + 1) * n)
    ]
    return SubprocVectorEnv(factories, slots_per_worker,
                            batch_size=slots_per_worker * num_workers,
                            split_size=sum(len(s) for s in subsets))
