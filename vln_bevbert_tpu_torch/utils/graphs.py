"""CUDA-graph capture and replay of training steps.

The JAX package takes per-step host dispatch out of its hot loops by
compiling K steps into one ``lax.scan`` program (``make_pretrain_block_step``,
``make_replay_block``); XLA caches one compiled
program per static signature. Here one step is captured into a CUDA graph
once per key and replayed once per step, and ``GraphCache`` is that
program cache:

- **static inputs**: one set of device buffers per batch signature (keys,
  shapes, dtypes); each step's batch is copied into them outside the graph,
  host arrays through pinned memory with ``non_blocking``, so a copy queues
  behind the previous replay on the same stream;
- **warm-up**: before a capture the step runs once eagerly on a side stream
  (cuBLAS workspaces, the autograd engine, NCCL communicators and the
  kernels' library start there), then every tensor the step writes and
  every generator it draws from is restored, so the graphed run starts
  where the eager run would;
- **generators**: each generator the step draws from (the dropout seeds
  come from a custom CUDA generator) is registered with the graph, so that
  every replay draws anew, as eager steps do; the generator's offset moves
  by the graph's draws at each replay;
- **one memory pool** shared by every graph of the cache (they replay one
  at a time, on one stream);
- a least-recently-used cache of graphs keyed by the caller (task, input
  signature, accumulation phase), bounded by the most keys its caller can
  make (``max_graphs``; the pretraining block's comes from its config), so
  that eviction only limits a caller that feeds more shapes than it said;
- **counters**: ``captures``, ``replays``, ``evictions``, ``capture_ms``;
  ``staged_bytes``, the host bytes copied into static inputs, and
  ``staged_pinned_bytes``, those of them already page-locked;
- **spans** (``utils/profiling.py``): ``graphs.stage`` (a batch's copy into
  the static inputs, pinning included), ``graphs.replay``,
  ``graphs.capture`` (warm-up and capture).

Whether a step is graphed at all is ``capturable``'s answer, asked by the
block steps at every call: a CUDA device, and no process group or an NCCL
one (gloo's collectives on CUDA tensors cannot be captured). Where it says
no, the block steps run eagerly; ``GraphCache.step`` raises
(``check_capturable``). A capture that fails raises and names its key;
nothing falls back to eager steps after it.

The kernels count their own launches on the device (``_build.launches``),
so replays are counted where they run and a capture counts nothing. A count
kept in Python (calls of a hooked function) runs only while the step is
captured: ``CallCount`` keeps the calls a capture made and adds them at each
replay of that graph.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, Dict, Hashable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import distributed
from . import profiling

#: the graph being captured, or None. A module global, not a context
#: variable: the autograd engine runs a CUDA backward on its own thread
_CAPTURING: Optional["Graph"] = None


class CallCount:
    """A count of calls that sees graph replays: ``add`` during a capture
    counts once per replay of the captured graph instead."""

    def __init__(self) -> None:
        self.value = 0

    def add(self, n: int = 1) -> None:
        if _CAPTURING is not None:
            _CAPTURING.tally[self] = _CAPTURING.tally.get(self, 0) + n
        else:
            self.value += n


def capturable(device: torch.device) -> bool:
    """Whether a step on ``device`` can be captured into a CUDA graph: the
    device is CUDA, and a process group, if this process is in one, runs
    NCCL's collectives."""
    return device.type == "cuda" and (not distributed.active() or dist.get_backend() == "nccl")


def check_capturable(device: torch.device) -> None:
    """Raise unless ``capturable(device)``."""
    if not capturable(device):
        backend = dist.get_backend() if distributed.active() else None
        raise RuntimeError(f"a CUDA graph cannot capture a step on {device}"
                           + (f" under a {backend} process group" if backend else ""))


def signature(batch: Mapping[str, Any]) -> tuple:
    """(key, shape, dtype) of every entry, sorted: what a graph's static
    inputs are made for. A numpy array and a tensor of one dtype give one
    name (``float16``, not ``torch.float16``)."""
    return tuple(sorted((k, tuple(v.shape), str(v.dtype).removeprefix("torch."))
                        for k, v in batch.items()))


def _host_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    return torch.from_numpy(np.ascontiguousarray(value))


class Graph:
    """One captured step: the graph, its static inputs and outputs, and the
    ``CallCount`` calls its capture made, added at every replay."""

    def __init__(self, cache: "GraphCache", key: Hashable, inputs: Dict[str, torch.Tensor]):
        self.cache = cache
        self.key = key
        self.inputs = inputs
        self.graph = torch.cuda.CUDAGraph()
        self.outputs: Any = None
        self.tally: Dict[CallCount, int] = {}

    def replay(self) -> Any:
        """Run the captured step once on the current stream; returns the
        static outputs, overwritten by the next replay."""
        with profiling.span("graphs.replay"):
            self.graph.replay()
        for count, n in self.tally.items():
            count.value += n
        self.cache.replays += 1
        return self.outputs


class GraphCache:
    """Graphs by key, at most ``max_graphs`` (None: no bound; the least
    recently used first out, an evicted key captured again at its next
    use), over one memory pool."""

    def __init__(self, max_graphs: Optional[int] = None):
        if max_graphs is not None and max_graphs < 1:
            raise ValueError(f"max_graphs {max_graphs} < 1")
        self.max_graphs = max_graphs
        self.graphs: "collections.OrderedDict[Hashable, Graph]" = collections.OrderedDict()
        self.inputs: Dict[tuple, Dict[str, torch.Tensor]] = {}  # by batch signature
        self.pool = None
        self.captures = 0
        self.replays = 0
        self.evictions = 0
        self.capture_ms = 0.0
        self.staged_bytes = 0
        self.staged_pinned_bytes = 0

    def inputs_for(self, batch: Mapping[str, Any], device: torch.device
                   ) -> Dict[str, torch.Tensor]:
        """Static input buffers for ``batch``'s signature, shared by every
        graph made for it."""
        sig = signature(batch)
        if sig not in self.inputs:
            self.inputs[sig] = {k: torch.empty(tuple(v.shape), dtype=_host_tensor(v).dtype,
                                               device=device) for k, v in batch.items()}
        return self.inputs[sig]

    def load(self, inputs: Dict[str, torch.Tensor], batch: Mapping[str, Any]) -> None:
        """Copy ``batch`` into the static ``inputs``, queued on the current
        stream. A host tensor already page-locked (the loader's batches on a
        card) is copied from as it lies, so the host allocator records the
        copy against its block; other host data bound for the card is pinned
        first, a copy on this thread; device tensors are copied as they lie."""
        with profiling.span("graphs.stage"):
            for key, dst in inputs.items():
                src = _host_tensor(batch[key])
                if src.device.type == "cpu":
                    size = src.numel() * src.element_size()
                    self.staged_bytes += size
                    if src.is_pinned():
                        self.staged_pinned_bytes += size
                    elif dst.is_cuda:
                        src = src.pin_memory()
                dst.copy_(src, non_blocking=True)

    def get(self, key: Hashable) -> Optional[Graph]:
        graph = self.graphs.get(key)
        if graph is not None:
            self.graphs.move_to_end(key)
        return graph

    def step(self, key: Hashable, batch: Mapping[str, Any], device: torch.device,
             fn: Callable[[Dict[str, torch.Tensor]], Any], state: Sequence[torch.Tensor] = (),
             generators: Sequence[torch.Generator] = (), loaded: Optional[set] = None) -> Any:
        """One replay of the graph under ``key`` (captured from
        ``fn(static inputs)`` at first use) on ``batch``, which is copied into
        the static inputs first unless ``loaded``, a set the caller keeps
        while it feeds one batch, says they hold it already. Returns the
        static outputs. Raises where the step cannot be captured
        (``check_capturable``)."""
        check_capturable(device)
        graph = self.get(key)
        if graph is None:
            inputs = self.inputs_for(batch, device)
            self.load(inputs, batch)
            graph = self.capture(key, inputs, lambda: fn(inputs), state, generators)
        elif loaded is None or id(graph.inputs) not in loaded:
            self.load(graph.inputs, batch)
        if loaded is not None:
            loaded.add(id(graph.inputs))
        return graph.replay()

    def capture(self, key: Hashable, inputs: Dict[str, torch.Tensor], fn: Callable[[], Any],
                state: Sequence[torch.Tensor] = (),
                generators: Sequence[torch.Generator] = ()) -> Graph:
        """Warm ``fn`` up once, restore ``state`` (every tensor ``fn``
        writes) and ``generators``, then capture ``fn`` (which reads
        ``inputs``) under ``key``; its return value becomes the graph's
        static outputs."""
        with profiling.span("graphs.capture"):
            return self._capture(key, inputs, fn, state, generators)

    def _capture(self, key: Hashable, inputs: Dict[str, torch.Tensor], fn: Callable[[], Any],
                 state: Sequence[torch.Tensor], generators: Sequence[torch.Generator]) -> Graph:
        global _CAPTURING
        device = next(iter(inputs.values())).device
        t0 = time.perf_counter()
        saved = [t.detach().clone() for t in state]
        gen_states = [g.get_state() for g in generators]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        try:
            with torch.cuda.stream(side):
                fn()
        except Exception as err:
            raise RuntimeError(f"the warm-up before capturing {key!r} failed: {err}") from err
        torch.cuda.current_stream(device).wait_stream(side)
        with torch.no_grad():
            for dst, src in zip(state, saved):
                dst.copy_(src)
        for gen, st in zip(generators, gen_states):
            gen.set_state(st)
        del saved
        graph = Graph(self, key, inputs)
        for gen in generators:
            graph.graph.register_generator_state(gen)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        _CAPTURING = graph
        try:
            # thread-local: the loader's and NCCL's watchdog threads go on
            # while the capturing thread and autograd's queue the step
            with torch.cuda.graph(graph.graph, pool=self.pool, stream=side,
                                  capture_error_mode="thread_local"):
                graph.outputs = fn()
        except Exception as err:
            raise RuntimeError(f"CUDA graph capture of {key!r} failed: {err}") from err
        finally:
            _CAPTURING = None
        torch.cuda.synchronize(device)
        self.capture_ms += 1e3 * (time.perf_counter() - t0)
        self.captures += 1
        self.graphs[key] = graph
        if self.max_graphs is not None and len(self.graphs) > self.max_graphs:
            self.graphs.popitem(last=False)
            self.evictions += 1
            live = {id(g.inputs) for g in self.graphs.values()}
            self.inputs = {k: v for k, v in self.inputs.items() if id(v) in live}
        return graph

    def counters(self) -> Dict[str, float]:
        return {"captures": self.captures, "replays": self.replays,
                "evictions": self.evictions, "capture_ms": self.capture_ms,
                "graphs": len(self.graphs), "staged_bytes": self.staged_bytes,
                "staged_pinned_bytes": self.staged_pinned_bytes}

