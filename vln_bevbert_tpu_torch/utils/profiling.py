"""Profiling and tracing hooks (port of ``vln_bevbert_tpu/utils/profiling.py``).

- ``trace``: ``torch.profiler`` over the block, host and (with a card) CUDA
  activities, its Chrome trace written into ``log_dir`` (view in Perfetto or
  ``chrome://tracing``); the block gets the profiler, whose ``events()`` and
  ``key_averages()`` stay readable after it;
- ``span``: a named host span at a layer boundary, kept by the recorder
  that ``recording`` installs and, while a profiler runs, shown in its trace
  as a ``record_function`` range;
- ``device_phase``: a stamp of the device's clock on the current stream,
  also inside a CUDA graph, so that a graph's replays time their phases on
  the card;
- ``recording``: installs the one process-wide ``Recorder`` of spans and
  phases. Without it ``span`` and ``device_phase`` do nothing.

Host spans are stamped with ``time.time_ns()``, the clock that
``torch.profiler``'s device trace counts from
(``kineto_results.trace_start_ns()``), so a span lines up with the device
activity of the same moment. Device stamps are put on that clock through
one stamp taken while the host waits, when the recorder starts.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

#: the installed ``Recorder``, or ``_ANNOTATIONS`` inside ``trace`` when none
#: is, or None: what ``span`` hands its spans to
_TARGET = None
_NULL = contextlib.nullcontext()
#: device phase names by stamp id, for every recorder of the process: a
#: graph keeps the ids it was captured with (0 ends the open phase)
_PHASE_IDS: Dict[Optional[str], int] = {None: 0}
#: a recorder keeps the first this many closed spans; its totals count all
MAX_SPANS = 100_000


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profile the block; on exit write ``trace_<pid>_<n>.json`` into
    ``log_dir`` (its path is then ``prof.trace_path``). ``span``s inside
    show in it, with or without a recorder."""
    global _TARGET
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    outer = _TARGET
    if outer is None:
        _TARGET = _ANNOTATIONS
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        if outer is None and _TARGET is _ANNOTATIONS:
            _TARGET = None
    n = sum(f.startswith(f"trace_{os.getpid()}_") for f in os.listdir(log_dir))
    prof.trace_path = os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json")
    prof.export_chrome_trace(prof.trace_path)


def span(name: str, key: Optional[int] = None):
    """A context manager timing the block as the span ``name`` (``key``: a
    block's first step, a batch's loader step). With no recorder installed
    it is one shared null context, after one global check. Inside a CUDA
    graph's capture, on the threads that queue the captured work, it records
    nothing: a host span there would run once, at capture, and not at the
    replays. The span closes, and is kept, when an exception leaves it."""
    target = _TARGET
    if target is None:
        return _NULL
    return target.span(name, key)


def device_phase(name: Optional[str], device: torch.device) -> None:
    """Stamp the start of the phase ``name`` (None: the end of the open
    phase) on ``device``'s current stream: a one-thread kernel writes the
    device's clock into a ring in device memory, so that a stamp captured
    into a CUDA graph writes anew at every replay. Only while a recorder
    with device phases is installed (``recording(device=...)``) and
    ``device`` is a CUDA device; otherwise nothing happens and the kernels'
    library is not loaded."""
    target = _TARGET
    if target is None or target.device is None or device.type != "cuda":
        return
    target.stamp(name)


class Span(NamedTuple):
    """One closed span: times in ns of ``time.time_ns()``; ``self_ns`` its
    length less what its child spans cover; ``parent`` the ``id`` of the
    span open around it on its thread."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    self_ns: int
    thread: str
    parent: Optional[int]
    key: Optional[int]


@dataclass
class Total:
    """A span name's calls, seconds and self seconds, exact past the bound
    on kept spans."""

    count: int = 0
    seconds: float = 0.0
    self_seconds: float = 0.0


class _Open:
    """A span while it is open (the recorder's context manager)."""

    __slots__ = ("rec", "name", "key", "id", "parent", "start", "child_ns", "annotation")

    def __init__(self, rec: "Recorder", name: str, key: Optional[int]):
        self.rec, self.name, self.key = rec, name, key
        self.child_ns = 0
        self.annotation = None

    def __enter__(self):
        stack = self.rec._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(self.rec._ids)
        stack.append(self)
        if torch.autograd._profiler_enabled():
            self.annotation = record_function(self.name)
            self.annotation.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        self.rec._stack().pop()
        length = end - self.start
        if self.parent is not None:
            self.parent.child_ns += length
        self.rec._close(Span(self.id, self.name, self.start, end, length - self.child_ns,
                             threading.current_thread().name,
                             None if self.parent is None else self.parent.id, self.key))
        return False


class _Annotations:
    """``span``'s target inside ``trace`` with no recorder: a
    ``record_function`` range, nothing kept."""

    device = None

    @staticmethod
    def span(name: str, key: Optional[int]):
        return record_function(name)


_ANNOTATIONS = _Annotations()


class Recorder:
    """Spans of every thread and device phases, kept in memory.

    - ``spans``: the first ``MAX_SPANS`` closed spans, in the order they
      closed; ``totals`` by name (``Total``) count every span; ``dropped``
      the spans past the bound;
    - ``phases``: per device phase, the seconds of each stamped occurrence
      (one per step of a stamped graph's replays), from ``harvest``;
      ``phase_spans`` the same as (name, start, end) in ns of the host clock;
      ``overflow`` the stamps the device's ring lost (a harvest came more
      than its 65,536 stamps late).

    Spans of forked worker processes (``PretrainLoader``'s ``num_workers``)
    stay in those processes: only this process's threads are recorded.
    """

    def __init__(self, device: Optional[torch.device] = None):
        self.device = None if device is None or device.type != "cuda" else device
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()
        self.clear()
        if self.device is not None:
            self._sync_clocks()

    def clear(self) -> None:
        """Forget every span and phase so far, stamps in flight included
        (spans open now are kept when they close)."""
        with self._lock:
            self.spans: List[Span] = []
            self.totals: Dict[str, Total] = {}
            self.dropped = 0
        self.phases: Dict[str, List[float]] = {}
        self.phase_spans: List[tuple] = []
        self.overflow = 0
        self._open_phase = None
        if self.device is not None:
            self._read_stamps()

    # ------------------------------------------------------------ host spans
    def span(self, name: str, key: Optional[int] = None):
        if _capturing():
            return _NULL
        return _Open(self, name, key)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _close(self, s: Span) -> None:
        with self._lock:
            total = self.totals.get(s.name)
            if total is None:
                total = self.totals[s.name] = Total()
            total.count += 1
            total.seconds += (s.end_ns - s.start_ns) * 1e-9
            total.self_seconds += s.self_ns * 1e-9
            if len(self.spans) < MAX_SPANS:
                self.spans.append(s)
            else:
                self.dropped += 1

    def named(self, name: str) -> List[Span]:
        """The kept spans called ``name``."""
        return [s for s in self.spans if s.name == name]

    # --------------------------------------------------------- device phases
    def stamp(self, name: Optional[str]) -> None:
        from .. import _build

        ident = _PHASE_IDS.setdefault(name, len(_PHASE_IDS))
        _build.load().stamp(ident)

    def _read_stamps(self) -> list:
        """The stamps since the last read as (id, device ns), oldest first,
        the ring emptied; adds what it lost to ``overflow``. Waits for the
        device."""
        from .. import _build

        with torch.cuda.device(self.device):
            slots, head = _build.load().stamps(True)
        self.overflow += max(head - slots.shape[0], 0)
        return [tuple(r) for r in slots.tolist()]

    def _sync_clocks(self) -> None:
        """The host clock's ns less the device clock's, from one stamp taken
        while the host waits (``clock_error_ns``: half the wait)."""
        with torch.cuda.device(self.device):
            torch.cuda.synchronize()
            t0 = time.time_ns()
            self.stamp(None)
            torch.cuda.synchronize()
            t1 = time.time_ns()
        ((_, t_dev),) = self._read_stamps()
        self.clock_offset_ns = (t0 + t1) // 2 - t_dev
        self.clock_error_ns = (t1 - t0) // 2

    def harvest(self) -> Dict[str, List[float]]:
        """Fold the device's stamps into ``phases`` and ``phase_spans``
        (each phase ends at the next stamp); returns ``phases``. Waits for
        the device. Nothing without device phases."""
        if self.device is None:
            return self.phases
        names = {i: n for n, i in _PHASE_IDS.items()}
        for ident, t in self._read_stamps():
            if self._open_phase is not None:
                name, t_open = self._open_phase
                self.phases.setdefault(name, []).append((t - t_open) * 1e-9)
                self.phase_spans.append((name, t_open + self.clock_offset_ns,
                                         t + self.clock_offset_ns))
            self._open_phase = None if ident == 0 else (names[ident], t)
        return self.phases


def _capturing() -> bool:
    """Whether this thread queues work into a CUDA graph being captured."""
    from . import graphs

    return graphs._CAPTURING is not None and torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def recording(device: Optional[torch.device] = None) -> Iterator[Recorder]:
    """Install a ``Recorder`` for the block: ``span``s of every thread of the
    process and, with a CUDA ``device``, the ``device_phase`` stamps of every
    step queued there, graphs captured meanwhile included (a graph captured
    with no recorder carries no stamp). Its phases are harvested on exit.
    Raises inside another ``recording``."""
    global _TARGET
    if isinstance(_TARGET, Recorder):
        raise RuntimeError("a recorder is installed already: recordings do not nest")
    outer = _TARGET
    rec = Recorder(device)
    _TARGET = rec
    try:
        yield rec
    finally:
        _TARGET = outer
        rec.harvest()
