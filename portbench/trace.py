"""The traced window: ``torch.profiler`` over the card's activity only (kernels,
copies, sets), kept in memory and reduced before the run ends; nothing is
written to disk.

- ``busy_s``: the union of the device intervals (a ``record_function``
  span's device-side annotation is left out), copied from
  ``vln_bevbert_tpu_torch/cli/profile_eval.py:device_busy_us``;
- ``kernel_s``: device seconds of the kernels whose name holds a pattern;
- ``breakdown``: the ten device ops that took most time, and the ten longest
  idle gaps, each named by the host span that was open across it.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

KERNELS = {"dropout": ("dropout_kernel",), "splat": ("splat_hist_kernel", "splat_scatter_kernel",
                                                     "splat_reduce_kernel")}


class Timeline:
    """Host spans on the wall clock (ns since the epoch, the profiler's)."""

    def __init__(self):
        self.spans: List[Tuple[str, int, int]] = []
        self.on = False

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))


def _device_events(prof) -> list:
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _union(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(covered length, gaps between the covered stretches)."""
    busy, reach, gaps = 0.0, None, []
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            if reach is not None:
                gaps.append((reach, start))
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    return busy, gaps


def reduce(prof, timeline: Timeline, window_s: float) -> Dict[str, object]:
    """Busy seconds, device seconds by kernel family, and the breakdown."""
    events = _device_events(prof)
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    busy_us, gaps = _union(spans)
    by_name: Dict[str, float] = defaultdict(float)
    for e in events:
        by_name[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    kernel_s = {fam: sum(s for n, s in by_name.items() if any(p in n for p in pats))
                for fam, pats in KERNELS.items()}
    start_ns = prof.profiler.kineto_results.trace_start_ns()

    def host_at(t0_us: float, t1_us: float) -> str:
        a, b = start_ns + t0_us * 1e3, start_ns + t1_us * 1e3
        best, overlap = "no host span", 0.0
        for name, s0, s1 in timeline.spans:
            o = min(b, s1) - max(a, s0)
            if o > overlap:
                best, overlap = name, o
        return best

    gaps = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:10]
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": window_s,
        "kernel_s": kernel_s,
        "breakdown": {
            "device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[host_at(a, b), (b - a) * 1e-6] for a, b in gaps],
        },
    }


def start(device: torch.device) -> profile:
    """A profiler of the card's activity, started once the card is idle."""
    torch.cuda.synchronize(device)
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof
