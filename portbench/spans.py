"""The program's own spans, device phases and graph captures in one run of a
pretraining cell, read as the benchmark will read them once its job enters
``profiling.recording`` itself (``vln_bevbert_tpu_torch/utils/profiling.py``).

    python3 -m portbench.spans --workload r2r_pretrain.mix --seed <n> --seconds 51 \\
        --trace 1 [--out <file.json>]

It runs ``portbench.run`` with a recorder installed before set-up, so the
graphs captured there carry the device stamps, and cleared when the window
opens (``Window.open``), so that its figures are the window's; with
``--trace 1`` it keeps the traced blocks' device intervals as
``trace.reduce`` sees them. The run's own result line
is printed as ever; then one JSON object (also written to ``--out``):

- ``window``: per window step or per call, the spans' milliseconds
  (``window_figures``), each span name's calls, the device phases'
  milliseconds per stamped step, ``graph_captures`` (``graphs.capture``
  spans in the window), the ring's ``overflow`` and the spans past the
  recorder's bound (``dropped``);
- ``traced``: the traced blocks' busy and host-to-device copy milliseconds
  per stamped step, their phases' milliseconds per step, and the ten
  longest idle gaps, each named by the program's spans on the trainer's
  thread under both rules of ``name_gap``, beside the harness's own name.

Nothing of this is a metric of ``BENCHMARK.json`` yet: the job and
``trace.reduce`` do not enter a recorder. The functions here are what they
would call.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

from . import harness, run, trace as tr

#: spans read per window step, and per call
PER_STEP = {"loader_wait": "loader.wait", "stage": "graphs.stage", "replay": "graphs.replay",
            "block_step": "block_step", "readback": "trainer.readback"}
PER_CALL = {"loader_build": "loader.build", "loader_items": "loader.items",
            "loader_collate": "loader.collate"}


def window_figures(rec, steps: int) -> Dict[str, object]:
    """The window's figures from a recorder cleared when it opened and
    harvested, over the ``steps`` it trained."""
    t = rec.totals
    out: Dict[str, object] = {"steps": steps}
    for key, name in PER_STEP.items():
        if name in t and steps:
            out[f"{key}_ms_per_step"] = t[name].seconds * 1e3 / steps
    for key, name in PER_CALL.items():
        if name in t:
            out[f"{key}_ms_per_call"] = t[name].seconds * 1e3 / t[name].count
    if "trainer.block" in t and steps:
        out["trainer_block_self_ms_per_step"] = t["trainer.block"].self_seconds * 1e3 / steps
    out["graph_captures"] = t["graphs.capture"].count if "graphs.capture" in t else 0
    out["calls"] = {name: total.count for name, total in t.items()}
    out["device_ms_per_step"] = {n: sum(v) * 1e3 / len(v) for n, v in rec.phases.items() if v}
    out["device_steps"] = {n: len(v) for n, v in rec.phases.items()}
    out.update(overflow=rec.overflow, dropped=rec.dropped)
    return out


def self_overlaps(t0: int, t1: int, spans: Sequence, thread: str) -> Dict[int, tuple]:
    """For each span of ``thread`` that overlaps [t0, t1] (ns), its name and
    the overlap its children do not cover, by span id."""
    mine = [s for s in spans if s.thread == thread and s.start_ns < t1 and s.end_ns > t0]
    out = {s.id: [s.name, min(t1, s.end_ns) - max(t0, s.start_ns)] for s in mine}
    for s in mine:
        if s.parent in out:
            out[s.parent][1] -= min(t1, s.end_ns) - max(t0, s.start_ns)
    return {i: (n, ns) for i, (n, ns) in out.items()}


def name_gap(t0: int, t1: int, spans: Sequence, thread: str) -> Dict[str, object]:
    """A device idle gap [t0, t1] (ns of the host clock) named by the
    program's spans on ``thread``, under two rules:

    - ``span``: the one span whose own overlap (less its children's) is the
      longest, the innermost span that overlaps the gap most;
    - ``name``: the name whose spans' own overlaps sum to the most, so that
      a gap split among a block's several waits goes to the wait;

    ``shares``: each name's summed own overlap as a share of the gap.
    Without a span there, both read ``no host span``."""
    own = self_overlaps(t0, t1, spans, thread)
    if not own:
        return {"span": "no host span", "name": "no host span", "shares": {}}
    by_name: Dict[str, int] = defaultdict(int)
    for name, ns in own.values():
        by_name[name] += ns
    return {"span": max(own.values(), key=lambda v: v[1])[0],
            "name": max(by_name, key=by_name.get),
            "shares": {n: ns / (t1 - t0) for n, ns in
                       sorted(by_name.items(), key=lambda kv: -kv[1])}}


class _Traced:
    """What ``trace.reduce`` saw: the device intervals on the host clock,
    the trainer's thread and the harness's own reduction."""

    def __init__(self):
        self.seen: Optional[dict] = None
        self._reduce = tr.reduce

    def __call__(self, prof, timeline, window_s):
        out = self._reduce(prof, timeline, window_s)
        events = tr._device_events(prof)
        start_ns = prof.profiler.kineto_results.trace_start_ns()
        intervals = [(e.time_range.start, e.time_range.end) for e in events]
        busy_us, gaps = tr._union(intervals)
        h2d_us = sum(e.time_range.end - e.time_range.start for e in events
                     if "Memcpy HtoD" in e.name)
        gaps = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:10]
        self.seen = {
            "thread": threading.current_thread().name, "busy_us": busy_us, "h2d_us": h2d_us,
            "t0_ns": start_ns + int(min(a for a, _ in intervals) * 1e3) if intervals else 0,
            "t1_ns": start_ns + int(max(b for _, b in intervals) * 1e3) if intervals else 0,
            "gaps_ns": [(start_ns + int(a * 1e3), start_ns + int(b * 1e3)) for a, b in gaps],
            "harness_gaps": out["breakdown"]["idle_gaps"]}
        return out


def traced_figures(rec, seen: dict) -> Dict[str, object]:
    """The traced blocks' figures per stamped step, and their gaps named."""
    inside = [(n, a, b) for n, a, b in rec.phase_spans
              if a >= seen["t0_ns"] and b <= seen["t1_ns"]]
    steps = sum(n == "step.forward" for n, _, _ in inside)
    phase_ms: Dict[str, float] = defaultdict(float)
    for n, a, b in inside:
        phase_ms[n] += (b - a) * 1e-6 / steps
    gaps = []
    for (a, b), (harness_name, _) in zip(seen["gaps_ns"], seen["harness_gaps"]):
        named = name_gap(a, b, rec.spans, seen["thread"])
        gaps.append({"s": (b - a) * 1e-9, "span": named["span"], "name": named["name"],
                     "harness": harness_name,
                     "shares": {n: round(v, 4) for n, v in named["shares"].items()}})
    return {"stamped_steps": steps,
            "busy_ms_per_step": seen["busy_us"] * 1e-3 / steps if steps else None,
            "h2d_ms_per_step": seen["h2d_us"] * 1e-3 / steps if steps else None,
            "phase_ms_per_step": dict(phase_ms), "gaps": gaps}


def main(argv: Optional[List[str]] = None, **run_kwargs) -> int:
    """``portbench.run.main`` under a recorder; ``run_kwargs`` go to it."""
    import torch

    from vln_bevbert_tpu_torch.utils import profiling

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out")
    args, rest = p.parse_known_args(argv)
    root = run_kwargs.get("root", harness.ROOT)
    job = harness.job_module(harness.resolve(run.parse_args(rest).workload, root))
    device = torch.device(run_kwargs.get("device_name", "cuda"))
    traced = _Traced()
    window_open, window_reduce = job.Window.open, job.Window.reduce_trace
    steps = []

    def open_window(window, *a, **k):
        rec.clear()
        return window_open(window, *a, **k)

    def reduce_window(window):  # called once the window has closed
        steps.append(window.steps)
        return window_reduce(window)

    job.Window.open, job.Window.reduce_trace, tr.reduce = open_window, reduce_window, traced
    try:
        with profiling.recording(device=device) as rec:
            rc = run.main(rest, **run_kwargs)
            # the loader's prefetch thread ends the build it is in once closed
            for thread in threading.enumerate():
                if thread.name == "loader-prefetch":
                    thread.join(timeout=60)
    finally:
        job.Window.open, job.Window.reduce_trace, tr.reduce = (window_open, window_reduce,
                                                               traced._reduce)
    if rc != 0:
        return rc
    report = {"argv": rest, "window": window_figures(rec, steps[0])}
    if device.type == "cuda":
        report["clock_error_ns"] = rec.clock_error_ns
    if traced.seen is not None:
        report["traced"] = traced_figures(rec, traced.seen)
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
