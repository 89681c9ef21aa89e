"""What the benchmark finds by name, and what every run shares.

A cell is an entry of ``workloads`` in the checkout's ``BENCHMARK.json``:
its configuration's file (``configs[].file``), its traffic file
``portbench/traffic/<traffic>.json`` (whose ``job`` names the module that
runs it, ``portbench/jobs/<job>.py``), the limits of the numbers its run compares
(``portbench/limits/<cell>.json``), its end-to-end metrics and its
per-layer metrics, each of those read by ``portbench/metrics/<name>.py``. Adding a
cell, a configuration, a traffic mix or a metric adds files and entries;
none of this code changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = Path(__file__).resolve().parent
#: top-level module names a run must never hold: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "vln_bevbert_tpu")


class HarnessError(RuntimeError):
    """A cell, file or metric that the benchmark cannot resolve."""


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]
    root: Path = ROOT

    @property
    def job(self) -> str:
        return self.traffic["job"]


def _load_json(path: Path) -> Dict[str, Any]:
    if not path.is_file():
        raise HarnessError(f"{path} is missing")
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, with its files."""
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise HarnessError(f"unknown workload {name!r}: BENCHMARK.json lists "
                           f"{', '.join(sorted(cells))}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise HarnessError(f"workload {name!r} names the unknown config {w['config']!r}")
    config = _load_json(root / configs[w["config"]]["file"])
    traffic = _load_json(root / "portbench" / "traffic" / f"{w['traffic']}.json")
    limits = _load_json(root / "portbench" / "limits" / f"{name}.json")["limits"]
    return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"],
                chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)], root=root)


def job_module(cell: Cell):
    path = BENCH_DIR / "jobs" / f"{cell.job}.py"
    if not path.is_file():
        raise HarnessError(f"traffic {cell.traffic_name!r} names the job {cell.job!r}, "
                           f"but {path} is missing")
    return importlib.import_module(f"portbench.jobs.{cell.job}")


def metric_reader(name: str, root: Path = ROOT) -> Callable[["Record"], Optional[float]]:
    """``read(record)`` of ``portbench/metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise HarnessError(f"the per-layer metric {name!r} has no reader at {path}")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "__"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclass
class Record:
    """What a run saw, for the per-layer readers: host spans (seconds of
    each call, by name), counters, and from a traced window its length, the
    device's busy seconds, device seconds by kernel family, and the work
    counted from shapes."""

    spans: Dict[str, List[float]] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    traced: Dict[str, Any] = field(default_factory=dict)

    def span(self, name: str):
        """A context manager adding the block's seconds to ``spans[name]``."""
        return _Span(self.spans.setdefault(name, []))


class _Span:
    def __init__(self, sink: List[float]):
        self.sink = sink

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.sink.append(time.perf_counter() - self.t0)


@dataclass
class Check:
    """A number compared against its limit (it must not exceed it)."""

    name: str
    value: float
    limit: float
    where: str = ""

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def checks(gaps: Dict[str, tuple], limits: Dict[str, float], log) -> List[Check]:
    """The cell's compared numbers (``gaps``: name -> (value, where)) against
    their limits; a reading without a limit is only logged."""
    for name, (value, where) in gaps.items():
        if name not in limits:
            log(f"[portbench] reading {name} = {value!r} (not compared; worst at {where})")
    return [Check(name, gaps[name][0], limit, gaps[name][1]) for name, limit in limits.items()]


@dataclass
class Result:
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: List[Check]
    memory_peak_bytes: int
    record: Record = field(default_factory=Record)
    breakdown: Optional[dict] = None


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def result_line(cell: Cell, result: Result, trace: bool, device: dict) -> dict:
    """The run's last line: end-to-end metrics with ``--trace 0``, per-layer
    metrics (those whose reader finds something) with ``--trace 1``, and
    the compared numbers last."""
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = metric_reader(m["name"], cell.root)(result.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": result.end_to_end[m["name"]], "unit": m["unit"]}
    line = {"correct": all(c.ok for c in result.checks) and bool(result.checks),
            "attempted": result.attempted, "failed": result.failed,
            "metrics": metrics, "device": device}
    if trace and result.breakdown:
        line["breakdown"] = result.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in result.checks}
    return line
