"""The arithmetic the per-layer readers share. Each returns None where the
run has nothing to read (an untraced run, a kernel that did not run), never
0 for a share of a roofline or a peak."""

from __future__ import annotations

from typing import Optional

from . import counts
from .harness import Record


def mfu(record: Record) -> Optional[float]:
    t = record.traced
    if not t.get("window_s") or not t.get("flops"):
        return None
    return counts.mfu_pct(t["flops"], t["window_s"])


def idle_pct(record: Record) -> Optional[float]:
    t = record.traced
    if not t.get("window_s") or "busy_s" not in t:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline(record: Record, kernel: str) -> Optional[float]:
    t = record.traced
    device_s = t.get("kernel_s", {}).get(kernel, 0.0)
    moved = t.get(f"{kernel}_bytes", 0.0)
    if device_s <= 0.0 or moved <= 0.0:
        return None
    return counts.roofline_pct(moved, device_s)


def ms_per_call(record: Record, span: str) -> Optional[float]:
    """Mean milliseconds of a host span's calls in the window."""
    calls = record.spans.get(span)
    return 1e3 * sum(calls) / len(calls) if calls else None


def ms_per(record: Record, span: str, counter: str) -> Optional[float]:
    """A host span's milliseconds in the window per unit of ``counter``."""
    calls, n = record.spans.get(span), record.counters.get(counter)
    return 1e3 * sum(calls) / n if calls and n else None
