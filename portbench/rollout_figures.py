"""The program's own spans, device phases and counters of a rollout window,
as a job reduces them into its ``Record`` and the per-layer readers read
them back per rollout step.

``reduce_recording`` copies a recorder (``profiling.recording``, cleared
when the window opened) into ``record.counters``: per span name its calls
(``calls:<name>``), seconds (``span_s:<name>``) and own seconds, less its
child spans' (``self_s:<name>``); per device phase its seconds
(``phase_s:<name>``). The job adds the window's delta of the agent's
counters (``rollout_steps`` and the rest). A program without the spans or
the counters leaves nothing to read: the readers then return None.
"""

from __future__ import annotations

from typing import Iterable, Optional

from .harness import Record


def reduce_recording(rec, record: Record) -> None:
    for name, total in rec.totals.items():
        record.counters[f"calls:{name}"] = total.count
        record.counters[f"span_s:{name}"] = total.seconds
        record.counters[f"self_s:{name}"] = total.self_seconds
    for name, seconds in rec.phases.items():
        record.counters[f"phase_s:{name}"] = sum(seconds)


def _names(record: Record, kind: str, prefix: str, leave_out: Iterable[str] = ()):
    head = f"{kind}:{prefix}"
    return [k for k in record.counters
            if k.startswith(head) and k[len(kind) + 1:] not in set(leave_out)]


def ms_per_step(record: Record, kind: str, prefix: str,
                leave_out: Iterable[str] = ()) -> Optional[float]:
    """Milliseconds per rollout step of the ``kind`` (``self_s``,
    ``span_s`` or ``phase_s``) seconds of every name that starts with
    ``prefix``, less the names in ``leave_out``."""
    steps = record.counters.get("rollout_steps")
    keys = _names(record, kind, prefix, leave_out)
    if not steps or not keys:
        return None
    return 1e3 * sum(record.counters[k] for k in keys) / steps
