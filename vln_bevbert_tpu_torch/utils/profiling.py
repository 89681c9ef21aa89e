"""Profiling / tracing hooks (port of ``vln_bevbert_tpu/utils/profiling.py``).

- ``trace``: ``torch.profiler`` over the block, host and (with a card) CUDA
  activities, its Chrome trace written into ``log_dir`` (view in Perfetto or
  ``chrome://tracing``); the block gets the profiler, whose ``events()`` and
  ``key_averages()`` stay readable after it;
- ``annotate``: a named ``record_function`` span for a host-side phase;
- ``StepTimer``: windowed steps/s and examples/s, the reference's
  train_r2r.py:315-333 meter, with an optional device sync.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profile the block; on exit write ``trace_<pid>_<n>.json`` into
    ``log_dir`` (its path is then ``prof.trace_path``)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    n = sum(f.startswith(f"trace_{os.getpid()}_") for f in os.listdir(log_dir))
    prof.trace_path = os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json")
    prof.export_chrome_trace(prof.trace_path)


def annotate(name: str) -> record_function:
    return record_function(name)


def _sync(obj) -> None:
    """Wait for the CUDA device that ``obj`` (a tensor, a module or a
    device) lives on; nothing for the CPU."""
    if isinstance(obj, torch.nn.Module):
        obj = next(obj.parameters(), None)
    device = obj.device if isinstance(obj, torch.Tensor) else torch.device(obj)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StepTimer:
    """Windowed steps/sec + examples/sec with an optional device sync."""

    def __init__(self, window: int = 50):
        self.window = window
        self.reset()

    def reset(self):
        self._t0 = time.time()
        self._steps = 0
        self._examples = 0
        self.steps_per_sec = float("nan")
        self.examples_per_sec = float("nan")

    def tick(self, n_examples: int = 0, sync: Optional[object] = None):
        if sync is not None:
            _sync(sync)
        self._steps += 1
        self._examples += n_examples
        if self._steps >= self.window:
            dt = time.time() - self._t0
            self.steps_per_sec = self._steps / dt
            self.examples_per_sec = self._examples / dt
            self._t0 = time.time()
            self._steps = 0
            self._examples = 0
            return True
        return False
