"""Logging / metering utilities.

Role parity with the reference's logger stack
(reference pretrain_src/utils/logger.py:17-95 — global LOGGER,
TensorboardLogger, EMA RunningMeter; map_nav_src/utils/logger.py:28-58 Timer).
Metrics go to an append-only JSONL (easily greppable; TensorBoard optional)."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional


def get_logger(name: str = "vln_bevbert_tpu_torch", log_file: Optional[str] = None):
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if log_file:
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


class RunningMeter:
    """Exponential-moving-average meter (ref utils/logger.py:60-83)."""

    def __init__(self, smooth: float = 0.99):
        self.smooth = smooth
        self._value: Optional[float] = None

    def update(self, value: float):
        if self._value is None:
            self._value = value
        else:
            self._value = self._value * self.smooth + value * (1 - self.smooth)

    @property
    def value(self) -> float:
        return self._value if self._value is not None else float("nan")


class Timer:
    """tic/toc accumulator (ref map_nav_src/utils/logger.py:28-58)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def tic(self):
        self._t0 = time.time()

    def toc(self) -> float:
        dt = time.time() - self._t0
        self.total += dt
        self.count += 1
        return dt

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


class MetricLogger:
    """Append-only JSONL metric stream + stderr echo."""

    def __init__(self, output_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, filename)
        self.logger = get_logger()

    def log(self, step: int, metrics: Dict[str, float]):
        record = {"step": step, "time": time.time(), **metrics}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        short = ", ".join(
            f"{k}={v:.4g}" for k, v in list(metrics.items())[:8]
        )
        self.logger.info("step %d: %s", step, short)


class NullLogger:
    """``MetricLogger``'s surface on a data-parallel rank other than 0:
    writes nothing, creates no directory."""

    def log(self, step: int, metrics: Dict[str, float]):
        pass


def make_logger(output_dir: str, primary: bool = True):
    """A ``MetricLogger`` for the primary rank, a ``NullLogger`` otherwise."""
    return MetricLogger(output_dir) if primary else NullLogger()
