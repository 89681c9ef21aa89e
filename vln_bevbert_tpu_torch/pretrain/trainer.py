"""The pretraining loop (port of the step loop of
``vln_bevbert_tpu/pretrain/trainer.py``): the MetaLoader task schedule of
``PretrainLoader``, one train step per batch, running meters and
``MetricLogger`` lines, and checkpoints (parameters, optimizer state and
step in one torch file ``ckpt_<step>``). Validation is not ported yet.

The loop reads each step's metrics back only after it has queued the next
step, so the card never waits for the host's readback.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

from ..configs import PretrainConfig
from ..data.loader import PretrainLoader
from ..parallel.train_step import (
    init_pretrain_state,
    load_checkpoint,
    make_pretrain_step,
    save_checkpoint,
    upload,
)
from ..utils.logging import MetricLogger, RunningMeter


class PretrainTrainer:
    def __init__(self, cfg: PretrainConfig, train_loader: PretrainLoader, device,
                 output_dir: Optional[str] = None):
        self.cfg = cfg
        self.train_loader = train_loader
        self.device = torch.device(device)
        self.output_dir = output_dir or cfg.output_dir
        self.logger = MetricLogger(self.output_dir)
        self.model, self.projector, self.state = init_pretrain_state(cfg, cfg.seed,
                                                                     self.device)
        self.step_fn = make_pretrain_step(self.model, self.projector)

    # ------------------------------------------------------------ checkpoints
    def save(self, step: int) -> str:
        """Parameters, optimizer state and step as ``<output_dir>/ckpt_<step>``."""
        path = os.path.join(self.output_dir, f"ckpt_{step}")
        return save_checkpoint(path, self.model, self.state, step=self.state.step)

    def restore(self, path: str) -> None:
        """Parameters and optimizer state, whose update count is the step."""
        ckpt = load_checkpoint(path, self.device)
        self.model.load_state_dict(ckpt["params"])
        self.state.load_state_dict(ckpt["opt_state"])

    def auto_resume(self) -> Optional[str]:
        """Restore the newest ``ckpt_*`` of the output directory, if any;
        returns its path."""
        ckpts = [os.path.join(self.output_dir, f) for f in os.listdir(self.output_dir)
                 if f.startswith("ckpt_")]
        if not ckpts:
            return None
        newest = max(ckpts, key=os.path.getmtime)
        self.restore(newest)
        return newest

    def train(self, num_steps: Optional[int] = None) -> Dict[str, float]:
        """Train until ``num_steps`` updates (default
        ``cfg.optim.num_train_steps``); returns the meters' values by
        "<task>/<metric>"."""
        num_steps = num_steps or self.cfg.optim.num_train_steps
        meters: Dict[str, RunningMeter] = defaultdict(RunningMeter)
        n_examples, t_start = 0, time.time()

        def record(step: int, task: str, metrics: Dict[str, torch.Tensor]):
            # one device -> host copy per step
            values = torch.stack([v.float() for v in metrics.values()]).tolist()
            for key, val in zip(metrics, values):
                meters[f"{task}/{key}"].update(val)
            if step % self.cfg.log_steps == 0:
                self.logger.log(step, {
                    "train/examples_per_sec": n_examples / (time.time() - t_start),
                    "train/lr": self.state.tx.sched(step - 1),
                    **{k: m.value for k, m in meters.items()},
                })

        pending = None
        batches = iter(self.train_loader)
        try:
            while self.state.step < num_steps:
                task, batch = next(batches)
                base = task.split("_")[0]
                metrics = self.step_fn(self.state, upload(batch, self.device), base)
                n_examples += self.train_loader.global_batch_size
                if pending is not None:
                    record(*pending)
                pending = (self.state.step, base, metrics)
            if pending is not None:
                record(*pending)
        finally:
            batches.close()  # stops the loader's prefetch thread or workers
        return {k: m.value for k, m in meters.items()}
