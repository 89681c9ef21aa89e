"""The pretraining loop (port of ``vln_bevbert_tpu/pretrain/trainer.py``):
the MetaLoader task schedule of ``PretrainLoader``, one train step per batch,
running meters and ``MetricLogger`` lines, validation and checkpoints
(parameters, optimizer state and step in one torch file ``ckpt_<step>``):
at every ``valid_steps`` crossing the trainer validates, then saves, as the
JAX trainer does.

``train`` runs blocks, as the JAX trainer's ``_train_blocked`` does:
consecutive batches of one task (the MetaLoader's blocks of
``task_block_size``, default 8) are zero-padded to the block's largest
shape and run as one ``make_pretrain_block_step`` call (which replays a
CUDA graph of the step where one can be captured, and runs eager steps
elsewhere); the meters take each block's last step, a log line follows a
block that crossed a ``log_steps`` boundary, and validation and
``ckpt_<step>`` follow a block that crossed a ``valid_steps`` boundary, at
the block's end step. ``task_block_size`` 1 runs and logs every step.

The loop reads each block's metrics back only after it has queued the
next, so the card never waits for the host's readback.
Validation runs the model in eval mode under ``torch.inference_mode()``: no
dropout, so it draws nothing from the dropout generator and leaves
training's stream as it was.

Spans (``utils/profiling.py``) of the loop: ``trainer.block``, one
an iteration, keyed by the block's first step (the loader's waits and the
block step within it; its self time is the block's padding and the loop's
bookkeeping, the loader's own included), and ``trainer.readback`` around
the previous block's readback, whose copy queues behind the block just
dispatched and so waits for the card to finish it.

Under data parallelism (``parallel.distributed.initialize``; the loaders
built with ``dp_rank``) every rank trains on its rows of the global batch:
the parameters are broadcast from rank 0 at construction, the step's
gradients and metrics are global, validation's losses and metrics are
global and its semantic scores and labels are gathered before the AUC/F1,
and only rank 0 logs and writes checkpoints, which every rank reads.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs import PretrainConfig
from ..data.loader import HostBatch, PretrainLoader
from ..parallel import distributed, train_step
from ..parallel.mesh import replicate_module
from ..parallel.train_step import (
    block_graph_bound,
    init_pretrain_state,
    load_checkpoint,
    make_eval_fn,
    make_pretrain_block_step,
    save_checkpoint,
    upload,
)
from ..utils import profiling
from ..utils.logging import RunningMeter, make_logger
from ..utils.mlabel import MP3D_CATEGORIES, multilabel_report


class PretrainTrainer:
    def __init__(self, cfg: PretrainConfig, train_loader: PretrainLoader, device,
                 output_dir: Optional[str] = None,
                 val_loaders: Optional[Dict[str, PretrainLoader]] = None):
        self.cfg = cfg
        self.train_loader = train_loader
        self.val_loaders = val_loaders or {}
        self.device = torch.device(device)
        self.output_dir = output_dir or cfg.output_dir
        self.logger = make_logger(self.output_dir, distributed.is_primary())
        self.model, self.projector, self.state = init_pretrain_state(cfg, cfg.seed, self.device)
        replicate_module(self.model)
        self.block_fn = make_pretrain_block_step(self.model, self.projector, self.state,
                                                 block_graph_bound(cfg))
        self.eval_fn = make_eval_fn(self.model, self.projector)

    # ------------------------------------------------------------ checkpoints
    def save(self, step: int) -> str:
        """Parameters, optimizer state and step as ``<output_dir>/ckpt_<step>``,
        written by rank 0; every rank waits for it."""
        path = os.path.join(self.output_dir, f"ckpt_{step}")
        if distributed.is_primary():
            save_checkpoint(path, self.model, self.state, step=self.state.step)
        distributed.barrier()
        return path

    def restore(self, path: str) -> None:
        """Parameters and optimizer state, whose counts give the step."""
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

    # ------------------------------------------------------------------ train
    def train(self, num_steps: Optional[int] = None) -> Dict[str, float]:
        """Train until ``num_steps`` steps (default
        ``cfg.optim.num_train_steps``; with gradient accumulation a step is a
        micro-step, as in JAX) in blocks of up to ``task_block_size``
        consecutive batches of one base task, never past ``num_steps`` (JAX
        ``_train_blocked``); returns the meters' values by "<task>/<metric>"."""
        cfg = self.cfg
        num_steps = num_steps or cfg.optim.num_train_steps
        meters: Dict[str, RunningMeter] = defaultdict(RunningMeter)
        n_examples, t_start = 0, time.time()

        def record(prev_step: int, step: int, task: str, metrics: Dict[str, torch.Tensor]):
            values = torch.stack([v.float() for v in metrics.values()]).tolist()
            for key, val in zip(metrics, values):
                meters[f"{task}/{key}"].update(val)
            if step // cfg.log_steps > prev_step // cfg.log_steps:
                self.logger.log(step, {
                    "train/examples_per_sec": n_examples / (time.time() - t_start),
                    "train/lr": self.state.lr(step),
                    **{k: m.value for k, m in meters.items()},
                })

        step, pending, carried = self.state.step, None, None
        batches = iter(self.train_loader)
        try:
            while step < num_steps:
                with profiling.span("trainer.block", key=step):
                    task, batch = carried if carried is not None else next(batches)
                    carried = None
                    base = task.split("_")[0]
                    block = [batch]
                    while len(block) < cfg.task_block_size and step + len(block) < num_steps:
                        nxt = next(batches)
                        if nxt[0].split("_")[0] != base:
                            carried = nxt
                            break
                        block.append(nxt[1])
                    metrics = self.block_fn(self.state, pad_block(block), base, len(block),
                                            stacked=True)
                    n_examples += len(block) * self.train_loader.global_batch_size
                    if pending is not None:
                        with profiling.span("trainer.readback"):
                            record(*pending)
                    prev_step, step = step, self.state.step
                    pending = (prev_step, step, base, metrics)
                if cfg.valid_steps and step // cfg.valid_steps > prev_step // cfg.valid_steps:
                    record(*pending)
                    pending = None
                    self.validate(step)
                    self.save(step)
            if pending is not None:
                with profiling.span("trainer.readback"):
                    record(*pending)
        finally:
            batches.close()
        return {k: m.value for k, m in meters.items()}

    # -------------------------------------------------------------- validation
    def validate(self, step: int, num_batches: int = 8) -> Dict[str, float]:
        """Per split, the mean loss and metrics of ``num_batches`` batches of
        every task (batch ``i * num_batches + j`` of task ``i``), and for
        sem/masksem the macro AUC and F1 over the supervised cells (the JAX
        trainer's ``validate``); logged at ``step`` and returned as
        "<split>/<task>/<metric>". Under data parallelism each rank runs its
        rows of every batch and the numbers are the global batches'."""
        results: Dict[str, float] = {}
        for split, loader in self.val_loaders.items():
            agg = defaultdict(list)
            sem_scores, sem_labels = [], []
            for i, task in enumerate(self.cfg.tasks):
                base = task.split("_")[0]
                for j in range(num_batches):
                    _, batch = loader.build_batch(i * num_batches + j, task=task)
                    batch = upload(batch, self.device)
                    loss, metrics = self.eval_step(batch, base)
                    names = ["loss", *metrics]
                    values = torch.stack([loss.float(), *(v.float() for v in metrics.values())])
                    for name, val in zip(names, values.tolist()):
                        agg[f"{split}/{base}/{name}"].append(val)
                    if base in ("sem", "masksem"):
                        scores, labels = self.sem_predictions(batch, base)
                        sem_scores.append(scores)
                        sem_labels.append(labels)
            results.update({k: float(np.mean(v)) for k, v in agg.items()})
            if sem_scores:
                # batch by batch, each batch's rows in rank order: the one
                # process's order at the global batch
                ranks = distributed.all_gather_objects((sem_scores, sem_labels))
                sem_scores = [s[j] for j in range(len(sem_scores)) for s, _ in ranks]
                sem_labels = [l[j] for j in range(len(sem_labels)) for _, l in ranks]
                report = multilabel_report(
                    np.concatenate(sem_scores), np.concatenate(sem_labels),
                    class_names=MP3D_CATEGORIES[: self.cfg.model.num_sem_classes])
                results[f"{split}/sem/auc_macro"] = report["auc_macro"]
                results[f"{split}/sem/f1_macro"] = report["f1_macro"]
        if results:
            self.logger.log(step, results)
        return results

    def eval_step(self, batch, task: str) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) of ``task`` on ``batch`` (host arrays or device
        tensors) with dropout off."""
        return self.eval_fn(upload(batch, self.device), task)

    def sem_predictions(self, batch, task: str) -> Tuple[np.ndarray, np.ndarray]:
        """(scores, labels) at the supervised BEV cells, (N, num_sem) each:
        ``sigmoid(local_sem_head(forward_sem(...)))`` with dropout off; for
        masksem the features of ``bev_mrc_masks`` cells are zeroed and only
        those cells count."""
        model = self.model
        training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                b = train_step.prepare_bev(self.projector, upload(batch, self.device))
                if task == "masksem":
                    b["bev_fts"] = torch.where(b["bev_mrc_masks"][..., None],
                                               torch.zeros_like(b["bev_fts"]), b["bev_fts"])
                embeds = model.bert.forward_sem(b, model.sem_pred_token)
                scores = torch.sigmoid(model.local_sem_head(embeds).float())
                sel = b["bev_sem_masks"]
                if task == "masksem":
                    sel = sel & b["bev_mrc_masks"]
                return scores[sel].cpu().numpy(), b["bev_sems"][sel].cpu().numpy()
        finally:
            model.train(training)


def pad_block(block: List[HostBatch]) -> List[HostBatch]:
    """Each key of each batch zero-padded at the end of every axis to the
    block's largest shape, as the JAX trainer pads before stacking (the
    bucketed axes only grow: zeros and masks, as a larger bucket). A host
    tensor is padded into a new one, page-locked where it was (the loader's
    batches on a card), so the dispatch copies it without pinning it first;
    other values are padded as numpy arrays."""
    out = [dict(b) for b in block]
    for key in block[0]:
        shapes = [tuple(np.shape(b[key])) for b in block]
        shape = tuple(max(dims) for dims in zip(*shapes))
        for b, have in zip(out, shapes):
            if have == shape:
                continue
            v = b[key]
            if isinstance(v, torch.Tensor):
                b[key] = torch.zeros(shape, dtype=v.dtype, pin_memory=v.is_pinned())
                b[key][tuple(slice(0, n) for n in have)] = v
            else:
                b[key] = np.pad(np.asarray(v), [(0, t - n) for n, t in zip(have, shape)])
    return out
