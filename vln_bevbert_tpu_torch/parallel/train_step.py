"""The pretraining step (port of ``vln_bevbert_tpu/parallel/train_step.py``).

One step: the device lift-splat of the raw BEV inputs (``prepare_bev``,
through the CUDA splat kernel on the card), the ``GlocalTextPathCMTPreTraining``
forward of one proxy task with dropout on (through the CUDA dropout kernel on
the card), the loss's backward, a float32 global-norm clip and AdamW with a
bfloat16 first moment. The JAX step is a pure jitted function of its state;
here ``TrainState`` holds the module's parameters, their gradient buffers
and the optimizer state, and the step updates them in place. The JAX
package's scan over a block of steps is a loop of steps here.

A step queues its device work and reads nothing back: the learning rate and
step count live on the host, the dropout seeds come from a generator on the
device, and batches are uploaded through pinned memory.

``TrainState`` also serves the fine-tuning agent's replay update;
``save_checkpoint``/``load_checkpoint`` write and read one torch file with
the parameters and the optimizer state of either.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..configs import ModelConfig, OptimConfig, PretrainConfig, ShapeConfig
from ..models.bert import init_params
from ..models.glocal import GlocalTextPathCMTPreTraining
from ..ops.bev import BevProjector
from ..ops.dropout import set_dropout_generator
from ..utils.device import to_device
from ..utils.rng import make_generator, train_generator
from .optim import AdamW, decay_mask

Batch = Dict[str, Any]


class TrainState:
    """A module's parameters with persistent gradient buffers, AdamW state
    and the global-norm clip. Weight decay follows ``decay_mask``, or reaches
    every parameter with ``decay_all`` (optax's ``mask=None``)."""

    def __init__(self, model: nn.Module, cfg: OptimConfig, decay_all: bool = False):
        names, params = zip(*model.named_parameters())
        mask = None if decay_all else decay_mask(model)
        self.names = list(names)
        self.params = list(params)
        for p in self.params:
            # zeros, not None: a parameter the task's forward does not reach
            # still gets its moment decay and weight decay, as in optax
            p.grad = torch.zeros_like(p)
        self.tx = AdamW(self.params, [mask is None or mask[n] for n in names], cfg)
        self.clip_norm = float(cfg.grad_norm)

    @property
    def step(self) -> int:
        return self.tx.count

    def state_dict(self) -> Dict[str, Any]:
        """The optimizer state by parameter name: ``mu`` (its storage dtype),
        ``nu`` (float32) and the update ``count``."""
        return {"mu": dict(zip(self.names, self.tx.mu)),
                "nu": dict(zip(self.names, self.tx.nu)), "count": self.tx.count}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        for name, mu, nu in zip(self.names, self.tx.mu, self.tx.nu):
            mu.copy_(sd["mu"][name])
            nu.copy_(sd["nu"][name])
        self.tx.count = int(sd["count"])

    def apply_gradients(self) -> torch.Tensor:
        """Clip by the global norm in the step body (one float32 norm pass
        serves the clip and the returned ``grad_norm``), update, and zero the
        gradient buffers. ``g * clip / max(norm, clip)`` is
        ``optax.clip_by_global_norm``."""
        grads = [p.grad for p in self.params]
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        torch._foreach_mul_(grads, self.clip_norm / torch.clamp_min(gnorm, self.clip_norm))
        self.tx.update(grads)
        torch._foreach_zero_(grads)
        return gnorm


def save_checkpoint(path: str, model: nn.Module, state: TrainState, **extra) -> str:
    """One torch file: the module's ``state_dict`` under ``params``, the
    optimizer state under ``opt_state``, and ``extra`` entries."""
    torch.save({"params": model.state_dict(), "opt_state": state.state_dict(), **extra}, path)
    return path


def load_checkpoint(path: str, device) -> Dict[str, Any]:
    """A file written by ``save_checkpoint``, its tensors on ``device``."""
    return torch.load(path, map_location=torch.device(device), weights_only=True)


def build_projector(cfg: ModelConfig, shapes: ShapeConfig, device=None) -> BevProjector:
    return BevProjector(vfov=math.radians(90.0), grid_hw=shapes.grid_hw,
                        num_views=shapes.num_views, map_dim=cfg.bev_dim,
                        map_res=cfg.bev_res, z_clip=0.5, num_sem=cfg.num_sem_classes,
                        device=device)


def prepare_bev(projector: BevProjector, batch: Batch) -> Batch:
    """Replace the raw BEV inputs (depths, camera poses, grid features,
    semantic labels) by the splatted ``bev_fts``, ``bev_sems`` and
    ``bev_sem_masks``; a batch without ``depths`` passes through. Pretraining
    attends over the full grid (``bev_masks`` all ones)."""
    if "depths" not in batch:
        return batch
    out = dict(batch)
    bev, _, sem, sem_mask = projector.lift_splat(
        out.pop("depths"), out.pop("T_c2w"), out.pop("T_w2c"), out.pop("S_w2c"),
        out.pop("grid_fts"), out.pop("sem_labels"),
    )
    out.update(bev_fts=bev, bev_sems=sem, bev_sem_masks=sem_mask)
    return out


def upload(batch: Dict[str, np.ndarray], device: torch.device) -> Batch:
    """A host batch as tensors on ``device`` (``utils.device.to_device``)."""
    return {key: to_device(val, device) for key, val in batch.items()}


def init_pretrain_state(cfg: PretrainConfig, seed: int = 0, device="cpu"
                        ) -> Tuple[GlocalTextPathCMTPreTraining, BevProjector, TrainState]:
    """Model (random parameters from ``seed``, training mode, dropout drawing
    from a generator on ``device``), projector and optimizer state."""
    device = torch.device(device)
    model = GlocalTextPathCMTPreTraining(cfg.model, tuple(cfg.tasks), cfg.sem_pred_token,
                                         device=device)
    init_params(model, make_generator(seed, device))
    set_dropout_generator(model, train_generator(seed, device))
    model.train()
    return model, build_projector(cfg.model, cfg.shapes, device), TrainState(model, cfg.optim)


def make_loss_fn(model: GlocalTextPathCMTPreTraining, projector: BevProjector
                 ) -> Callable[[Batch, str], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    def loss_fn(batch: Batch, task: str):
        batch = dict(batch)
        if task == "mlm" and "mlm_ids" in batch:
            batch["txt_ids"] = batch["mlm_ids"]
        return model(prepare_bev(projector, batch), task)

    return loss_fn


def make_pretrain_step(model: GlocalTextPathCMTPreTraining, projector: BevProjector
                       ) -> Callable[[TrainState, Batch, str], Dict[str, torch.Tensor]]:
    """Returns step(state, batch, task) -> metrics (device tensors, with
    ``loss`` and ``grad_norm``); ``batch`` lies on the model's device."""
    loss_fn = make_loss_fn(model, projector)

    def step(state: TrainState, batch: Batch, task: str) -> Dict[str, torch.Tensor]:
        loss, metrics = loss_fn(batch, task)
        loss.backward()
        gnorm = state.apply_gradients()
        return {**metrics, "loss": loss.detach(), "grad_norm": gnorm}

    return step
