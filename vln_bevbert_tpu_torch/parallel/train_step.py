"""The pretraining step (port of ``vln_bevbert_tpu/parallel/train_step.py``).

One step: the device lift-splat of the raw BEV inputs (``prepare_bev``,
through the CUDA splat kernel on the card), the ``GlocalTextPathCMTPreTraining``
forward of one proxy task with dropout on (through the CUDA dropout kernel on
the card), the loss's backward, a float32 global-norm clip of that step's
gradients and the configured optimizer (``optim.Optimizer``: AdamW with a
bfloat16 first moment by default; with gradient accumulation it moves the
parameters every k-th step). The JAX step is a pure jitted function of its
state; here ``TrainState`` holds the module's parameters, their gradient
buffers and the optimizer state, and the step updates them in place.
``make_eval_fn`` is validation's forward: the same lift-splat, dropout off.

``make_pretrain_block_step`` is the JAX package's block of K steps in one
``lax.scan`` dispatch: where ``graphs.capturable`` says a step can be
captured (on the card, with no process group or an NCCL one) one step is
captured into a CUDA graph (``utils/graphs.py``) and replayed K times, the
batch copied into its static inputs before each replay; elsewhere it runs K
eager steps.

A step queues its device work and reads nothing back: the learning rate and
the update count are device scalars (the host keeps its own count), the
dropout seeds come from a generator on the device, and batches are uploaded
through pinned memory.

``TrainState`` also serves the fine-tuning agent's replay update;
``save_checkpoint``/``load_checkpoint`` write and read one torch file with
the parameters and the optimizer state of either.

Under data parallelism (``distributed.initialize``) each rank runs the step
on its rows: the losses divide by global counts (``models/glocal.py``), the
gradient buffers, one flat buffer per dtype, are summed over the ranks in
one all-reduce before the clip, so the clip sees the global norm and every
rank applies the same update, and the reported loss is the global one. The
model is not wrapped in ``DistributedDataParallel``: the fine-tuning replay
calls sub-modules and runs the navigation forward T times before one
backward, which DDP's hooks do not follow; the all-reduce is JAX's psum.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..configs import ModelConfig, OptimConfig, PretrainConfig, ShapeConfig
from ..models.bert import init_params
from ..models.glocal import GlocalTextPathCMTPreTraining
from ..ops.bev import BevProjector
from ..ops.dropout import Dropout, set_dropout_generator
from ..utils import graphs, profiling
from ..utils.device import resolve_device, to_device
from ..utils.rng import make_generator, train_generator
from . import distributed
from .optim import Optimizer, decay_mask

Batch = Dict[str, Any]


class TrainState:
    """A module's parameters with persistent gradient buffers, the state of
    the optimizer ``cfg.optim`` and the global-norm clip. Weight decay
    follows ``decay_mask``, or reaches every parameter with ``decay_all``
    (optax's ``mask=None``)."""

    def __init__(self, model: nn.Module, cfg: OptimConfig, decay_all: bool = False):
        names, params = zip(*model.named_parameters())
        mask = None if decay_all else decay_mask(model)
        self.names = list(names)
        self.params = list(params)
        # zeros, not None: a parameter the task's forward does not reach
        # still gets its moment decay and weight decay, as in optax, and
        # enters the all-reduce as zeros. The buffers are views of one flat
        # buffer per dtype, which autograd accumulates into in place.
        self.flat_grads = []
        for dtype in dict.fromkeys(p.dtype for p in self.params):
            group = [p for p in self.params if p.dtype == dtype]
            flat = torch.zeros(sum(p.numel() for p in group), dtype=dtype,
                               device=group[0].device)
            offset = 0
            for p in group:
                p.grad = flat[offset:offset + p.numel()].view_as(p)
                offset += p.numel()
            self.flat_grads.append(flat)
        self.tx = Optimizer(self.params, [mask is None or mask[n] for n in names], cfg)
        self.clip_norm = float(cfg.grad_norm)

    def all_reduce_grads(self) -> None:
        """Sum the gradient buffers over the data-parallel ranks, one
        collective per dtype; at one process nothing happens."""
        for flat in self.flat_grads:
            distributed.all_reduce_(flat)

    @property
    def step(self) -> int:
        """Calls of ``apply_gradients``, as the JAX ``TrainState.step`` counts
        them: with accumulation, k calls per update (``tx.count``)."""
        return self.tx.count * self.tx.k + self.tx.mini_step

    def lr(self, step: int) -> float:
        """The learning rate of the update that call ``step`` (1-based) folds into."""
        return self.tx.sched((step - 1) // self.tx.k)

    def state_dict(self) -> Dict[str, Any]:
        """The optimizer state: the update ``count``, the ``mini_step`` of
        accumulation, and each state tensor by name, then by parameter name
        (``mu`` in its storage dtype, ``nu``, a wrapper's, ``acc``)."""
        return {"count": self.tx.count, "mini_step": self.tx.mini_step,
                **{key: dict(zip(self.names, bufs)) for key, bufs in self.tx.buffers().items()}}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Restore ``state_dict``'s output; a file without ``mini_step``
        (written before accumulation was ported) holds none."""
        for key, bufs in self.tx.buffers().items():
            for name, buf in zip(self.names, bufs):
                buf.copy_(sd[key][name])
        self.tx.set_counts(sd["count"], sd.get("mini_step", 0))

    def device_state(self) -> List[torch.Tensor]:
        """Every tensor a step writes: the parameters, the gradient buffers
        and the optimizer's state and device counts."""
        return self.params + self.flat_grads + self.tx.device_state()

    def apply_gradients(self, moves: Optional[bool] = None) -> torch.Tensor:
        """Clip by the global norm in the step body (one float32 norm pass
        serves the clip and the returned ``grad_norm``), update, and zero the
        gradient buffers. ``g * clip / max(norm, clip)`` is
        ``optax.clip_by_global_norm``; with accumulation each call's
        gradients are clipped before they are averaged, as in JAX. ``moves``
        as ``Optimizer.update`` takes it: given, the host counts stay as
        they are, so that a graph can capture the call."""
        grads = [p.grad for p in self.params]
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        torch._foreach_mul_(grads, self.clip_norm / torch.clamp_min(gnorm, self.clip_norm))
        self.tx.update(grads, moves)
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


def init_pretrain_state(cfg: PretrainConfig, seed: int = 0, device="cuda"
                        ) -> Tuple[GlocalTextPathCMTPreTraining, BevProjector, TrainState]:
    """Model (random parameters from ``seed``, training mode, dropout drawing
    from a generator on ``device`` as this process's data-parallel rank),
    projector and optimizer state. The card unless the caller asks for the
    CPU: without CUDA, a CUDA ``device`` raises."""
    device = resolve_device(device)
    model = GlocalTextPathCMTPreTraining(cfg.model, tuple(cfg.tasks), cfg.sem_pred_token,
                                         device=device)
    init_params(model, make_generator(seed, device))
    set_dropout_generator(model, train_generator(seed, device), distributed.rank(),
                          distributed.world_size())
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


def make_eval_fn(model: GlocalTextPathCMTPreTraining, projector: BevProjector
                 ) -> Callable[[Batch, str], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """Validation's forward (``eval_fn`` of JAX ``PretrainTrainer.eval_step``):
    ``loss_fn``'s mlm ids and lift-splat, the model in eval mode (no dropout)
    under ``torch.inference_mode()``, then training mode as it was. Under
    data parallelism the loss and metrics are the global ones."""
    loss_fn = make_loss_fn(model, projector)

    def eval_fn(batch: Batch, task: str):
        training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                loss, metrics = loss_fn(batch, task)
                return distributed.all_reduce_(loss), metrics
        finally:
            model.train(training)

    return eval_fn


def make_pretrain_step(model: GlocalTextPathCMTPreTraining, projector: BevProjector
                       ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns step(state, batch, task, moves=None) -> metrics (device
    tensors, with ``loss`` and ``grad_norm``, global under data
    parallelism); ``batch`` lies on the model's device and holds this rank's
    rows. ``moves`` as ``TrainState.apply_gradients`` takes it: a graph of
    the block step captures ``step(..., moves)``. While a recorder with
    device phases records (``utils/profiling.py``), the step stamps its
    phases on the card: ``step.forward`` (lift-splat, forward, loss),
    ``step.backward``, ``step.all_reduce`` (under data parallelism) and
    ``step.optimizer`` (clip, update, zeroing); a graph captured then
    stamps them at every replay."""
    loss_fn = make_loss_fn(model, projector)

    def step(state: TrainState, batch: Batch, task: str,
             moves: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        device = state.params[0].device
        profiling.device_phase("step.forward", device)
        loss, metrics = loss_fn(batch, task)
        profiling.device_phase("step.backward", device)
        loss.backward()
        if distributed.active():
            profiling.device_phase("step.all_reduce", device)
        state.all_reduce_grads()
        profiling.device_phase("step.optimizer", device)
        gnorm = state.apply_gradients(moves)
        profiling.device_phase(None, device)
        return {**metrics, "loss": distributed.all_reduce_(loss.detach()), "grad_norm": gnorm}

    return step


def dropout_generators(model: nn.Module) -> List[torch.Generator]:
    """The distinct generators ``model``'s Dropout modules draw from."""
    gens = {id(m.generator): m.generator for m in model.modules()
            if isinstance(m, Dropout) and m.generator is not None}
    return list(gens.values())


def block_batches(batch, length: int, stacked: bool) -> Sequence[Batch]:
    """The ``length`` batches of a block: ``batch`` re-fed, or with
    ``stacked`` the list of ``length`` batches it is."""
    if not stacked:
        return [batch] * length
    if len(batch) != length:
        raise ValueError(f"a stacked block of length {length} got {len(batch)} batches")
    return batch


def block_graph_bound(cfg: PretrainConfig) -> int:
    """The most graphs a pretraining block step can capture: for each task,
    each shape ``data/batching.py`` buckets a batch into (T in multiples of
    4 up to ``max_steps``, L in {64, 128, cap}, N in {cap / 2, cap}; the
    batch size is fixed) and, with accumulation, a second graph for the
    calls that fold without moving the parameters."""
    shapes = cfg.shapes
    t_buckets = (shapes.max_steps + 3) // 4
    l_buckets = len({b for b in (64, 128) if b < shapes.max_txt_len} | {shapes.max_txt_len})
    n_buckets = len({shapes.max_gmap_len // 2, shapes.max_gmap_len})
    phases = 2 if cfg.optim.gradient_accumulation_steps > 1 else 1
    return len(cfg.tasks) * t_buckets * l_buckets * n_buckets * phases


def make_pretrain_block_step(model: GlocalTextPathCMTPreTraining, projector: BevProjector,
                             state: TrainState, max_graphs: Optional[int] = None
                             ) -> Callable[..., Dict[str, torch.Tensor]]:
    """K optimizer steps per call (JAX ``make_pretrain_block_step``).

    Returns ``block(state, batch, task, length, stacked=False)`` -> the last
    step's metrics (device tensors). Without ``stacked`` the one batch is
    re-fed ``length`` times (the bench pattern); with it ``batch`` is a
    list of ``length`` distinct batches (host arrays or device tensors),
    one a step. On the card every step is a replay of a CUDA graph of the
    whole step (the lift-splat through the splat kernel, the forward with
    its dropout kernels, the backward, the gradient all-reduce, the clip and
    the update), captured once per (task, batch signature, whether the step
    moves the parameters) and cached; nothing reads back to the host. Where
    ``graphs.capturable`` says no at the call (the CPU, a gloo group) the
    steps run eagerly. ``state`` is the one the block runs on; at most
    ``max_graphs`` graphs are kept (``block_graph_bound`` gives a
    configuration's; None keeps every one), the least recently used evicted
    first; a block on the card shows its cache as ``block.graphs``. A call
    is the span ``block_step`` (``utils/profiling.py``), the cache's
    ``graphs.stage``, ``graphs.replay`` and ``graphs.capture`` within it."""
    device = state.params[0].device
    step = make_pretrain_step(model, projector)
    cache = graphs.GraphCache(max_graphs)

    def block(state_: TrainState, batch, task: str, length: int,
              stacked: bool = False) -> Dict[str, torch.Tensor]:
        if not graphs.capturable(device):
            with profiling.span("block_step"):
                for b in block_batches(batch, length, stacked):
                    metrics = step(state_, upload(b, device), task)
            return metrics
        if state_ is not state:
            raise ValueError("this block step was made for another TrainState")
        loaded = None if stacked else set()  # one re-fed batch is copied in once
        with profiling.span("block_step"):
            for b in block_batches(batch, length, stacked):
                moves = state.tx.moves_next
                out = cache.step((task, graphs.signature(b), moves), b, device,
                                 lambda inputs: step(state, inputs, task, moves),
                                 state.device_state(), dropout_generators(model), loaded)
                state.tx.advance(moves)
            return {k: v.clone() for k, v in out.items()}

    if device.type == "cuda":  # a CPU block never captures: no cache to show
        block.graphs = cache
    return block
