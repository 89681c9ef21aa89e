"""Learning-rate schedules, the weight-decay mask and the optimizer family
(port of ``make_optimizer(cfg, include_clip=False)`` of
``vln_bevbert_tpu/parallel/optim.py``).

``Optimizer`` computes what the JAX package's optax chain computes, written
as ``torch._foreach_*`` tensor ops over a list of float32 parameters.
``cfg.optim`` is ``<base>[+<wrapper>]``:

- ``adamw``: ``optax.adamw(mu_dtype=...)`` as the jitted JAX step
  computes it. ``m = (1 - b1) * g + b1 * m`` with ``b1`` cast to the
  moment's storage dtype (``optax.tree.update_moment`` on a bfloat16 ``m``:
  0.9 -> 0.8984375) and the product taken in float32 (XLA fuses it into
  the float32 add; eager JAX would round it to bfloat16 first), ``v = (1 -
  b2) * g^2 + b2 * v`` in float32; ``u =
  (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)`` from the float32 ``m``,
  which is then rounded to its storage dtype; ``u += weight_decay * p``
  where the mask allows it; the update is ``-lr * u``. The only base whose
  first moment is stored in ``cfg.mu_dtype``; the others keep float32 state,
  as optax does.
- ``adam``, ``radam``, ``adamax``: L2 decay into the gradient first
  (``add_decayed_weights`` before the optax transform), so the decay enters
  the moments. ``radam`` rectifies once ``rho_t >= 5``; ``adamax`` divides
  by ``max(|g| + eps, b2 * v)``.
- ``lamb``: ``optax.lamb`` (eps 1e-6): the Adam direction plus masked
  decay, scaled per tensor by ``||p|| / ||u||`` (1 where either is 0).
- ``ralamb``: the JAX package's own transform, with the reference's quirks:
  the decay is lr-scaled and applied before the step and not trust-scaled;
  the trust ratio is ``clip(||p||, 0, 10) / ||candidate||`` over the
  candidate parameters, 1 where either norm is 0; the rectified direction
  once ``N_sma >= 5``.
- ``rangerlars``: ``ralamb`` then ``lookahead(6, 0.5)``.
- ``+lookahead``: every 6th update lands the parameters on ``slow + 0.5 *
  (fast - slow)``, which becomes the slow copy; the slow copy is taken from
  the parameters when the optimizer is built, as in JAX.
- ``+ema``: ``optax.ema(0.5, debias=False)`` over the *updates*.
- ``gradient_accumulation_steps`` k > 1: ``optax.MultiSteps``. Every call
  folds its gradients into a running mean (``acc + (g - acc) / (n + 1)``);
  only every k-th call runs the update on the mean and moves the
  parameters. The schedule, the bias corrections and lookahead's sync run
  on the update count ``count``, not on calls.

The update count lives twice: as the host ints ``count`` and ``mini_step``
(``TrainState.step``, checkpoints and logs read them) and as device
scalars, from which the update computes the learning rate, the bias
corrections, radam's and ralamb's rectification, lookahead's sync and the
accumulation mean as tensor ops. So an update queues device work, reads
nothing back and reads no host int: a CUDA graph captured from it computes
the right values at every replay (``torch.optim``'s ``capturable=True``).
``update`` decides on the host whether the call moves the parameters and
then ``advance``s the host ints; a graph captures ``update(grads, moves)``,
which leaves them, and its caller advances them after each replay. The JAX
package's low-precision
update paths (``scale_by_adam_lp``, ``fused_adamw_clip``) are not ported:
a config that selects one raises, naming its fields.

Fine-tuning builds its optimizer in the agent rather than from an
``OptimConfig`` (JAX ``nav/agent.py:225-232``); ``finetune_optim`` states it
as one: a constant learning rate, optax's default betas and weight decay on
every parameter.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..configs import FinetuneConfig, OptimConfig
from ..convert import flax_paths

BASES = ("adamw", "adam", "adamax", "radam", "lamb", "ralamb", "rangerlars")
WRAPPERS = ("", "ema", "lookahead")
# the JAX config fields that select its low-precision update paths, at the
# values that leave them off
LOW_PRECISION_KNOBS = {"nu_dtype": "float32", "grad_dtype": "float32",
                       "state_sr": False, "fused_update": False}
LOOKAHEAD_K, LOOKAHEAD_ALPHA = 6, 0.5
EMA_DECAY = 0.5

Tensors = List[torch.Tensor]


def lr_schedule(cfg: OptimConfig) -> Callable:
    """step -> learning rate: "linear" warmup from 0 then linear decay to 0
    at ``num_train_steps`` (optax.join_schedules of two linear schedules),
    "noam", or "constant". Computed as float64 tensor ops: an int64 step
    tensor gives the rate on its device, so that an update reads its step
    from a device scalar and a captured graph reads it at replay (both
    branches of a schedule are computed and one is kept); an int step gives
    a Python float."""
    lr, warmup, total = cfg.learning_rate, cfg.warmup_steps, cfg.num_train_steps
    if cfg.lr_schedule == "constant":

        def sched(s: torch.Tensor) -> torch.Tensor:
            return torch.full((), lr, dtype=torch.float64, device=s.device)

    elif cfg.lr_schedule == "linear":
        decay_steps = max(total - warmup, 1)

        def sched(s: torch.Tensor) -> torch.Tensor:
            s = s.double()
            up = lr * s / max(warmup, 1)
            down = lr * (1.0 - torch.clamp(s - warmup, max=decay_steps) / decay_steps)
            return torch.where(s < warmup, up, down)

    elif cfg.lr_schedule == "noam":

        def sched(s: torch.Tensor) -> torch.Tensor:
            s = s.double().clamp_min(1.0)
            return lr * warmup ** 0.5 * torch.minimum(s ** -0.5, s * warmup ** -1.5)

    else:
        raise ValueError(cfg.lr_schedule)

    def schedule(step):
        if isinstance(step, torch.Tensor):
            return sched(step)
        return float(sched(torch.tensor(step, dtype=torch.int64)))

    return schedule


def finetune_optim(cfg: FinetuneConfig) -> OptimConfig:
    """The fine-tuning optimizer, ``clip_by_global_norm(cfg.grad_norm)`` then
    ``optax.adamw(cfg.learning_rate, weight_decay=cfg.weight_decay,
    mu_dtype=bfloat16)``: a constant learning rate and optax's defaults,
    betas (0.9, 0.999) and eps 1e-8, not pretraining's betas. optax's
    ``mask=None`` decays every parameter: pair it with ``decay_all=True``."""
    return OptimConfig(learning_rate=cfg.learning_rate, betas=(0.9, 0.999),
                       weight_decay=cfg.weight_decay, grad_norm=cfg.grad_norm,
                       lr_schedule="constant", mu_dtype="bfloat16")


def decay_mask(module: nn.Module) -> Dict[str, bool]:
    """``{parameter name: decayed}`` by the parameter's flax path, with the
    JAX package's rule (``_decay_mask``): no decay for biases or for anything
    under a module named ``ln``, ``*_ln`` or ``LayerNorm``."""
    out = {}
    for name, path in flax_paths(module).items():
        norm = any(n == "ln" or n.endswith("_ln") or n == "LayerNorm" for n in path)
        out[name] = path[-1] != "bias" and not norm
    return out


def parse_optim(cfg: OptimConfig) -> Tuple[str, str]:
    """(base, wrapper) of ``cfg.optim``; raises on a name the JAX factory
    does not know and on the low-precision knobs that are not ported."""
    base, _, wrapper = cfg.optim.partition("+")
    if base not in BASES:
        raise ValueError(f"unknown optimizer: {cfg.optim}")
    if wrapper not in WRAPPERS:
        raise ValueError(f"unknown optimizer wrapper: {wrapper}")
    if cfg.gradient_accumulation_steps < 1:
        raise ValueError(f"gradient_accumulation_steps {cfg.gradient_accumulation_steps} < 1")
    changed = [f"{k}={getattr(cfg, k)!r}" for k, off in LOW_PRECISION_KNOBS.items()
               if getattr(cfg, k) != off]
    if changed:
        raise NotImplementedError(
            f"{', '.join(changed)}: the JAX package's scale_by_adam_lp and "
            "fused_adamw_clip update paths are not ported")
    return base, wrapper


def _norms(tensors: Tensors) -> torch.Tensor:
    """(N,) float32 L2 norms, one per tensor."""
    return torch.stack(torch._foreach_norm(tensors))


class Optimizer:
    """The optimizer ``cfg.optim`` over ``params`` (float32);
    ``decayed[i]`` says whether ``params[i]`` takes weight decay. ``update``
    is one call of the optax chain's ``update`` followed by
    ``apply_updates``."""

    def __init__(self, params: Sequence[torch.Tensor], decayed: Sequence[bool],
                 cfg: OptimConfig):
        self.base, wrapper = parse_optim(cfg)
        self.params = list(params)
        self.decayed = list(decayed)
        self.sched = lr_schedule(cfg)
        self.b1, self.b2 = cfg.betas
        self.eps = 1e-6 if self.base == "lamb" else 1e-8  # optax.lamb's default
        self.weight_decay = cfg.weight_decay
        self.k = cfg.gradient_accumulation_steps
        mu_dtype = getattr(torch, cfg.mu_dtype) if self.base == "adamw" else torch.float32
        self.mu = self._zeros(mu_dtype)
        self.b1_mu = torch.tensor(self.b1, dtype=mu_dtype).item()  # b1 as optax's m sees it
        self.nu = self._zeros(torch.float32)
        # the transforms after the base, in the chain's order, with their state:
        # lookahead's slow copy is seeded from the parameters, ema's is zeros
        self.post = (["lookahead"] if self.base == "rangerlars" else []) + (
            [wrapper] if wrapper else [])
        self.post_state = [[p.detach().clone() for p in self.params] if kind == "lookahead"
                           else self._zeros(torch.float32) for kind in self.post]
        self.acc = self._zeros(torch.float32) if self.k > 1 else []
        self.count = 0      # updates applied (optax's inner ``count``)
        self.mini_step = 0  # calls folded into ``acc`` since the last update
        # the same two counts on the parameters' device, read by the update
        device = self.params[0].device
        self.count_on_device = torch.zeros((), dtype=torch.int64, device=device)
        self.mini_step_on_device = torch.zeros((), dtype=torch.int64, device=device)
        self._t: torch.Tensor = self.count_on_device  # float64 count of the update being made

    def _zeros(self, dtype) -> Tensors:
        return [torch.zeros_like(p, dtype=dtype) for p in self.params]

    def buffers(self) -> Dict[str, Tensors]:
        """The state tensors by name (``mu``, ``nu``, ``<wrapper>_<i>``, ``acc``)."""
        out = {"mu": self.mu, "nu": self.nu}
        out.update({f"{kind}_{i}": bufs for i, (kind, bufs)
                    in enumerate(zip(self.post, self.post_state))})
        if self.k > 1:
            out["acc"] = self.acc
        return out

    def device_state(self) -> Tensors:
        """Every tensor an update writes: the state buffers and the device
        counts (a graph's warm-up saves and restores them)."""
        return [t for bufs in self.buffers().values() for t in bufs] + [
            self.count_on_device, self.mini_step_on_device]

    @property
    def moves_next(self) -> bool:
        """Whether the next call moves the parameters (every call, or with
        accumulation the k-th since the last update)."""
        return self.mini_step == self.k - 1

    def set_counts(self, count: int, mini_step: int) -> None:
        """Set the host counts and their device copies."""
        self.count, self.mini_step = int(count), int(mini_step)
        self.count_on_device.fill_(self.count)
        self.mini_step_on_device.fill_(self.mini_step)

    def advance(self, moved: bool) -> None:
        """The host counts after a call that ``moved`` the parameters or not
        (``update`` has advanced the device counts)."""
        if moved:
            self.count += 1
            self.mini_step = 0
        else:
            self.mini_step += 1

    @torch.no_grad()
    def update(self, grads: Tensors, moves: Optional[bool] = None) -> bool:
        """Fold ``grads`` (same order as the parameters) into the running
        mean and, if the call ``moves`` the parameters (every call, or every
        k-th with accumulation), update them from it; returns ``moves``.
        The device work reads and writes the device counts only. Without
        ``moves`` the host decides (``moves_next``) and then ``advance``s its
        counts; given ``moves``, the host counts are left to the caller:
        what a CUDA graph captures, the caller advancing them per replay."""
        advance = moves is None
        if advance:
            moves = self.moves_next
        if self.k > 1:
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, (self.mini_step_on_device + 1).float())
            torch._foreach_add_(self.acc, delta)
            grads = self.acc
            if not moves:
                self.mini_step_on_device.add_(1)
        if moves:
            lr = self.sched(self.count_on_device)
            self.count_on_device.add_(1)
            self._t = self.count_on_device.double()
            upd, scale = getattr(self, f"_{self.base}")(grads, lr)
            if scale is not None:
                torch._foreach_mul_(upd, scale.float())
            for kind, state in zip(self.post, self.post_state):
                upd = getattr(self, f"_{kind}")(upd, state)
            torch._foreach_add_(self.params, upd)
            if self.k > 1:
                torch._foreach_zero_(self.acc)
                self.mini_step_on_device.zero_()
        if advance:
            self.advance(moves)
        return moves

    # ------------------------------------------------ bases: (u, scale), update = scale * u
    # ``scale`` is a device scalar, or None for 1; the step ``self._t`` and
    # the scalars derived from it are float64 device scalars, cast to
    # float32 where a float32 tensor list takes them (as a Python float is)
    def _pick(self, tensors: Tensors) -> Tensors:
        return [t for t, d in zip(tensors, self.decayed) if d]

    def _l2_decayed(self, grads: Tensors) -> Tensors:
        """``add_decayed_weights`` before the moments: ``g + wd * p``."""
        if not self.weight_decay:
            return grads
        return [torch.add(g, p, alpha=self.weight_decay) if d else g
                for g, p, d in zip(grads, self.params, self.decayed)]

    def _moments(self, grads: Tensors) -> None:
        """float32 ``m = (1 - b1) g + b1 m`` and ``v = (1 - b2) g^2 + b2 v``."""
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)

    def _bias_correction(self, beta: float) -> torch.Tensor:
        """``1 - beta^t``, float64."""
        return 1.0 - beta ** self._t

    @staticmethod
    def _select(denom: Tensors, use: torch.Tensor) -> None:
        """``denom`` where ``use`` (a boolean scalar), else 1, in place and
        exactly: ``denom * 1 + 0`` or ``denom * 0 + 1``."""
        use = use.float()
        torch._foreach_mul_(denom, use)
        torch._foreach_add_(denom, 1.0 - use)

    def _adam_direction(self, m: Tensors) -> Tensors:
        """``(m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)``."""
        denom = torch._foreach_div(self.nu, self._bias_correction(self.b2).float())
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(m, self._bias_correction(self.b1).float())
        torch._foreach_div_(upd, denom)
        return upd

    def _adamw(self, grads: Tensors, lr: torch.Tensor):
        m = [t.float() for t in self.mu]
        torch._foreach_mul_(m, self.b1_mu)
        torch._foreach_add_(m, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        upd = self._adam_direction(m)
        if self.weight_decay and any(self.decayed):
            torch._foreach_add_(self._pick(upd), self._pick(self.params), alpha=self.weight_decay)
        for dst, src in zip(self.mu, m):
            dst.copy_(src)
        return upd, -lr

    def _adam(self, grads: Tensors, lr: torch.Tensor):
        self._moments(self._l2_decayed(grads))
        return self._adam_direction(self.mu), -lr

    def _adamax(self, grads: Tensors, lr: torch.Tensor):
        g = self._l2_decayed(grads)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - self.b1)
        bound = torch._foreach_abs(g)
        torch._foreach_add_(bound, self.eps)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_maximum_(self.nu, bound)
        upd = torch._foreach_div(self.mu, self._bias_correction(self.b1).float())
        torch._foreach_div_(upd, self.nu)
        return upd, -lr

    def _radam(self, grads: Tensors, lr: torch.Tensor):
        self._moments(self._l2_decayed(grads))
        t, b2 = self._t, self.b2
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = b2 ** t
        ro = ro_inf - 2.0 * t * b2t / (1.0 - b2t)
        use = ro >= 5.0  # rectify
        r = torch.sqrt(((ro - 4.0) * (ro - 2.0) * ro_inf
                        / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro)).clamp_min(0.0))
        upd = torch._foreach_div(self.mu, self._bias_correction(self.b1).float())
        denom = torch._foreach_div(self.nu, (1.0 - b2t).float())
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        self._select(denom, use)
        torch._foreach_mul_(upd, torch.where(use, r, 1.0).float())
        torch._foreach_div_(upd, denom)
        return upd, -lr

    def _lamb(self, grads: Tensors, lr: torch.Tensor):
        self._moments(grads)
        upd = self._adam_direction(self.mu)
        if self.weight_decay and any(self.decayed):
            torch._foreach_add_(self._pick(upd), self._pick(self.params), alpha=self.weight_decay)
        p_norm, u_norm = _norms(self.params), _norms(upd)
        ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                            p_norm / u_norm)
        torch._foreach_mul_(upd, list(ratio.unbind()))
        return upd, -lr

    def _ralamb(self, grads: Tensors, lr: torch.Tensor):
        self._moments(grads)
        t, b2 = self._t, self.b2
        beta2_t = b2 ** t
        n_sma_max = 2.0 / (1.0 - b2) - 1.0
        n_sma = n_sma_max - 2.0 * t * beta2_t / (1.0 - beta2_t)
        use_rect = n_sma >= 5.0
        rect = torch.sqrt(((1.0 - beta2_t) * (n_sma - 4.0) / (n_sma_max - 4.0)
                           * (n_sma - 2.0) / n_sma * n_sma_max / (n_sma_max - 2.0)
                           ).clamp_min(0.0))
        step_lr = torch.where(use_rect, rect, 1.0) / self._bias_correction(self.b1) * lr
        # the rectified direction m / (sqrt(v) + eps), else m itself
        denom = torch._foreach_sqrt(self.nu)
        torch._foreach_add_(denom, self.eps)
        self._select(denom, use_rect)
        direction = torch._foreach_div(self.mu, denom)
        # p1: the parameters after the lr-scaled decay; the trust ratio
        # compares ||p|| (clipped to 10) with the candidate p1 - step * dir
        p1 = torch._foreach_mul(self.params, (self.weight_decay * lr).float())
        kept = [q for q, d in zip(p1, self.decayed) if not d]
        if kept:
            torch._foreach_mul_(kept, 0.0)
        p1 = torch._foreach_sub(self.params, p1)
        step = torch._foreach_mul(direction, step_lr.float())
        w_norm = _norms(self.params).clamp(0.0, 10.0)
        r_norm = _norms(torch._foreach_sub(p1, step))
        trust = torch.where((w_norm == 0) | (r_norm == 0), torch.ones_like(w_norm),
                            w_norm / r_norm)
        torch._foreach_mul_(step, list(trust.unbind()))
        upd = torch._foreach_sub(p1, self.params)
        torch._foreach_sub_(upd, step)
        return upd, None

    def _rangerlars(self, grads: Tensors, lr: torch.Tensor):
        return self._ralamb(grads, lr)  # its lookahead is the first post transform

    # ------------------------------------------------ wrappers: updates -> updates
    def _lookahead(self, upd: Tensors, slow: Tensors) -> Tensors:
        """Every ``LOOKAHEAD_K``-th update: the slow copy moves half way to
        the fast parameters and the update lands them on it; else ``upd``.
        ``sync`` (1 or 0) selects exactly, as ``_select`` does."""
        sync = (self.count_on_device % LOOKAHEAD_K == 0).float()
        pull = torch._foreach_add(self.params, upd)
        torch._foreach_sub_(pull, slow)
        torch._foreach_mul_(pull, LOOKAHEAD_ALPHA)
        torch._foreach_mul_(pull, sync)
        torch._foreach_add_(slow, pull)
        landed = torch._foreach_sub(slow, self.params)
        torch._foreach_mul_(landed, sync)
        torch._foreach_mul_(upd, 1.0 - sync)
        torch._foreach_add_(upd, landed)
        return upd

    def _ema(self, upd: Tensors, ema: Tensors) -> Tensors:
        torch._foreach_mul_(ema, EMA_DECAY)
        torch._foreach_add_(ema, upd, alpha=1.0 - EMA_DECAY)
        return ema
