"""Learning-rate schedules, the weight-decay mask and AdamW with a bfloat16
first moment (port of the ``adamw`` path of ``vln_bevbert_tpu/parallel/optim.py``).

``AdamW`` computes what ``optax.adamw(mu_dtype=...)`` computes, written as
``torch._foreach_*`` tensor ops because ``torch.optim.AdamW`` keeps its first
moment in float32:

- ``m = (1 - b1) * g + b1 * m`` where ``b1 * m`` is a product in the
  moment's storage dtype before the float32 add (``optax.tree.update_moment``
  on a bfloat16 ``m``: JAX casts the Python scalar ``b1`` to bfloat16, 0.9 ->
  0.8984375, and rounds the product to bfloat16), ``v = (1 - b2) * g^2 +
  b2 * v`` in float32;
- ``u = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)`` from the float32
  ``m``, which is then rounded to its storage dtype;
- ``u += weight_decay * p`` where the mask allows it, then
  ``p -= lr(t - 1) * u`` (optax evaluates the schedule at the count before
  the increment).

The step count and the learning rate live on the host, so an update queues
device work and reads nothing back. The optimizer family beyond ``adamw`` is
not ported yet.

Fine-tuning builds its optimizer in the agent rather than from an
``OptimConfig`` (JAX ``nav/agent.py:225-232``); ``finetune_optim`` states it
as one: a constant learning rate, optax's default betas and weight decay on
every parameter.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
from torch import nn

from ..configs import FinetuneConfig, OptimConfig
from ..convert import flax_paths


def lr_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """step -> learning rate: "linear" warmup from 0 then linear decay to 0
    at ``num_train_steps`` (optax.join_schedules of two linear schedules),
    "noam", or "constant"."""
    lr, warmup, total = cfg.learning_rate, cfg.warmup_steps, cfg.num_train_steps
    if cfg.lr_schedule == "constant":
        return lambda step: lr
    if cfg.lr_schedule == "linear":
        decay_steps = max(total - warmup, 1)

        def linear(step: int) -> float:
            if step < warmup:
                return lr * step / warmup
            return lr * (1.0 - min(step - warmup, decay_steps) / decay_steps)

        return linear
    if cfg.lr_schedule == "noam":

        def noam(step: int) -> float:
            s = max(step, 1)
            return lr * warmup ** 0.5 * min(s ** -0.5, s * warmup ** -1.5)

        return noam
    raise ValueError(cfg.lr_schedule)


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


class AdamW:
    """AdamW over ``params`` (float32) with moments stored as
    ``cfg.mu_dtype`` / float32; ``decayed[i]`` says whether ``params[i]``
    takes weight decay."""

    def __init__(self, params: Sequence[torch.Tensor], decayed: Sequence[bool],
                 cfg: OptimConfig):
        if cfg.optim != "adamw" or cfg.gradient_accumulation_steps != 1:
            raise NotImplementedError(
                f"only adamw without gradient accumulation is ported, got "
                f"{cfg.optim!r} x{cfg.gradient_accumulation_steps}"
            )
        self.params = list(params)
        self.decayed = list(decayed)
        self.sched = lr_schedule(cfg)
        self.b1, self.b2 = cfg.betas
        self.eps = 1e-8
        self.weight_decay = cfg.weight_decay
        mu_dtype = getattr(torch, cfg.mu_dtype)
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in self.params]
        self.b1_mu = torch.tensor(self.b1, dtype=mu_dtype).item()  # b1 as optax's m sees it
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.count = 0  # updates applied (optax's ``count``)

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> None:
        """One update of every parameter from ``grads`` (same order)."""
        b1, b2 = self.b1, self.b2
        lr = self.sched(self.count)
        self.count += 1
        bc1, bc2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        m = [t.float() for t in torch._foreach_mul(self.mu, self.b1_mu)]
        torch._foreach_add_(m, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(m, bc1)
        torch._foreach_div_(upd, denom)
        if self.weight_decay and any(self.decayed):
            pick = lambda ts: [t for t, d in zip(ts, self.decayed) if d]  # noqa: E731
            torch._foreach_add_(pick(upd), pick(self.params), alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)
        for dst, src in zip(self.mu, m):
            dst.copy_(src)
