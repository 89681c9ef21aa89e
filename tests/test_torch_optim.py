"""Parity of the port's optimizer family (``parallel/optim.py:Optimizer``
through ``parallel/train_step.py:TrainState``) with the JAX package's
``make_optimizer(cfg, include_clip=False)``: every base and wrapper the
JAX factory builds, with gradient accumulation (``optax.MultiSteps``) at
k = 1, 2 and 3.

The same float32 parameters (a small ``BertLayer`` and an ``Embed``:
fused QKV, decayed kernels, undecayed biases and LayerNorms, one all-zero
bias for the trust ratios' zero branch) take the same sequence of 7 x k
gradients (7 updates, so lookahead syncs at the 6th) under the linear and
the noam schedules. The port's ``TrainState`` clips first: a clip norm far
above every gradient's norm scales by exactly 1.

Tolerances: parameters after every call within rtol 1e-5, atol 1e-7 (float32
in another order: optax evaluates scalars such as ``b2**t`` and the
schedule in float32, the port in float64); a call that does not update
leaves every parameter bit-equal; a run checkpointed after 3 calls and
resumed in a fresh state ends bit-equal to the unbroken run; the device
work of a call alone (``apply_gradients(moves)``, what a CUDA graph
captures), with the host counts left at 0, moves the parameters bit for bit
as the whole call does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from vln_bevbert_tpu.configs import OptimConfig as JaxOptimConfig
from vln_bevbert_tpu.parallel.optim import _decay_mask, make_optimizer
from vln_bevbert_tpu_torch.configs import ModelConfig, OptimConfig
from vln_bevbert_tpu_torch.convert import flax_to_state_dict, module_to_flax
from vln_bevbert_tpu_torch.models.bert import BertLayer, Embed
from vln_bevbert_tpu_torch.parallel.optim import Optimizer
from vln_bevbert_tpu_torch.parallel.train_step import (
    TrainState,
    load_checkpoint,
    save_checkpoint,
)

NAMES = ["radam", "lamb", "ralamb", "rangerlars", "adam", "adamax", "adamw+ema",
         "adamw+lookahead", "ralamb+lookahead"]
UPDATES = 7
CFG = ModelConfig(hidden_size=8, num_attention_heads=2, intermediate_size=16,
                  dtype="float32")


class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.layer = BertLayer(CFG)
        self.emb = Embed(CFG, 5)


def make_tiny(seed=0) -> Tiny:
    model = Tiny()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 0.5, p.shape).astype(np.float32)))
        model.layer.attn.out_ln.bias.zero_()  # ||p|| == 0
    return model


def configs(name, k, schedule):
    kw = dict(optim=name, learning_rate=0.01, warmup_steps=3, num_train_steps=12,
              weight_decay=0.1, grad_norm=1e9, lr_schedule=schedule,
              gradient_accumulation_steps=k)
    return JaxOptimConfig(**kw), OptimConfig(**kw)


def grad_trees(tree, n, seed=1):
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
            for _ in range(n)]


def port_call(model, state, grads):
    named = dict(model.named_parameters())
    for name, g in flax_to_state_dict(grads).items():
        named[name].grad.copy_(g)
    state.apply_gradients()


def snapshot(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("name", NAMES)
def test_optimizer_matches_optax(name, k, tmp_path):
    for schedule in ("linear", "noam"):
        jax_cfg, cfg = configs(name, k, schedule)
        model = make_tiny()
        tree = module_to_flax(model)
        tx = make_optimizer(jax_cfg, params_for_mask=tree, include_clip=False)
        params = jax.tree.map(jnp.asarray, tree)
        opt_state = tx.init(params)

        @jax.jit
        def jax_call(params, opt_state, g):
            upd, opt_state = tx.update(g, opt_state, params)
            return optax.apply_updates(params, upd), opt_state

        state = TrainState(model, cfg)
        grads = grad_trees(tree, UPDATES * k)
        saved = None
        for i, g in enumerate(grads):
            before = snapshot(model)
            params, opt_state = jax_call(params, opt_state, g)
            port_call(model, state, g)
            assert state.step == i + 1 and state.tx.count == (i + 1) // k
            ref = flax_to_state_dict(jax.tree.map(np.asarray, params))
            for n, p in model.named_parameters():
                if (i + 1) % k:  # accumulating: nothing moves
                    assert torch.equal(p.detach(), before[n]), (schedule, i, n)
                np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(), rtol=1e-5,
                                           atol=1e-7, err_msg=f"{schedule} call {i} {n}")
            if i == 2:
                saved = save_checkpoint(str(tmp_path / f"ckpt_{schedule}"), model, state,
                                        step=state.step)
        assert state.tx.count == UPDATES
        assert sum(not torch.equal(p.detach(), q) for p, q in
                   zip(model.parameters(), make_tiny().parameters())) == len(before)

        # resume from the checkpoint of call 3 in a fresh model and state
        ckpt = load_checkpoint(saved, "cpu")
        resumed = make_tiny(seed=7)
        resumed.load_state_dict(ckpt["params"])
        state2 = TrainState(resumed, cfg)
        state2.load_state_dict(ckpt["opt_state"])
        assert state2.step == ckpt["step"] == 3 and state2.tx.mini_step == 3 % k
        for g in grads[3:]:
            port_call(resumed, state2, g)
        for (n, p), q in zip(model.named_parameters(), resumed.parameters()):
            assert torch.equal(p.detach(), q.detach()), (schedule, n)


def test_decay_mask_reaches_the_optimizer():
    """The JAX mask of the tiny tree and the port's ``decayed`` flags agree:
    kernels and embeddings decay, biases and LayerNorms do not."""
    model = make_tiny()
    state = TrainState(model, OptimConfig(optim="lamb"))
    mask = flax_to_state_dict(jax.tree.map(lambda b: np.float32(b),
                                           _decay_mask(module_to_flax(model))))
    assert [bool(mask[n]) for n in state.names] == state.tx.decayed
    assert any(state.tx.decayed) and not all(state.tx.decayed)


@pytest.mark.parametrize("field,value", [("nu_dtype", "bfloat16"), ("grad_dtype", "bfloat16"),
                                         ("state_sr", True), ("fused_update", True)])
def test_low_precision_paths_are_refused(field, value):
    """The JAX package's ``scale_by_adam_lp`` / ``fused_adamw_clip`` paths are
    not ported: selecting one raises and names the field."""
    with pytest.raises(NotImplementedError, match=field):
        Optimizer([torch.zeros(2)], [True], OptimConfig(**{field: value}))
    for bad in ("sgd", "adamw+swa"):
        with pytest.raises(ValueError, match="unknown optimizer"):
            Optimizer([torch.zeros(2)], [True], OptimConfig(optim=bad))


def test_adamw_bf16_moment_matches_the_jitted_step():
    """AdamW's bfloat16 first moment as the jitted JAX step stores it: ``b1``
    rounded to bfloat16, ``b1 * m`` taken in float32. Rounding that product
    to bfloat16 (eager optax) stores another moment in a third of the
    elements; here at most 0.1% may differ (float32 fused multiply-adds that
    flip a rounding)."""
    jax_cfg, cfg = configs("adamw", 1, "linear")
    model = make_tiny()
    tree = module_to_flax(model)
    tx = make_optimizer(jax_cfg, params_for_mask=tree, include_clip=False)
    params = jax.tree.map(jnp.asarray, tree)
    opt_state = tx.init(params)
    call = jax.jit(lambda p, s, g: tx.update(g, s, p))
    state = TrainState(model, cfg)
    for g in grad_trees(tree, 3):
        upd, opt_state = call(params, opt_state, g)
        params = optax.apply_updates(params, upd)
        port_call(model, state, g)
    adam = next(s for s in jax.tree.leaves(opt_state, is_leaf=lambda s: isinstance(
        s, optax.ScaleByAdamState)) if isinstance(s, optax.ScaleByAdamState))
    ref = flax_to_state_dict(jax.tree.map(lambda a: np.asarray(a, np.float32), adam.mu))
    differ = total = 0
    for name, mu in zip(state.names, state.tx.mu):
        assert mu.dtype == torch.bfloat16
        differ += int((mu.float() != ref[name]).sum())
        total += mu.numel()
    assert differ <= 1e-3 * total, (differ, total)


def test_checkpoints_of_earlier_releases_still_load(tmp_path):
    """An AdamW optimizer state as earlier releases wrote it (``mu``, ``nu``
    and ``count``, no ``mini_step``) loads, and the run goes on as if it
    had not been interrupted."""
    _, cfg = configs("adamw", 1, "linear")
    model, grads = make_tiny(), grad_trees(module_to_flax(make_tiny()), 4)
    state = TrainState(model, cfg)
    for g in grads[:2]:
        port_call(model, state, g)
    old = {k: v for k, v in state.state_dict().items() if k in ("mu", "nu", "count")}
    path = save_checkpoint(str(tmp_path / "ckpt_2"), model, state, step=2)
    ckpt = load_checkpoint(path, "cpu")
    resumed = make_tiny(seed=3)
    resumed.load_state_dict(ckpt["params"])
    state2 = TrainState(resumed, cfg)
    state2.load_state_dict(old)
    assert state2.step == 2 and state2.tx.mini_step == 0
    for g in grads[2:]:
        port_call(model, state, g)
        port_call(resumed, state2, g)
    for p, q in zip(model.parameters(), resumed.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name", ["adamw"] + NAMES)
def test_device_update_reads_no_host_count(name, k):
    """What a captured graph replays: ``apply_gradients(moves)`` with the
    host counts never advanced (a graph captured at call 0 would freeze
    every host value it read) moves the parameters bit for bit as
    ``apply_gradients`` does, for every call of 7 updates: the schedule,
    bias corrections, rectification, lookahead's sync and the accumulation
    mean come from the device counts alone."""
    _, cfg = configs(name, k, "linear")
    eager, graphed = make_tiny(), make_tiny()
    s_eager, s_graphed = TrainState(eager, cfg), TrainState(graphed, cfg)
    for i, g in enumerate(grad_trees(module_to_flax(eager), UPDATES * k)):
        port_call(eager, s_eager, g)
        named = dict(graphed.named_parameters())
        for n, grad in flax_to_state_dict(g).items():
            named[n].grad.copy_(grad)
        s_graphed.apply_gradients(moves=(i + 1) % k == 0)
        for p, q in zip(graphed.parameters(), eager.parameters()):
            assert torch.equal(p, q), (name, k, i)
    assert (s_graphed.tx.count, s_graphed.tx.mini_step) == (0, 0)
    assert int(s_graphed.tx.count_on_device) == s_eager.tx.count == UPDATES
