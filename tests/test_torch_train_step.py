"""Parity of the port's optimizer and train step (vln_bevbert_tpu_torch.parallel)
with the JAX package: the learning-rate schedules, the weight-decay mask,
the clip + AdamW update on the same gradients, and three full steps
(lift-splat, forward, backward, float32 global-norm clip at 5.0, AdamW with a
bfloat16 first moment) against
``vln_bevbert_tpu.parallel.train_step.make_pretrain_step``, from the same
parameters on the same batch, with every dropout rate 0.

The full steps start from JAX's initial parameters plus N(0, 0.02) noise:
at JAX's init (zero biases) a LayerNorm over an all-zero input, as in an
empty BEV cell, has gradients of order 1/sqrt(eps) = 1e6, which turn float32
rounding into visible differences after one update.

Tolerances: schedules at rtol 1e-6 (optax evaluates them in float32, the
port in float64). The update on the same gradients: parameters at atol 1e-8
(plus two float32 ulps) for all but 0.1% of the elements and 4e-7 for those (the clip's
scale differs in the last float32 bit, so now and then the float32 first
moment rounds to the neighbouring bfloat16, which moves an update of <= lr =
5e-5 by <= 2**-7 of it); the bfloat16 first moment at two bfloat16 ulps
(rtol 2**-6: a flipped rounding carries into the next step's) plus 2**-7
of the tensor's largest entry (a flip in a large ``b1 m`` stays as an
absolute error where ``(1 - b1) g`` cancels it); the float32 second moment
at rtol 1e-6. Three full steps (measured:
``loss``/``grad_norm`` within 4e-7, parameters within 1.7e-6, second moments
within 2.2e-6 and first moments within 1.4e-2 of each tensor's largest
entry): ``loss`` and ``grad_norm`` at rtol 1e-5; parameters at atol 4e-6
(Adam's normalised update turns float32 gradient noise into update noise of
up to ~lr where a gradient element is near zero); the first moment as on
the same gradients, the second at rtol 1e-4 plus 1e-5 of the tensor's
largest entry. The biases whose gradient is zero by the softmax's
shift invariance (``SHIFT_INVARIANT``) hold float32 noise that Adam
normalises to steps of ~lr in either direction; they are held only to a
bound on such steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_pretrain import SHAPES, TINY, make_batch, tiny_cfg, tt
from vln_bevbert_tpu.configs import OptimConfig
from vln_bevbert_tpu.parallel.optim import _decay_mask
from vln_bevbert_tpu.parallel.optim import lr_schedule as jax_lr_schedule
from vln_bevbert_tpu.parallel.train_step import init_pretrain_state as jax_init
from vln_bevbert_tpu.parallel.train_step import make_pretrain_step as jax_make_step
from vln_bevbert_tpu_torch.convert import flax_paths, flax_to_state_dict, load_flax_params
from vln_bevbert_tpu_torch.models.glocal import GlocalTextPathCMTPreTraining
from vln_bevbert_tpu_torch.parallel.optim import decay_mask, lr_schedule
from vln_bevbert_tpu_torch.parallel.train_step import (
    TrainState,
    build_projector,
    make_pretrain_step,
)

STEPS = ("mlm", "sap", "masksem")
# biases whose gradient is zero up to rounding: a softmax ignores a shift
# shared by all its inputs (the SAP node logits, the attention scores)
SHIFT_INVARIANT = ("global_sap_head.fc2.bias", "global_sap_head.ln.bias",
                   "bert.global_encoder.sprel_linear.bias")


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("kind", ["linear", "noam"])
def test_lr_schedule_matches_optax(kind):
    """At an int step (the host's logs) and at an int64 step tensor (what the
    update reads from its device count)."""
    cfg = OptimConfig(lr_schedule=kind, warmup_steps=4, num_train_steps=12)
    ref, ours = jax_lr_schedule(cfg), lr_schedule(cfg)
    for step in range(16):
        want = float(ref(jnp.asarray(step)))
        np.testing.assert_allclose(ours(step), want, rtol=1e-6, atol=1e-12,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(float(ours(torch.tensor(step))), want, rtol=1e-6,
                                   atol=1e-12, err_msg=f"step {step}")


@pytest.fixture(scope="module")
def jax_setup():
    """(cfg, batch, JAX model, projector, JAX TrainState, noisy numpy params).
    The jitted JAX step donates its state: tests build theirs with ``fresh``."""
    cfg = tiny_cfg()
    batch = make_batch()
    model, projector, state = jax_init(cfg, batch)
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.02, a.shape)).astype(np.float32),
        state.params)
    return cfg, batch, model, projector, state, params


def fresh(state, params):
    """The JAX TrainState at step 0 on new copies of ``params``, and the port's
    model and TrainState on the same values."""
    p = jax.tree.map(jnp.asarray, params)
    jax_state = state.replace(step=jnp.zeros((), jnp.int32), params=p,
                              opt_state=state.tx.init(p))
    ours = GlocalTextPathCMTPreTraining(TINY, tiny_cfg().tasks)
    load_flax_params(ours, params)
    ours.train()
    return jax_state, ours, TrainState(ours, tiny_cfg().optim)


def test_decay_mask_matches_jax(jax_setup):
    *_, params = jax_setup
    ours = GlocalTextPathCMTPreTraining(TINY, tiny_cfg().tasks)
    ref = _decay_mask(params)
    mask = decay_mask(ours)
    paths = flax_paths(ours)
    assert set(mask) == {n for n, _ in ours.named_parameters()}
    for name, decayed in mask.items():
        assert decayed == bool(_leaf(ref, paths[name])), name
    assert not mask["bert.local_encoder.x_layer_0.self_attn.out_ln.weight"]
    assert not mask["mlm_head.bias"] and mask["mlm_head.transform.weight"]


def _adam_state(opt_state):
    return next(s for s in opt_state if isinstance(s, optax.ScaleByAdamState))


def _compare_state(ours, our_state, jax_state, p_atol, mu_rtol, floor, nu_rtol,
                   p_tight=None, skip=()):
    """Parameters within ``p_atol`` (and, with ``p_tight``, at most 0.1% of
    all elements beyond ``p_tight`` plus two float32 ulps); moments within
    their rtol plus ``floor`` times the tensor's largest entry."""
    params_ref = flax_to_state_dict(jax.tree.map(np.asarray, jax_state.params))
    adam = _adam_state(jax_state.opt_state)
    mu_ref = flax_to_state_dict(jax.tree.map(lambda a: np.asarray(a, np.float32), adam.mu))
    nu_ref = flax_to_state_dict(jax.tree.map(np.asarray, adam.nu))
    beyond = total = 0
    for i, (name, p) in enumerate(ours.named_parameters()):
        if name in skip:
            continue
        got, ref = p.detach().numpy(), params_ref[name].numpy()
        np.testing.assert_allclose(got, ref, atol=p_atol, rtol=0, err_msg=name)
        if p_tight is not None:
            beyond += int((np.abs(got - ref) > p_tight + 2 ** -22 * np.abs(ref)).sum())
            total += got.size
        mu, nu = our_state.tx.mu[i], our_state.tx.nu[i]
        assert mu.dtype == torch.bfloat16 and nu.dtype == torch.float32
        ref_mu, ref_nu = mu_ref[name].numpy(), nu_ref[name].numpy()
        np.testing.assert_allclose(mu.float().numpy(), ref_mu, rtol=mu_rtol,
                                   atol=floor[0] * float(np.abs(ref_mu).max()), err_msg=name)
        np.testing.assert_allclose(nu.numpy(), ref_nu, rtol=nu_rtol,
                                   atol=floor[1] * float(np.abs(ref_nu).max()), err_msg=name)
    assert beyond <= 1e-3 * total, (beyond, total)


def test_clip_and_adamw_match_optax_on_the_same_gradients(jax_setup):
    cfg, batch, model, projector, state, params = jax_setup
    jax_state, ours, our_state = fresh(state, params)
    jax_apply = jax.jit(lambda s, g: s.apply_gradients(g))  # as the jitted step runs it
    rng = np.random.default_rng(2)
    for _ in range(3):
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        for name, g in flax_to_state_dict(grads).items():
            dict(ours.named_parameters())[name].grad.copy_(g)
        gnorm = our_state.apply_gradients()
        jax_state, ref_norm = jax_apply(jax_state, jax.tree.map(jnp.asarray, grads))
        assert float(ref_norm) > cfg.optim.grad_norm  # the clip acts
        np.testing.assert_allclose(float(gnorm), float(ref_norm), rtol=1e-6)
    assert our_state.step == int(jax_state.step) == 3
    assert all(float(p.grad.abs().max()) == 0 for p in our_state.params)
    _compare_state(ours, our_state, jax_state, p_atol=4e-7, p_tight=1e-8,
                   mu_rtol=2 ** -6, nu_rtol=1e-6, floor=(2 ** -7, 0.0))


def test_three_clipped_adamw_steps_match_jax(jax_setup):
    cfg, batch, model, projector, state, params = jax_setup
    jax_state, ours, our_state = fresh(state, params)
    our_step = make_pretrain_step(ours, build_projector(TINY, SHAPES))
    jax_step = jax_make_step(model, projector)
    start = {n: p.detach().clone() for n, p in ours.named_parameters()}
    norms = []
    for task in STEPS:
        jax_state, ref = jax_step(jax_state, batch, jax.random.key(0), task)
        got = our_step(our_state, tt(batch), task)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(got[key]), float(ref[key]), rtol=1e-5,
                                       err_msg=f"{task} {key}")
        norms.append(float(ref["grad_norm"]))
    assert our_state.step == int(jax_state.step) == 3
    assert max(norms) > cfg.optim.grad_norm  # the clip acted
    _compare_state(ours, our_state, jax_state, p_atol=4e-6, mu_rtol=2 ** -6,
                   nu_rtol=1e-4, floor=(2 ** -7, 1e-5), skip=SHIFT_INVARIANT)
    params_ref = flax_to_state_dict(jax.tree.map(np.asarray, jax_state.params))
    lr_sum = sum(our_state.tx.sched(t) for t in range(3))
    for name in SHIFT_INVARIANT:
        p = dict(ours.named_parameters())[name].detach()
        assert float((p - params_ref[name]).abs().max()) <= 6 * lr_sum, name
    moved = sum(not torch.equal(p.detach(), start[n]) for n, p in ours.named_parameters())
    assert moved > len(start) // 2  # the learning rate left the warmup's 0
