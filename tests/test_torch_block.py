"""Parity of the port's block dispatch with the JAX package's, on the CPU:
the pretraining loop (``PretrainTrainer.train`` at the default
``task_block_size`` of 8), ``make_pretrain_block_step`` in both of its
modes, ``make_replay_block``, the loop at blocks of 8 against blocks of
one, and ``graphs.capturable``, which chooses between graph replays and
eager steps. On the CPU a block runs eager steps (there is no graph); the
card tests of ``tests/test_torch_cuda.py`` hold the graphed blocks to these
eager ones.

Every dropout rate is 0, so both packages are deterministic. Parameters
start from JAX's initial ones plus N(0, 0.02) noise where a step follows
(as ``tests/test_torch_train_step.py`` explains: JAX's zero biases give
LayerNorm gradients that turn float32 rounding into visible differences).

Tolerances, float32 throughout: logged meters, losses and gradient norms
at rtol 1e-5 (``test_torch_train_step.py``'s for three full steps); the
parameters after the blocks at atol 4e-6 (that file's: Adam normalises
float32 gradient noise into update noise of up to ~lr), the biases held by
a softmax's shift invariance to a bound on such steps; replay losses at
rtol 1e-5 and parameters at atol 4e-6.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_finetune import FT_SHIFT_INVARIANT, REPLAY_CFG, padded_bundle, perturbed
from test_torch_pretrain import SHAPES, TINY, make_batch
from test_torch_train_step import SHIFT_INVARIANT
from test_torch_validate import FakeLoader, port_config
from vln_bevbert_tpu.configs import OptimConfig, PretrainConfig
from vln_bevbert_tpu.models import GlocalTextPathCMTPreTraining as JaxPreTraining
from vln_bevbert_tpu.nav.agent import GMapNavAgent as JaxAgent
from vln_bevbert_tpu.nav.agent import _EnvStub as JaxEnvStub
from vln_bevbert_tpu.nav.agent import make_replay_block as jax_make_replay_block
from vln_bevbert_tpu.parallel.optim import make_optimizer
from vln_bevbert_tpu.parallel.train_step import TrainState as JaxTrainState
from vln_bevbert_tpu.parallel.train_step import build_projector as jax_build_projector
from vln_bevbert_tpu.pretrain import PretrainTrainer as JaxTrainer
from vln_bevbert_tpu.pretrain import trainer as jax_trainer_mod
from vln_bevbert_tpu_torch.convert import flax_to_state_dict, load_flax_params, module_to_flax
from vln_bevbert_tpu_torch.models.glocal import GlocalTextPathCMTPreTraining
from vln_bevbert_tpu_torch.nav.agent import make_replay_agent, make_replay_block
from vln_bevbert_tpu_torch.parallel import distributed
from vln_bevbert_tpu_torch.parallel.train_step import (
    TrainState,
    build_projector,
    make_pretrain_block_step,
)
from vln_bevbert_tpu_torch.pretrain.trainer import PretrainTrainer, pad_block
from vln_bevbert_tpu_torch.utils import graphs

TASKS = ("mlm", "sap", "masksem")
# one layer a stack: JAX compiles one scan program per (task, block length)
MODEL = dataclasses.replace(TINY, num_sem_classes=7, hidden_size=32, intermediate_size=64,
                            num_l_layers=1, num_pano_layers=1, num_x_layers=1)
# mlm x8 then sap x8, cut by num_steps at 11: blocks (mlm, 8) and (sap, 3);
# valid_steps 5 is crossed inside both blocks, log_steps 3 likewise
SCHEDULE = ["mlm"] * 8 + ["sap"] * 8
NUM_STEPS, VALID_STEPS, LOG_STEPS = 11, 5, 3
P_ATOL, SHIFT_ATOL = 4e-6, 2e-4


class ScheduledLoader(FakeLoader):
    """``FakeLoader`` over ``SCHEDULE``'s tasks."""

    def build_batch(self, step, task=None):
        return task or SCHEDULE[step % len(SCHEDULE)], self.make(step)


def noisy(params, seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.02, a.shape)).astype(np.float32), params)


def logged(path):
    return [json.loads(line) for line in open(path / "metrics.jsonl").read().splitlines()]


def meters_of(record):
    return {k: v for k, v in record.items() if "/" in k and not k.startswith("train/")}


def compare_params(model, jax_params, atol=P_ATOL):
    ref = flax_to_state_dict(jax.tree.map(np.asarray, jax_params))
    for name, p in model.named_parameters():
        tol = SHIFT_ATOL if name in SHIFT_INVARIANT else atol
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), atol=tol, rtol=0,
                                   err_msg=name)


def initialised_with(params):
    """JAX's ``init_pretrain_state`` with ``params`` (the port's, as a flax
    tree) in place of its jitted ``init_all``, whose compile this file need
    not pay for: the model, projector, optimizer and ``TrainState`` as it
    builds them."""
    def init(cfg, batch, seed=0):
        model = JaxPreTraining(cfg.model, tasks=tuple(cfg.tasks),
                               sem_pred_token=cfg.sem_pred_token)
        tx = make_optimizer(cfg.optim, params_for_mask=params, include_clip=False)
        p = jax.tree.map(jnp.asarray, params)
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=p, opt_state=tx.init(p),
                              tx=tx, clip_norm=float(cfg.optim.grad_norm))
        return model, jax_build_projector(cfg.model, cfg.shapes), state

    return init


@pytest.fixture(scope="module")
def blocked_runs(tmp_path_factory):
    """The JAX and port trainers, both at ``task_block_size`` 8, trained to
    ``NUM_STEPS`` over ``SCHEDULE`` from the same parameters."""
    tmp = tmp_path_factory.mktemp("blocked")
    cfg = PretrainConfig(model=MODEL, shapes=SHAPES, tasks=TASKS, mix_ratio=(1, 1, 1),
                         optim=OptimConfig(warmup_steps=2, num_train_steps=NUM_STEPS),
                         train_batch_size=3, valid_steps=VALID_STEPS, log_steps=LOG_STEPS,
                         block_unroll=1)
    assert cfg.task_block_size == 8
    make = lambda step: make_batch(seed=step)  # noqa: E731
    ours = PretrainTrainer(port_config(cfg), ScheduledLoader(TASKS, make), "cpu",
                           output_dir=str(tmp / "port"))
    params = noisy(module_to_flax(ours.model))
    load_flax_params(ours.model, params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer_mod, "init_pretrain_state", initialised_with(params))
        ref = JaxTrainer(cfg, ScheduledLoader(TASKS, make), output_dir=str(tmp / "jax"))
    ref_state = ref.train()
    meters = ours.train()
    return types.SimpleNamespace(tmp=tmp, ref=ref, ref_state=ref_state, ours=ours,
                                 meters=meters, params=params)


def test_blocked_trainer_logs_and_saves_as_jax(blocked_runs):
    """At the default block size the port logs the meters JAX's
    ``_train_blocked`` logs, at the same steps (a block's end, after it
    crossed ``log_steps``), and saves the same checkpoints (a block's end,
    after it crossed ``valid_steps``); the parameters end equal."""
    tmp, ref_state, ours, meters = (blocked_runs.tmp, blocked_runs.ref_state,
                                    blocked_runs.ours, blocked_runs.meters)
    assert int(ref_state.step) == ours.state.step == NUM_STEPS
    want, got = logged(tmp / "jax"), logged(tmp / "port")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [8, 11]
    for w, g in zip(want, got):
        assert sorted(meters_of(g)) == sorted(meters_of(w))
        for key, val in meters_of(w).items():
            np.testing.assert_allclose(g[key], val, rtol=1e-5, err_msg=f"{g['step']} {key}")
    assert got[-1]["train/lr"] == ours.state.lr(NUM_STEPS)
    ckpts = lambda d: sorted(p.name for p in d.iterdir() if p.name.startswith("ckpt_"))  # noqa
    assert ckpts(tmp / "port") == ckpts(tmp / "jax") == ["ckpt_11", "ckpt_8"]
    assert sorted(meters) == sorted(meters_of(got[-1]))
    compare_params(ours.model, ref_state.params)


def test_blocked_trainer_matches_blocks_of_one(tmp_path):
    """With dropout on, the port's loop at blocks of 8 (``task_block_size``
    8) and at blocks of one (1) over the same schedule draw the same seeds
    and end with equal parameters, bit for bit (on the CPU a block runs the
    eager steps); they differ only in when they log and save, and blocks of
    one log and save at every step that reaches a multiple, as a per-step
    loop does."""
    model = dataclasses.replace(MODEL, hidden_dropout_prob=0.1,
                                attention_probs_dropout_prob=0.1, feat_dropout=0.4)
    runs = {}
    for block in (8, 1):
        cfg = PretrainConfig(model=model, shapes=SHAPES, tasks=TASKS, mix_ratio=(1, 1, 1),
                             optim=OptimConfig(warmup_steps=2, num_train_steps=NUM_STEPS),
                             train_batch_size=3, valid_steps=VALID_STEPS,
                             log_steps=LOG_STEPS, task_block_size=block)
        trainer = PretrainTrainer(port_config(cfg),
                                  ScheduledLoader(TASKS, lambda step: make_batch(seed=step)),
                                  "cpu", output_dir=str(tmp_path / str(block)))
        trainer.train()
        runs[block] = trainer
    blocked, per_step = runs[8], runs[1]
    assert blocked.state.step == per_step.state.step == NUM_STEPS
    gen = lambda t: t.model.feat_dropout.generator.get_state()  # noqa: E731
    assert torch.equal(gen(blocked), gen(per_step))
    for a, b in zip(blocked.model.parameters(), per_step.model.parameters()):
        assert torch.equal(a, b)
    assert [r["step"] for r in logged(tmp_path / "8")] == [8, 11]
    assert [r["step"] for r in logged(tmp_path / "1")] == [3, 6, 9]
    assert sorted(p.name for p in (tmp_path / "1").iterdir() if p.name.startswith("ckpt_")) \
        == ["ckpt_10", "ckpt_5"]


def test_pad_block_pads_every_axis_with_zeros():
    a = {"x": np.ones((2, 3), np.float32), "m": np.ones((2, 1), bool)}
    b = {"x": np.ones((2, 5), np.float32), "m": np.ones((2, 4), bool)}
    pa, pb = pad_block([a, b])
    assert pa["x"].shape == pb["x"].shape == (2, 5) and pa["m"].shape == (2, 4)
    assert pa["x"][:, 3:].sum() == 0 and not pa["m"][:, 1:].any() and pb["x"] is b["x"]


def fresh_jax_state(ref, params):
    p = jax.tree.map(jnp.asarray, params)
    return ref.state.replace(step=jnp.zeros((), jnp.int32), params=p,
                             opt_state=ref.state.tx.init(p))


def fresh_port(cfg, params):
    model = GlocalTextPathCMTPreTraining(cfg.model, tuple(cfg.tasks))
    load_flax_params(model, params)
    model.train()
    return model, build_projector(cfg.model, cfg.shapes), TrainState(model, cfg.optim)


@pytest.mark.parametrize("stacked", [False, True])
def test_block_step_matches_jax(blocked_runs, stacked):
    """``make_pretrain_block_step`` against JAX's (K = 3 sap steps): one
    batch re-fed, or three distinct batches. JAX runs the program its
    trainer compiled for the last block (sap, K = 3, stacked) on the
    trainer's batches, or on three copies of one batch for the re-fed mode,
    which its own tests hold equal to its unstacked mode
    (``tests/test_train_step.py``): one compile fewer."""
    ref, params = blocked_runs.ref, blocked_runs.params
    batches = [make_batch(seed=s) for s in (8, 9, 10)]
    fed = batches if stacked else [batches[0]] * 3
    host = {k: np.stack([b[k] for b in fed]) for k in fed[0]}
    s_ref, m_ref = ref.block_fn(fresh_jax_state(ref, params), host, ref.rng, task="sap",
                                length=3, stacked=True)
    model, projector, port_state = fresh_port(blocked_runs.ours.cfg, params)
    block = make_pretrain_block_step(model, projector, port_state)
    metrics = block(port_state, batches if stacked else batches[0], "sap", 3, stacked=stacked)
    assert port_state.step == int(s_ref.step) == 3
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), float(m_ref[key]), rtol=1e-5,
                                   err_msg=key)
    compare_params(model, s_ref.params)


@pytest.fixture(scope="module")
def replay_pair():
    """(JAX replay agent, numpy params) at the fine-tuning test's small
    configuration, dropout 0: the port's random parameters plus noise, set
    as JAX's ``init_params`` sets its own (whose three jitted inits this
    file need not compile), with its clip and bfloat16-moment AdamW."""
    params = perturbed(module_to_flax(make_replay_agent(REPLAY_CFG, REPLAY_CFG.batch_size,
                                                        device="cpu").model))
    agent = JaxAgent(REPLAY_CFG, JaxEnvStub(REPLAY_CFG.batch_size))
    agent.params = jax.tree.map(jnp.asarray, params)
    agent.tx = optax.chain(
        optax.clip_by_global_norm(REPLAY_CFG.grad_norm),
        optax.adamw(REPLAY_CFG.learning_rate, weight_decay=REPLAY_CFG.weight_decay,
                    mu_dtype=jnp.bfloat16))
    return agent, params


def test_replay_block_matches_jax(replay_pair):
    """``make_replay_block``: K = 3 updates over one bundle whose last steps
    are padding; the losses and the parameters after them."""
    jax_agent, params = replay_pair
    rb = padded_bundle()
    p = jax.tree.map(jnp.asarray, params)
    p_ref, _, losses_ref = jax_make_replay_block(jax_agent, 3)(
        p, jax_agent.tx.init(p), {k: jnp.asarray(v) for k, v in rb.items()}, jax.random.key(5))
    ours = make_replay_agent(REPLAY_CFG, REPLAY_CFG.batch_size, device="cpu")
    load_flax_params(ours.model, params)
    losses = make_replay_block(ours, 3)(rb)
    assert losses.shape == (3,) and ours.train_state.step == 3 and not ours.model.training
    np.testing.assert_allclose(losses.numpy(), np.asarray(losses_ref), rtol=1e-5)
    assert len(set(losses.tolist())) == 3  # the parameters moved between updates
    ref = flax_to_state_dict(jax.tree.map(np.asarray, p_ref))
    for name, q in ours.model.named_parameters():
        tol = SHIFT_ATOL if name in FT_SHIFT_INVARIANT else P_ATOL
        np.testing.assert_allclose(q.detach().numpy(), ref[name].numpy(), atol=tol, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("device,gloo,want", [("cpu", False, False), ("cuda", False, True),
                                              ("cuda", True, False)])
def test_capturable_reads_the_device_and_the_groups_backend(tmp_path, device, gloo, want):
    """A step is graphed only on a CUDA device, and not under a gloo group,
    whose collectives a CUDA graph cannot capture; the predicate reads the
    device's type and the group's backend, so it needs no card."""
    if gloo:
        distributed.initialize("cpu", backend="gloo", rank=0, world_size=1,
                               init_method="file://" + str(tmp_path / "store"))
    try:
        assert distributed.active() == gloo
        assert graphs.capturable(torch.device(device)) == want
    finally:
        distributed.shutdown()
