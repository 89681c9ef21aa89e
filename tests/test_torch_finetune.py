"""The port's DAgger fine-tuning against the JAX agent, on the CPU.

Every dropout rate is 0 and parameters go JAX -> port through
``convert.load_flax_params``, so both agents compute the same function:

- the replay's episode loss and every gradient on a synthetic bundle whose
  last steps are padding (loss rtol 1e-5; gradients rtol 1e-4 plus 1e-5 of
  the tensor's largest entry; the gradients of rounding noise behind a
  softmax's shift invariance within 1e-7 of the model's largest gradient);
- three ``learn_from_bundle`` updates (parameters, bf16 first and f32 second
  moments within ``test_torch_train_step._compare_state``'s bounds for three
  full steps, the shift-invariant biases within 6 lr of JAX's); the
  test's learning rate and weight decay make both the second moment's b2 and
  the decay of LayerNorms and biases visible at those bounds;
- the agent's checkpoint, restored with and without its optimizer state;
- the bundle a teacher-forced training rollout replays (equal key by key,
  BEV features within 1e-5), and the trajectories of ``sample`` and
  ``expl_sample`` rollouts from the same ``np_rng`` seed;
- the pretrained -> navigation transfer, and the CLI's config.
"""

import dataclasses
import types

import jax
import numpy as np
import optax
import pytest
import torch

from test_torch_nav import CFG, make_env
from test_torch_pretrain import TINY as PRE_TINY
from test_torch_pretrain import make_batch, tiny_cfg
from test_torch_train_step import SHIFT_INVARIANT, _compare_state
from vln_bevbert_tpu.cli import finetune as jax_cli
from vln_bevbert_tpu.configs import FinetuneConfig, ShapeConfig
from vln_bevbert_tpu.data.synthetic import synthetic_replay_bundle
from vln_bevbert_tpu.models.surgery import count_transferred as jax_count
from vln_bevbert_tpu.models.surgery import transfer_pretrained as jax_transfer
from vln_bevbert_tpu.nav.agent import GMapNavAgent as JaxAgent
from vln_bevbert_tpu.nav.agent import make_replay_agent as jax_replay_agent
from vln_bevbert_tpu.parallel.train_step import init_pretrain_state as jax_init_pretrain
from vln_bevbert_tpu_torch.cli import finetune as cli
from vln_bevbert_tpu_torch.convert import flax_to_state_dict, load_flax_params
from vln_bevbert_tpu_torch.models.glocal import GlocalTextPathCMTPreTraining
from vln_bevbert_tpu_torch.models.surgery import count_transferred, transfer_pretrained
from vln_bevbert_tpu_torch.nav.agent import IGNORE_ID, GMapNavAgent, make_replay_agent

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, feat_dropout=0.0)
REPLAY_CFG = FinetuneConfig(
    model=dataclasses.replace(CFG.model, **NO_DROPOUT),
    shapes=ShapeConfig(max_txt_len=16, max_steps=5, max_pano_len=6, max_gmap_len=8,
                       max_local_len=4, max_objects=0, num_views=2, grid_hw=4,
                       max_pc_steps=2),
    batch_size=2, max_action_len=5, learning_rate=5e-5, weight_decay=0.1,
)
PADDED = 2  # trailing steps of the bundle that are all padding
# biases whose gradient is rounding noise (measured <= 2e-8 of the model's
# largest gradient): a softmax ignores a shift shared by its inputs, and the
# fused logits take the local head's logits through ``fuse_map``
FT_SHIFT_INVARIANT = SHIFT_INVARIANT + ("local_sap_head.fc2.bias", "local_sap_head.ln.bias")


def padded_bundle(cfg=REPLAY_CFG, seed=11):
    """A synthetic replay bundle whose last ``PADDED`` steps are zeros with
    IGNORE_ID targets, as ``_learn`` pads an episode shorter than T."""
    rb = synthetic_replay_bundle(np.random.default_rng(seed), cfg, cfg.batch_size)
    for key, val in rb.items():
        if key not in ("txt_ids", "txt_masks", "step_idx"):
            val[-PADDED:] = IGNORE_ID if key == "targets" else 0
    assert (rb["targets"][:-PADDED] != IGNORE_ID).any()
    return rb


def perturbed(params, seed=1):
    """JAX's initial parameters plus N(0, 0.02): no all-zero biases (see
    test_torch_train_step.py)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.02, a.shape)).astype(np.float32), params)


@pytest.fixture(scope="module")
def replay_pair():
    """(JAX replay agent, port replay agent, perturbed numpy params)."""
    jax_agent = jax_replay_agent(REPLAY_CFG, batch_size=REPLAY_CFG.batch_size)
    params = perturbed(jax_agent.params)
    ours = make_replay_agent(REPLAY_CFG, REPLAY_CFG.batch_size, device="cpu")
    load_flax_params(ours.model, params)
    return jax_agent, ours, params


def test_episode_loss_and_gradients_match_jax(replay_pair):
    jax_agent, ours, params = replay_pair
    rb = padded_bundle()
    T = rb["targets"].shape[0]
    keys = jax.random.split(jax.random.key(7), T + 2)
    loss_ref, grads_ref = jax_agent._fn("loss_grad")(
        jax.tree.map(jax.numpy.asarray, params),
        dict(rb, rng=keys[:T], rng_lang=keys[T], rng_pano=keys[T + 1]))

    ours.model.zero_grad(set_to_none=True)
    ours.model.train()
    try:
        loss = ours._episode_loss(rb)
    finally:
        ours.model.eval()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref), rtol=1e-5)
    grads_ref = flax_to_state_dict(jax.tree.map(np.asarray, grads_ref))
    model_scale = max(float(g.abs().max()) for g in grads_ref.values())
    reached = 0
    for name, p in ours.model.named_parameters():
        ref = grads_ref[name].numpy()
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        atol = 1e-5 * float(np.abs(ref).max())
        if name in FT_SHIFT_INVARIANT:  # rounding noise: within 1e-7 of the model's scale
            atol = 1e-7 * model_scale
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=atol, err_msg=name)
        reached += bool(np.abs(ref).max() > 0)
    assert reached > len(grads_ref) // 2


def _adam_only(opt_state):
    """The ScaleByAdamState inside an optax chain, as ``_compare_state`` wants it."""
    leaves = jax.tree.leaves(opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
    return [next(s for s in leaves if isinstance(s, optax.ScaleByAdamState))]


def test_three_replay_updates_match_jax(replay_pair):
    jax_agent, _, params = replay_pair
    jax_agent.params = jax.tree.map(jax.numpy.asarray, params)
    jax_agent.opt_state = jax_agent.tx.init(jax_agent.params)
    ours = make_replay_agent(REPLAY_CFG, REPLAY_CFG.batch_size, device="cpu")
    load_flax_params(ours.model, params)
    start = {n: p.detach().clone() for n, p in ours.model.named_parameters()}
    for seed in (11, 12, 13):
        rb = padded_bundle(seed=seed)
        ref = jax_agent.learn_from_bundle(rb)
        got = ours.learn_from_bundle(rb)
        np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert ours.train_state.step == 3 and ours.logs["IL_loss"] == pytest.approx(
        jax_agent.logs["IL_loss"], rel=1e-5)
    assert all(np.isfinite(g) and g > 0 for g in ours.logs["grad_norm"])
    assert not ours.model.training
    jax_state = types.SimpleNamespace(params=jax_agent.params,
                                      opt_state=_adam_only(jax_agent.opt_state))
    _compare_state(ours.model, ours.train_state, jax_state, p_atol=4e-6, mu_rtol=2 ** -6,
                   nu_rtol=1e-4, floor=(2 ** -7, 1e-5), skip=FT_SHIFT_INVARIANT)
    # Adam normalises their noise to steps of ~lr either way, as in
    # test_torch_train_step.py; weight decay moves them alike on both sides
    params_ref = flax_to_state_dict(jax.tree.map(np.asarray, jax_agent.params))
    for name in FT_SHIFT_INVARIANT:
        p = dict(ours.model.named_parameters())[name].detach()
        assert float((p - params_ref[name]).abs().max()) <= 6 * 3 * REPLAY_CFG.learning_rate
    moved = sum(not torch.equal(p.detach(), start[n]) for n, p in ours.model.named_parameters())
    assert moved == len(start)  # weight decay reaches every parameter


def test_agent_checkpoint_restores_parameters_and_optimizer(tmp_path):
    """``save_ckpt`` after an update; ``restore_ckpt`` reloads parameters and
    the AdamW state bit for bit, or with ``with_opt=False`` parameters only."""
    trained = make_replay_agent(REPLAY_CFG, REPLAY_CFG.batch_size, device="cpu")
    trained.learn_from_bundle(padded_bundle())
    path = trained.save_ckpt(str(tmp_path / "ckpt_latest"))
    want = trained.train_state.state_dict()
    for with_opt in (True, False):
        agent = make_replay_agent(REPLAY_CFG, REPLAY_CFG.batch_size, seed=5, device="cpu")
        agent.restore_ckpt(path, with_opt=with_opt)
        for a, b in zip(agent.model.parameters(), trained.model.parameters()):
            assert torch.equal(a, b)
        got = agent.train_state.state_dict()
        assert got["count"] == (1 if with_opt else 0)
        for moment in ("mu", "nu"):
            for name, ref in want[moment].items():
                assert got[moment][name].dtype == ref.dtype, name
                expect = ref if with_opt else torch.zeros_like(ref)
                assert torch.equal(got[moment][name], expect), (moment, name)
    assert any(bool(m.any()) for m in want["mu"].values())


@pytest.fixture()
def env_pair(tmp_path):
    """(JAX agent, port agent) on the same tiny world, same parameters."""
    jax_agent = JaxAgent(CFG, make_env(tmp_path))
    jax_agent.init_params()
    agent = GMapNavAgent(CFG, make_env(tmp_path), device="cpu")
    load_flax_params(agent.model, jax.tree.map(np.asarray, jax_agent.params))
    return jax_agent, agent


def test_teacher_training_rollout_replays_the_jax_bundle(env_pair):
    jax_agent, agent = env_pair
    bundles = {}
    for name, a in (("jax", jax_agent), ("ours", agent)):
        def record(rb, name=name):
            bundles[name] = rb
            return 0.0

        a.learn_from_bundle = record
        trajs, loss = a.rollout(feedback="teacher", train=True)
        assert loss == 0.0
        bundles[name + "_trajs"] = [t["path"] for t in trajs]
    ref, got = bundles["jax"], bundles["ours"]
    assert bundles["ours_trajs"] == bundles["jax_trajs"]
    assert sorted(got) == sorted(ref)
    assert ref["targets"].shape[0] == CFG.max_action_len
    for key, val in ref.items():
        mine = got[key]
        mine = mine.numpy() if isinstance(mine, torch.Tensor) else np.asarray(mine)
        val = np.asarray(val)
        assert mine.shape == val.shape and mine.dtype == val.dtype, key
        if key == "bev_fts":
            np.testing.assert_allclose(mine, val, atol=1e-5, rtol=0)
        else:
            np.testing.assert_array_equal(mine, val, err_msg=key)
    assert (ref["targets"] == IGNORE_ID).all(axis=1).any()  # the episode has padded steps


@pytest.mark.parametrize("feedback", ["sample", "expl_sample"])
def test_sampled_trajectories_match_jax(env_pair, feedback):
    jax_agent, agent = env_pair
    for _ in range(2):
        ref, _ = jax_agent.rollout(feedback=feedback, train=False)
        got, _ = agent.rollout(feedback=feedback, train=False)
        assert [t["path"] for t in got] == [t["path"] for t in ref]
    np.testing.assert_allclose(agent.logs["entropy"], jax_agent.logs["entropy"], rtol=1e-4)
    assert (feedback == "sample") == bool(agent.logs["entropy"])
    # the two np_rng streams were consumed alike
    assert agent.np_rng.random() == jax_agent.np_rng.random()


def test_dagger_iteration_trains_with_dropout(tmp_path):
    """One DAgger iteration with every dropout on (the plain dropout on the
    CPU): a teacher-forced and a sampled rollout, each with its update."""
    agent = GMapNavAgent(CFG, make_env(tmp_path), device="cpu")
    agent.init_params()
    assert CFG.model.hidden_dropout_prob > 0
    start = [p.detach().clone() for p in agent.model.parameters()]
    losses = agent.train_iters(1, feedback="dagger")
    assert len(losses) == 2 and all(np.isfinite(losses)) and min(losses) > 0
    assert agent.logs["IL_loss"] == losses and len(agent.logs["entropy"]) >= 1
    assert agent.train_state.step == 2 and not agent.model.training
    assert all(not torch.equal(a, p.detach()) for a, p in zip(start, agent.model.parameters()))


def test_transfer_pretrained_matches_jax():
    """A pretraining model's parameters into a navigation model whose word
    embeddings differ in size: every other shared name is copied."""
    pre_cfg = tiny_cfg()
    _, _, pre_state = jax_init_pretrain(pre_cfg, make_batch())
    pre_params = jax.tree.map(np.asarray, pre_state.params)
    nav_cfg = FinetuneConfig(model=dataclasses.replace(PRE_TINY, vocab_size=500),
                             shapes=REPLAY_CFG.shapes, batch_size=2, max_action_len=5)
    nav_params = jax.tree.map(np.asarray, jax_replay_agent(nav_cfg, batch_size=2).params)
    ref = flax_to_state_dict(jax_transfer(pre_params, nav_params))

    pre = GlocalTextPathCMTPreTraining(PRE_TINY, pre_cfg.tasks)
    load_flax_params(pre, pre_params)
    agent = GMapNavAgent(nav_cfg, None, device="cpu")
    load_flax_params(agent.model, nav_params)
    fresh = agent.model.state_dict()
    got = transfer_pretrained(pre.state_dict(), fresh)
    assert sorted(got) == sorted(ref)
    for name, val in ref.items():
        assert torch.equal(got[name], val), name
    n = count_transferred(pre.state_dict(), fresh)
    assert n == jax_count(pre_params, nav_params) == len(fresh) - 1  # all but the embeddings
    assert torch.equal(got["bert.embeddings.word_embeddings.weight"],
                       fresh["bert.embeddings.word_embeddings.weight"])
    assert agent.init_params(pretrained=pre.state_dict()) == n == agent.transferred
    assert torch.equal(agent.model.state_dict()["global_sap_head.fc1.weight"],
                       pre.state_dict()["global_sap_head.fc1.weight"])


def test_build_sets_the_jax_clis_config_for_rxr(tmp_path, monkeypatch):
    """``--dataset rxr --iters 7 --log_every 3``: the port's config equals the
    one the JAX CLI builds before its envs (its batch is per chip there)."""
    from test_torch_nav import _tiny_config

    argv = ["--synthetic", "--dataset", "rxr", "--iters", "7", "--log_every", "3",
            "--config", _tiny_config(tmp_path), "--output_dir", str(tmp_path)]
    seen = {}

    def stop(cfg, args):
        seen["cfg"] = cfg
        raise RuntimeError("config built")

    monkeypatch.setattr(jax_cli, "build_envs", stop)
    with pytest.raises(RuntimeError, match="config built"):
        jax_cli.main(argv + ["--test"])
    ref = seen["cfg"]
    ref.batch_size //= jax.device_count()
    cfg = cli.build(cli.parse_args(argv + ["--test", "--device", "cpu"]))[0]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert (cfg.ml_weight, cfg.iters, cfg.log_every) == (0.8, 7, 3)
