"""Data-parallel continuous-environment training of the port (``ce/agent.py``,
``ce/inference.py``, ``ce/dagger.py`` and ``cli/ce_train.py`` in a process
group): two gloo ranks of 2 rows on the CPU (``dp_ranks.py``, spawned once
for the module) against the port's one process at the global batch of 4,
and one teacher replay against the JAX package's ``CEAgent`` over a
2-device mesh. The configuration is tiny: hidden 32, two layers per stack,
12 views, an 11x11 BEV at 1 m.

- SS-BEV and SS-ETP sampled training rollouts with waypoint sampling and
  ghost noise: the ranks' trajectories, concatenated, equal the one
  process's, and every rank's ``np_rng`` ends in its state.
- The SS-BEV replay of that rollout (dropout on: the ranks draw the global
  rows' seeds) at ``test_torch_dp_finetune``'s tolerances: loss rtol 1e-5,
  gradients rtol 1e-4 atol 1e-6, parameters after AdamW atol 1e-5, or
  3 lr for the softmax's shift-invariant biases.
- A teacher replay's loss (rtol 1e-5) and gradients (rtol 1e-4, atol 1e-6,
  rounding noise behind the shift invariance within 1e-7 of the largest
  gradient) against JAX's mesh at 4 rows, every dropout rate 0.
- Greedy eval with low-level control (tryout coins drawn: the one process's
  ``np_rng`` moves): merged metrics at rtol 1e-12, the same ``np_rng``
  state; ``collect_predictions`` merges to the same ``path_eps``.
- CE DAgger with the BEV policy, one iteration: equal history (losses at
  rtol 1e-5), one spill directory per rank.
- ``cli.ce_train`` (1 iteration, its evaluation, ``ckpt_1``) over two ranks
  equals one process at the global batch; rank 1 writes nothing.
- PREVALENT DAgger refuses a group of two and names the world-1 run.
- Each env holds its rank's rows of the global batch, through the batch's
  wrap: the synthetic env, the subprocess pool (the rank's workers of the
  global pool) and the habitat binding over ``chip_smoke``'s stand-in
  simulator give, rank by rank, the one env's observations.
"""

import concurrent.futures
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import dp_ranks
from test_torch_ce import DEPTH_SHAPE, SHAPES, WP_SHARPEN
from test_torch_ce import MODEL as CE_MODEL
from test_torch_finetune import FT_SHIFT_INVARIANT
import vln_bevbert_tpu.configs as jax_configs
from vln_bevbert_tpu.ce.agent import CEAgent as JaxCEAgent
from vln_bevbert_tpu.ce.env import SyntheticContinuousEnv as JaxEnv
from vln_bevbert_tpu.ce.env import make_synthetic_ce_episodes as jax_episodes
from vln_bevbert_tpu.parallel import make_mesh
from vln_bevbert_tpu.parallel.mesh import replicate_tree
from vln_bevbert_tpu.parallel.mesh import shard_replay_bundle as jax_shard_bundle
from vln_bevbert_tpu_torch import configs
from vln_bevbert_tpu_torch.ce import habitat_binding
from vln_bevbert_tpu_torch.ce.agent import CEAgent
from vln_bevbert_tpu_torch.ce.env import SyntheticContinuousEnv, make_synthetic_ce_episodes
from vln_bevbert_tpu_torch.ce.env_pool import make_synthetic_pool
from vln_bevbert_tpu_torch.convert import flax_to_state_dict, module_to_flax
from vln_bevbert_tpu_torch.parallel.train_step import load_checkpoint

WORLD, GLOBAL_B = 2, 4
MODEL = dict(CE_MODEL, num_l_layers=2, num_pano_layers=2, num_x_layers=2, bev_dim=11,
             bev_res=1.0)
DROPOUT = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1, feat_dropout=0.4)
# round obstacles across the synthetic episodes' 10 m square: low-level
# control collides and draws tryout coins
OBSTACLES = [(x, z, 0.6) for x in (2.0, 5.0, 8.0) for z in (2.0, 5.0, 8.0)]
ENV = dict(num_views=12, grid_hw=SHAPES["grid_hw"], grid_feat_size=MODEL["bev_grid_feat_size"],
           view_feat_size=MODEL["image_feat_size"], depth_feat_shape=DEPTH_SHAPE)
N_EPISODES = 6
LR = 1e-3


def config(pkg, use_bev=True, dropout=False, **kw):
    """The CE FinetuneConfig of either package at the global batch."""
    model = dict(MODEL, use_bev=use_bev, **(DROPOUT if dropout else {}))
    return pkg.FinetuneConfig(
        model=pkg.ModelConfig(**model), shapes=pkg.ShapeConfig(**SHAPES), batch_size=GLOBAL_B,
        max_action_len=4, learning_rate=LR, fusion="avg" if use_bev else "global", **kw)


def perturbed_params(use_bev):
    """(navigation state dict, waypoint state dict): the port's initial
    parameters plus N(0, 0.02), the waypoint head sharpened (its NMS peaks
    then stand far apart)."""
    env = SyntheticContinuousEnv(make_synthetic_ce_episodes(np.random.default_rng(3), n=2),
                                 batch_size=2, **ENV)
    agent = CEAgent(config(configs, use_bev), env, device="cpu")
    agent.init_params()
    rng = np.random.default_rng(1 + use_bev)

    def perturb(module):
        return {n: p.detach() + torch.from_numpy(rng.normal(0, 0.02, p.shape).astype(np.float32))
                for n, p in module.named_parameters()}

    wp = perturb(agent.wp_model)
    wp["cls_fc2.weight"] = wp["cls_fc2.weight"] * WP_SHARPEN
    return perturb(agent.model), wp


def spec(cfg, params, **kw):
    nav, wp = params
    return {"cfg": cfg, "params": nav, "wp_params": wp, "n_episodes": N_EPISODES, "env": ENV,
            "rng_seed": 11, **kw}


def jax_teacher_loss_grad(params):
    """JAX's teacher rollout at 4 rows, then its replay loss and gradients
    over a 2-device mesh (the bundle sharded, the parameters replicated)."""
    mesh = make_mesh(jax.devices()[:WORLD])
    env = JaxEnv(jax_episodes(np.random.default_rng(3), n=N_EPISODES), batch_size=GLOBAL_B,
                 **ENV)
    agent = JaxCEAgent(config(jax_configs), env, mesh=mesh)
    agent.init_params()
    port = CEAgent(config(configs), SyntheticContinuousEnv([], batch_size=GLOBAL_B, **ENV),
                   device="cpu")
    port.model.load_state_dict(params[0])
    port.wp_model.load_state_dict(params[1])
    agent.params = replicate_tree(mesh, jax.tree.map(jax.numpy.asarray,
                                                     module_to_flax(port.model)))
    agent.wp_params = jax.tree.map(jax.numpy.asarray, module_to_flax(port.wp_model))
    agent.np_rng = np.random.default_rng(11)
    bundles = []
    agent.learn_from_bundle = lambda rb: bundles.append(rb) or 0.0
    trajs, _ = agent.rollout(feedback="teacher", train=True)
    rb = bundles[0]
    T = rb["targets"].shape[0]
    keys = jax.random.split(jax.random.key(7), T + 2)
    rb = dict(rb, rng=keys[:T], rng_lang=keys[T], rng_pano=keys[T + 1])
    loss, grads = agent._fn("loss_grad")(agent.params, jax_shard_bundle(mesh, rb))
    paths = [(tr["instr_id"], np.stack(tr["positions"]), list(tr["headings"])) for tr in trajs]
    return float(loss), flax_to_state_dict(jax.tree.map(np.asarray, grads)), paths


def cli_argv(tmp, batch_size):
    cfg = tmp / "ce_dp.json"
    if not cfg.exists():
        cfg.write_text(json.dumps({"model": MODEL, "shapes": SHAPES, "max_action_len": 4}))
    return ["--device", "cpu", "--config", str(cfg), "--allow_random_frozen", "--iters", "1",
            "--log_every", "1", "--n_episodes", "4", "--ghost_aug", "0.3",
            "--batch_size", str(batch_size)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_ce")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the tiny models gain nothing from more
    try:
        bev, etp = perturbed_params(True), perturbed_params(False)
    finally:
        torch.set_num_threads(threads)
    specs = {
        "bev": (dp_ranks.ce_train, spec(config(configs, dropout=True), bev, ghost_aug=0.3,
                                        sample_ratio=0.5, replay=True)),
        "etp": (dp_ranks.ce_train, spec(config(configs, use_bev=False), etp, ghost_aug=0.3,
                                        sample_ratio=0.0)),
        "teacher": (dp_ranks.ce_teacher, spec(config(configs), bev)),
        "eval": (dp_ranks.ce_eval, spec(config(configs, ce_back_algo="control"), bev,
                                        env=dict(ENV, obstacles=OBSTACLES))),
        "dagger": (dp_ranks.ce_dagger, spec(config(configs, dropout=True), bev,
                                            update_size=GLOBAL_B, store=str(tmp / "store"))),
        "cli": (dp_ranks.cli, {"module": "ce_train", "argv": cli_argv(tmp, GLOBAL_B // WORLD),
                               "out": [str(tmp / "rank0"), str(tmp / "rank1")]}),
        "prevalent": (dp_ranks.refusal, {
            "module": "ce_train", "cfg": config(configs),
            "argv": [*cli_argv(tmp, 2), "--trainer", "dagger", "--policy", "prevalent",
                     "--output_dir", str(tmp / "prevalent")]}),
    }
    ranks = dp_ranks.Ranks(dp_ranks.chain, WORLD, str(tmp / "work"), list(specs.values()))
    # meanwhile: JAX's mesh (its compiles in a thread) and the one process at
    # the global batch, on one thread
    torch.set_num_threads(1)
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            jax_ref = pool.submit(jax_teacher_loss_grad, bev)
            one = {}
            for k, (fn, s) in specs.items():
                if k == "dagger":
                    s = dict(s, store=str(tmp / "store_one"))
                elif k == "cli":
                    s = dict(s, argv=cli_argv(tmp, GLOBAL_B), out=[str(tmp / "one")])
                elif k == "prevalent":
                    continue
                one[k] = fn(0, 1, s)
            jax_ref = jax_ref.result()
    finally:
        torch.set_num_threads(threads)
    ranks = ranks.results()
    return {"tmp": tmp, "ranks": [dict(zip(specs, r["results"])) for r in ranks],
            "loaded": [r["jax_modules"] for r in ranks], "one": one, "jax": jax_ref}


def test_ranks_load_no_jax(runs):
    assert runs["loaded"] == [[], []]


def assert_paths_equal(got, want):
    assert [p[0] for p in got] == [p[0] for p in want]
    for (_, pos, head), (_, pos_w, head_w) in zip(got, want):
        np.testing.assert_array_equal(pos, pos_w)
        assert head == head_w


@pytest.mark.parametrize("case", ["bev", "etp"])
def test_sampled_rollouts_over_two_ranks_equal_one_process(runs, case):
    ranks, one = [r[case] for r in runs["ranks"]], runs["one"][case]
    assert_paths_equal(ranks[0]["paths"] + ranks[1]["paths"], one["paths"])
    assert len(one["paths"]) == GLOBAL_B
    for r in ranks:
        assert r["rng"] == one["rng"]  # every rank drew what the one process drew
        assert r["steps"] == one["steps"]


def test_replay_over_two_ranks_equals_one_process(runs):
    ranks, one = [r["bev"] for r in runs["ranks"]], runs["one"]["bev"]
    np.testing.assert_allclose(ranks[0]["loss"], one["loss"], rtol=1e-5)
    assert ranks[0]["loss"] == ranks[1]["loss"] > 0
    for name, want in one["grads"].items():
        np.testing.assert_allclose(ranks[0]["grads"][name], want, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
        assert torch.equal(ranks[0]["grads"][name], ranks[1]["grads"][name]), name
    np.testing.assert_allclose(ranks[0]["update_loss"], one["update_loss"], rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["grad_norm"], one["grad_norm"], rtol=1e-5)
    for name, want in one["params"].items():
        assert torch.equal(ranks[0]["params"][name], ranks[1]["params"][name]), name
        np.testing.assert_allclose(ranks[0]["params"][name], want, rtol=0,
                                   atol=3 * LR if name in FT_SHIFT_INVARIANT else 1e-5,
                                   err_msg=name)


def test_teacher_replay_over_two_ranks_matches_the_jax_mesh(runs):
    loss, grads, paths = runs["jax"]
    ranks = [r["teacher"] for r in runs["ranks"]]
    assert_paths_equal(ranks[0]["paths"] + ranks[1]["paths"], paths)
    np.testing.assert_allclose(ranks[0]["loss"], loss, rtol=1e-5)
    assert loss > 0
    scale = max(float(g.abs().max()) for g in grads.values())
    for name, want in grads.items():
        atol = 1e-7 * scale if name in FT_SHIFT_INVARIANT else 1e-6
        np.testing.assert_allclose(np.asarray(ranks[0]["grads"][name]), np.asarray(want),
                                   rtol=1e-4, atol=atol, err_msg=name)


def test_eval_and_predictions_over_two_ranks_equal_one_process(runs):
    ranks, one = [r["eval"] for r in runs["ranks"]], runs["one"]["eval"]
    assert one["rng"] != np.random.default_rng(11).bit_generator.state  # coins were drawn
    for r in ranks:
        assert r["metrics"].keys() == one["metrics"].keys()
        for key, want in one["metrics"].items():
            np.testing.assert_allclose(r["metrics"][key], want, rtol=1e-12, err_msg=key)
        assert r["rng"] == one["rng"] and r["rng_after_predictions"] == one[
            "rng_after_predictions"]
        assert r["path_eps"] == one["path_eps"] and len(one["path_eps"]) == N_EPISODES


def test_dagger_over_two_ranks_equals_one_process(runs):
    ranks, one = [r["dagger"] for r in runs["ranks"]], runs["one"]["dagger"]
    want = one["history"]
    assert want["collected"] == [GLOBAL_B] and want["betas"] == [1.0]
    for r in ranks:
        assert r["history"]["collected"] == want["collected"]
        np.testing.assert_allclose(r["history"]["losses"], want["losses"], rtol=1e-5)
        assert r["rng"] == one["rng"] and r["store"] == ["rank0", "rank1"]
    assert want["losses"][0] > 0 and one["store"] != ["rank0", "rank1"]


def test_cli_ce_train_over_two_ranks_equals_one_process(runs):
    tmp = runs["tmp"]
    ranks = [r["cli"]["res"] for r in runs["ranks"]]
    one = runs["one"]["cli"]["res"]
    assert ranks[0] == ranks[1] and ranks[0].keys() == one.keys()
    for key, want in one.items():
        np.testing.assert_allclose(ranks[0][key], want, rtol=1e-12, err_msg=key)
    assert not (tmp / "rank1").exists()  # rank 1 writes nothing
    assert sorted(os.listdir(tmp / "rank0")) == sorted(os.listdir(tmp / "one")) == [
        "ckpt_1", "metrics.jsonl"]
    logged = [json.loads(line) for line in open(tmp / "rank0" / "metrics.jsonl")]
    logged_one = [json.loads(line) for line in open(tmp / "one" / "metrics.jsonl")]
    np.testing.assert_allclose(logged[-1]["train/loss"], logged_one[-1]["train/loss"], rtol=1e-5)
    got = load_checkpoint(str(tmp / "rank0" / "ckpt_1"), "cpu")["params"]
    ref = load_checkpoint(str(tmp / "one" / "ckpt_1"), "cpu")["params"]
    lr = configs.FinetuneConfig().learning_rate
    for name, want in ref.items():
        atol = 3 * lr if name in FT_SHIFT_INVARIANT else 1e-5
        np.testing.assert_allclose(got[name], want, rtol=0, atol=atol, err_msg=name)


def test_prevalent_dagger_refuses_two_ranks(runs):
    for r in runs["ranks"]:
        for where in ("cli", "agent"):
            assert "--batch_size W*b" in r["prevalent"][where], where
    assert not (runs["tmp"] / "prevalent").exists()


def _rows(obs):
    return [(ob["instr_id"], ob["position"], ob["view_fts"], ob["rgb"]) for ob in obs]


def _assert_rows_equal(got, want):
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)


def _shares(make, resets=3):
    """Per reset, the one env's rows and the two ranks' rows; every env
    built by ``make(rank, world)`` is closed after."""
    envs = [make(0, 1), make(0, WORLD), make(1, WORLD)]
    try:
        out = []
        for _ in range(resets):
            one, *ranks = [_rows(env.reset()) for env in envs]
            out.append((one, ranks[0] + ranks[1]))
        return out
    finally:
        for env in envs:
            if hasattr(env, "close"):
                env.close()


@pytest.mark.parametrize("kind", ["synthetic", "pool", "habitat"])
def test_envs_hold_their_rows_of_the_global_batch(kind, tmp_path, monkeypatch):
    episodes = make_synthetic_ce_episodes(np.random.default_rng(3), n=6)
    small = dict(grid_hw=2, grid_feat_size=4, view_feat_size=4, depth_feat_shape=(2, 1, 1))
    if kind == "synthetic":  # 6 episodes, batches of 4: the second wraps
        def make(rank, world):
            return SyntheticContinuousEnv(episodes, batch_size=GLOBAL_B, rank=rank, world=world,
                                          **small)
    elif kind == "pool":  # two workers of 2 slots; a rank hosts one
        def make(rank, world):
            return make_synthetic_pool(episodes, num_workers=2, slots_per_worker=2, seed=5,
                                       rank=rank, world=world, **small)
    else:
        monkeypatch.setitem(sys.modules, "habitat", chip_smoke.habitat_stand_in())
        config = chip_smoke.write_habitat_config(str(tmp_path / "stand_in.yaml"), rgb_hw=32,
                                                 depth_hw=32, episodes=8)

        def make(rank, world):
            return habitat_binding.make_habitat_env(config, GLOBAL_B, grid_hw=2, rank=rank,
                                                    world=world)
    for one, ranks in _shares(make):
        assert len(one) == GLOBAL_B
        _assert_rows_equal(ranks, one)
    if kind == "pool":  # the split's size is the global pool's
        for rank, world in ((0, 1), (1, WORLD)):
            pool = make(rank, world)
            try:
                assert pool.size() == len(episodes) and pool.batch_size == GLOBAL_B
            finally:
                pool.close()
    with pytest.raises(ValueError, match="cannot"):
        make(2, WORLD)
