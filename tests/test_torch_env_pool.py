"""The port's subprocess vector-env pool (``vln_bevbert_tpu_torch/ce/
env_pool.py``, spawned workers over the port's synthetic continuous env):
the cases of the JAX package's ``tests/test_env_pool.py`` on the port's
copy, a CE rollout through a 2-worker pool that equals the in-process one,
and ``cli.ce_train --num_env_workers 2``.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_ce import DEPTH_SHAPE, MODEL, ce_config
from vln_bevbert_tpu_torch import configs
from vln_bevbert_tpu_torch.ce.agent import CEAgent
from vln_bevbert_tpu_torch.ce.env import SyntheticContinuousEnv, make_synthetic_ce_episodes
from vln_bevbert_tpu_torch.ce.env_pool import SubprocVectorEnv, make_synthetic_pool
from vln_bevbert_tpu_torch.cli import ce_train as cli

ENV_KW = dict(num_views=12, grid_hw=4, grid_feat_size=MODEL["bev_grid_feat_size"],
              view_feat_size=MODEL["image_feat_size"], depth_feat_shape=DEPTH_SHAPE)


@pytest.fixture(scope="module")
def pool():
    p = make_synthetic_pool(make_synthetic_ce_episodes(np.random.default_rng(3), n=8),
                            num_workers=2, slots_per_worker=1, **ENV_KW)
    yield p
    p.close()


def test_pool_surface_matches_inprocess(pool):
    assert isinstance(pool, SubprocVectorEnv) and pool.batch_size == 2
    assert pool.num_views == 12 and pool.grid_hw == 4 and pool.depth_feat_shape == DEPTH_SHAPE
    obs = pool.reset()
    assert len(obs) == 2
    for ob in obs:
        assert ob["rgb"].shape == (12, 16, MODEL["bev_grid_feat_size"])
    assert np.isfinite(pool.dist_to_goal(0))
    pool.teleport(1, obs[1]["position"] + [1.0, 0.0, 0.0])
    obs2 = pool.observations()
    assert not np.array_equal(obs[1]["rgb"], obs2[1]["rgb"])
    np.testing.assert_array_equal(obs[0]["rgb"], obs2[0]["rgb"])
    assert pool.headings.shape == (2,) and len(pool.batch) == 2
    h0 = pool.headings[0]
    pool.rotate(0, pool.turn_unit)
    assert pool.headings[0] == pytest.approx((h0 + pool.turn_unit) % (2 * np.pi))
    pool.forward_step(0)
    assert isinstance(pool.previous_step_collided(0), (bool, np.bool_))


def test_pool_async_observations(pool):
    pool.reset()
    pool.begin_observations()
    obs = pool.end_observations()
    assert len(obs) == 2
    # begin is idempotent; a second end without begin re-dispatches
    np.testing.assert_array_equal(obs[0]["rgb"], pool.observations()[0]["rgb"])


def test_pool_inflight_guard_on_gather_paths(pool):
    """Gather-style RPCs fail loudly while observation replies are pending:
    a silent send would pair the pipe messages wrongly."""
    pool.reset()
    pool.begin_observations()
    try:
        with pytest.raises(AssertionError, match="in flight"):
            pool.size()
        with pytest.raises(AssertionError, match="in flight"):
            _ = pool.headings
        with pytest.raises(AssertionError, match="in flight"):
            pool.teleport(0, np.zeros(3))
    finally:
        pool.end_observations()


def test_pool_worker_error_surfaces(pool):
    with pytest.raises(RuntimeError, match="env worker failed"):
        pool.teleport(0, "not-a-position-at-all", heading="nope")


def test_pool_determinism_vs_inprocess():
    """The same episodes split 2x1 through the pool equal in-process envs
    over each worker's share: sensors are functions of the pose."""
    episodes = make_synthetic_ce_episodes(np.random.default_rng(3), n=4)
    p = make_synthetic_pool(episodes, num_workers=2, slots_per_worker=1, **ENV_KW)
    try:
        obs_pool = p.reset()
        e0 = SyntheticContinuousEnv(episodes[0::2], batch_size=1, seed=0, **ENV_KW)
        e1 = SyntheticContinuousEnv(episodes[1::2], batch_size=1, seed=1, **ENV_KW)
        for a, b in zip(obs_pool, e0.reset() + e1.reset()):
            assert a["episode_id"] == b["episode_id"]
            np.testing.assert_array_equal(a["rgb"], b["rgb"])
    finally:
        p.close()


def test_ce_rollout_through_pool_equals_inprocess():
    """A sampled SS-BEV training rollout (its bundle captured, no update)
    and an argmax evaluation with low-level control, through a 2x1 pool and
    in process over the same episodes from one ``np_rng`` seed: equal
    trajectories, bundles and metrics; the rollout dispatches its
    observations through ``begin_observations``."""
    episodes = make_synthetic_ce_episodes(np.random.default_rng(9), n=4)
    pool = make_synthetic_pool(episodes, num_workers=2, slots_per_worker=1, **ENV_KW)
    try:
        agent = CEAgent(ce_config(configs), pool, device="cpu")
        agent.init_params()
        with torch.no_grad():  # a sharp heatmap: its NMS peaks stand apart
            agent.wp_model.cls_fc2.weight.mul_(100.0)
        begun = []
        begin = pool.begin_observations
        pool.begin_observations = lambda: begun.append(1) or begin()
        inproc = SyntheticContinuousEnv(episodes, batch_size=2, **ENV_KW)
        runs = {}
        for name, env in (("pool", pool), ("inproc", inproc)):
            agent.env = env
            env.reset_epoch()
            agent.np_rng = np.random.default_rng(5)
            bundles = []
            agent.learn_from_bundle = lambda rb, out=bundles: out.append(rb) or 0.0
            trajs, _ = agent.rollout(feedback="sample", train=True, sample_ratio=0.5)
            del agent.learn_from_bundle
            runs[name] = (trajs, bundles[0], agent.evaluate(num_batches=1),
                          agent.np_rng.random())
        assert begun
    finally:
        pool.close()
    (t_pool, b_pool, m_pool, r_pool), (t_in, b_in, m_in, r_in) = runs["pool"], runs["inproc"]
    for a, b in zip(t_pool, t_in):
        assert a["instr_id"] == b["instr_id"] and a["headings"] == b["headings"]
        np.testing.assert_array_equal(np.stack(a["positions"]), np.stack(b["positions"]))
    for key, val in b_in.items():
        mine, want = (v.numpy() if isinstance(v, torch.Tensor) else v
                      for v in (b_pool[key], val))
        np.testing.assert_array_equal(mine, want, err_msg=key)
    assert m_pool == m_in and r_pool == r_in


def test_cli_trains_through_a_two_worker_pool(tmp_path):
    cfg = tmp_path / "ce_pool.json"
    cfg.write_text(json.dumps({
        "model": MODEL, "batch_size": 2, "max_action_len": 3,
        "shapes": {"max_txt_len": 32, "max_steps": 4, "max_pano_len": 16, "max_gmap_len": 12,
                   "max_local_len": 8, "max_objects": 0, "num_views": 12, "grid_hw": 4,
                   "max_pc_steps": 3}}))
    base = ["--device", "cpu", "--config", str(cfg), "--allow_random_frozen", "--n_episodes",
            "4", "--output_dir", str(tmp_path / "out")]
    metrics = cli.main(base + ["--num_env_workers", "2", "--iters", "1", "--log_every", "1"])
    assert 0.0 <= metrics["success"] <= 1.0
    assert (tmp_path / "out" / "ckpt_1").exists()
    with pytest.raises(SystemExit, match="must divide the batch"):
        cli.main(base + ["--num_env_workers", "3"])
