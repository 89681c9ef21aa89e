"""The port's Habitat sensor stack (``ce/habitat_binding.py`` with the CLIP
and DDPPO towers, ``cli/ce_train.py --habitat_config``) against the JAX
package's, on the CPU, over ``chip_smoke.py``'s stand-in ``habitat`` module
(seeded, pose-dependent frames; round obstacles; euclidean geodesics).

Small towers: CLIP hidden 64, 2 layers, 1 head, 64x64 frames (a 4x4 grid of
16x16 patches); DDPPO baseplanes 8, one block per stage, 128x128 depth, a
(32, 2, 2) map. Tolerances, float32:

- the depth-feature repair: JAX's binding has no ``depth_feat_shape``, so
  JAX's CE agent cannot be built over it; the port's binding hands the
  waypoint predictor JAX's unpooled DDPPO map transposed to NCHW (rtol
  1e-4, atol 1e-5), not the NHWC flatten that also has the right size;
- the bindings with towers: reset, observation assembly (view features and
  grids at rtol 1e-4, atol 1e-5 of JAX's towers; pooled depth grids equal),
  the ring render's pose restore, control with a collision, teleport, the
  oracle and episode metrics equal;
- the slice: a small SS-BEV rollout over each package's binding, JAX's
  instance given ``depth_feat_shape`` and a depth callable that returns the
  unpooled map (the test patches the instance, never the JAX source):
  argmax eval with control, equal trajectories, heatmaps at atol 1e-4 (the
  x100-sharpened head over depth maps that agree to ~1e-6; the NMS peaks
  stand more than 1e-3 apart) and fused logits at 1e-4; a teacher training rollout's replay bundle, its
  loss at rtol 1e-5 and gradients at ``test_torch_ce.py``'s tolerances;
- the CLI: ``--clip_ckpt``/``--ddppo_ckpt`` without ``--habitat_config``
  and ``--habitat_config`` with ``--num_env_workers`` refused with the JAX
  CLI's messages; without ``habitat`` the binding raises ``ImportError``.
"""

import math
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import vln_bevbert_tpu.configs as jax_configs
from test_torch_ce import MODEL, SHAPES, WP_SHARPEN, _capture_bundle, nms_margin, recording
from test_torch_finetune import FT_SHIFT_INVARIANT, perturbed
from vln_bevbert_tpu.ce import habitat_binding as jax_hb
from vln_bevbert_tpu.ce.agent import CEAgent as JaxCEAgent
from vln_bevbert_tpu.cli import ce_train as jax_cli
from vln_bevbert_tpu.models import clip as jax_clip
from vln_bevbert_tpu.models import depth_encoder as jax_de
from vln_bevbert_tpu.precompute.pipeline import JaxClipEncoder
from vln_bevbert_tpu_torch import configs
from vln_bevbert_tpu_torch.ce import habitat_binding as hb
from vln_bevbert_tpu_torch.ce.agent import CEAgent
from vln_bevbert_tpu_torch.ce.frozen import DeviceDepthEncoder
from vln_bevbert_tpu_torch.cli import ce_train as cli
from vln_bevbert_tpu_torch.convert import flax_to_state_dict, load_flax_params
from vln_bevbert_tpu_torch.nav.agent import IGNORE_ID
from vln_bevbert_tpu_torch.precompute.pipeline import DeviceClipEncoder

CLIP = dict(hidden_size=64, intermediate_size=128, num_layers=2, num_heads=1, patch_size=16)
DDPPO = dict(baseplanes=8, layers=(1, 1, 1, 1), after_compression_flat_size=128)
RGB_HW, DEPTH_HW, GRID_HW = 64, 128, 4
RTOL, ATOL = 1e-4, 1e-5
# the waypoint head, sharpened x100, takes depth maps that agree to ~1e-6
HEAT_ATOL = 1e-4


@pytest.fixture(scope="module")
def towers():
    """(JAX CLIP encoder, JAX unpooled depth callable, port CLIP encoder,
    port depth encoder) with the same perturbed parameters."""
    tower = jax_clip.ClipVisionTower(**CLIP)
    ctree = perturbed(jax.tree.map(np.asarray, jax.jit(tower.init)(
        jax.random.PRNGKey(0), np.zeros((1, RGB_HW, RGB_HW, 3), np.float32))["params"]))
    enc = jax_de.DdppoDepthEncoder(**DDPPO)
    dtree = perturbed(jax.tree.map(np.asarray, jax.jit(enc.init)(
        jax.random.PRNGKey(1), np.zeros((1, DEPTH_HW, DEPTH_HW, 1), np.float32))["params"]))
    apply = jax.jit(enc.apply)

    def jax_spatial(depth):  # (V, H, W) raw frames -> (V, C, h, w)
        out = apply({"params": dtree}, np.asarray(depth, np.float32)[..., None])
        return np.asarray(out).transpose(0, 3, 1, 2)

    jax_clip_enc = JaxClipEncoder(ctree, grid_hw=GRID_HW, **CLIP)
    return SimpleNamespace(
        jax_clip=jax_clip_enc, jax_spatial=jax_spatial,
        clip=DeviceClipEncoder(flax_to_state_dict(ctree), grid_hw=GRID_HW, device="cpu"),
        depth=DeviceDepthEncoder(flax_to_state_dict(dtree), input_size=DEPTH_HW, device="cpu"))


@pytest.fixture()
def habitat_config(tmp_path, monkeypatch):
    """A stand-in habitat config; the stand-in module in ``sys.modules``."""
    monkeypatch.setitem(sys.modules, "habitat", chip_smoke.habitat_stand_in())
    return chip_smoke.write_habitat_config(str(tmp_path / "stand_in.yaml"), rgb_hw=RGB_HW,
                                           depth_hw=DEPTH_HW, episodes=4)


def bindings(config, towers, batch_size=2):
    """(JAX binding, port binding) over the same stand-in episodes; the JAX
    instance given the depth contract its agent reads (not its source)."""
    jenv = jax_hb.make_habitat_env(config, batch_size, clip_encoder=towers.jax_clip,
                                   depth_encoder=towers.jax_spatial, grid_hw=GRID_HW)
    jenv.depth_feat_shape = towers.depth.feat_shape
    ours = hb.make_habitat_env(config, batch_size, clip_encoder=towers.clip,
                               depth_encoder=towers.depth, grid_hw=GRID_HW)
    return jenv, ours


def test_jax_binding_lacks_the_depth_contract(habitat_config, towers):
    jenv = jax_hb.make_habitat_env(habitat_config, 2, clip_encoder=towers.jax_clip,
                                   grid_hw=GRID_HW)
    assert not hasattr(jenv, "depth_feat_shape")
    with pytest.raises(AttributeError, match="depth_feat_shape"):
        JaxCEAgent(ce_config(jax_configs), jenv).init_params()

    ours = hb.make_habitat_env(habitat_config, 2, clip_encoder=towers.clip,
                               depth_encoder=towers.depth, grid_hw=GRID_HW)
    assert ours.depth_feat_shape == (32, 2, 2) and ours.view_feat_size == 64
    obs = ours.reset()
    for ob, env in zip(obs, ours.envs):
        feats = ob["depth_features"]
        assert feats.shape == (12, 32, 2, 2)
        # the JAX tower's own unpooled output over the same ring
        state = env.sim.get_agent_state()
        frames = np.stack([ours._render_at(env.sim, state.position, ours._heading(state)
                                           + k * 2 * math.pi / 12)["depth"] for k in range(12)])
        env.sim.set_agent_state(state.position, state.rotation)
        nhwc = towers.jax_spatial(frames).transpose(0, 2, 3, 1)
        np.testing.assert_allclose(feats, nhwc.transpose(0, 3, 1, 2), rtol=RTOL, atol=ATOL)
        # an NHWC flatten has the waypoint predictor's 128 inputs too, in
        # another order
        assert not np.allclose(feats.reshape(12, -1), nhwc.reshape(12, -1), rtol=0.1)


def test_bindings_with_towers_match_jax(habitat_config, towers):
    jenv, ours = bindings(habitat_config, towers)
    for ref, got in zip(jenv.reset(), ours.reset()):
        assert ref.keys() == got.keys()
        for key in ("view_fts", "rgb"):
            np.testing.assert_allclose(got[key], ref[key], rtol=RTOL, atol=ATOL, err_msg=key)
        np.testing.assert_allclose(got["depth_features"], ref["depth_features"], rtol=RTOL,
                                   atol=ATOL)
        for key in ("position", "orientation", "heading", "depth", "gt_path", "goal",
                    "instr_encoding", "episode_id", "instr_id"):
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert got["view_fts"].shape == (12, 64) and got["rgb"].shape == (12, 16, 64)
    assert got["depth"].shape == (12, GRID_HW, GRID_HW)
    # the ring render puts the pose back
    np.testing.assert_array_equal(ours.positions, jenv.positions)
    np.testing.assert_array_equal(ours.headings, jenv.headings)

    for env in (jenv, ours):
        env.rotate(0, env.turn_unit)
        env.forward_step(0)
        env.teleport(1, [0.5, 0.0, -0.5], heading=math.radians(90))
        env.forward_step(1)
        # into an obstacle: the step is filtered out, a collision
        ob = env.envs[0].sim.obstacles[0]
        env.teleport(0, [ob[0], 0.0, ob[1] + ob[2] + 0.1], heading=0.0)
    for env in (jenv, ours):
        assert env.forward_step(0) and env.previous_step_collided(0)
    np.testing.assert_array_equal(ours.positions, jenv.positions)
    np.testing.assert_array_equal(ours.headings, jenv.headings)
    assert ours.dist_to_goal(1) == jenv.dist_to_goal(1)
    queries = [[1.0, 0.0, 2.0], [-3.0, 0.0, 0.5]]
    np.testing.assert_array_equal(ours.dists_to_goal(0, queries), jenv.dists_to_goal(0, queries))
    walked = np.asarray(ours.batch[1].reference_path)
    assert ours.eval_episode(1, walked) == jenv.eval_episode(1, walked)


def ce_config(pkg_configs):
    """``test_torch_ce.py``'s SS-BEV configuration with the grid features
    of the small CLIP tower."""
    return pkg_configs.FinetuneConfig(
        model=pkg_configs.ModelConfig(**dict(MODEL, bev_grid_feat_size=CLIP["hidden_size"],
                                             use_bev=True)),
        shapes=pkg_configs.ShapeConfig(**SHAPES), batch_size=2, max_action_len=4,
        learning_rate=1e-3, fusion="avg")


def test_habitat_rollout_and_replay_match_jax(habitat_config, towers):
    jenv, env = bindings(habitat_config, towers)
    jax_agent = JaxCEAgent(ce_config(jax_configs), jenv)
    jax_agent.init_params()
    params = perturbed(jax_agent.params)
    jax_agent.params = jax.tree.map(jax.numpy.asarray, params)
    jax_agent.opt_state = jax_agent.tx.init(jax_agent.params)
    wp_tree = perturbed(jax_agent.wp_params)
    wp_tree["cls_fc2"]["kernel"] *= WP_SHARPEN
    jax_agent.wp_params = jax.tree.map(jax.numpy.asarray, wp_tree)
    ours = CEAgent(ce_config(configs), env, device="cpu")
    ours.init_params(wp_params=flax_to_state_dict(wp_tree))
    load_flax_params(ours.model, params)
    for a in (jax_agent, ours):
        a.np_rng = np.random.default_rng(11)
    jax_agent.cfg.ce_back_algo = ours.cfg.ce_back_algo = "control"

    rec, restore = recording(jax_agent, ours)
    try:
        ref, _ = jax_agent.rollout(feedback="argmax", train=False)
        got, loss = ours.rollout(feedback="argmax", train=False)
    finally:
        restore()
    assert loss is None
    for a, b in zip(ref, got):
        assert a["instr_id"] == b["instr_id"]
        np.testing.assert_array_equal(np.stack(b["positions"]), np.stack(a["positions"]))
        assert b["headings"] == a["headings"]
    assert max(len(t["positions"]) for t in got) > 2  # the controller walked
    assert len(rec["our_heat"]) == len(rec["jax_heat"]) > 1
    for mine, theirs in zip(rec["our_heat"], rec["jax_heat"]):
        np.testing.assert_allclose(mine, theirs, atol=HEAT_ATOL, rtol=0)
        assert nms_margin(theirs) > 10 * HEAT_ATOL  # the NMS cannot flip within it
    assert len(rec["our_logits"]) == len(rec["jax_logits"]) > 1
    for mine, theirs in zip(rec["our_logits"], rec["jax_logits"]):
        np.testing.assert_allclose(mine, theirs, atol=1e-4, rtol=1e-4)

    # a teacher training rollout: its replay bundle, loss and gradients
    bundles = {"jax": _capture_bundle(jax_agent), "ours": _capture_bundle(ours)}
    try:
        jax_agent.rollout(feedback="teacher", train=True)
        ours.rollout(feedback="teacher", train=True)
    finally:
        del jax_agent.learn_from_bundle, ours.learn_from_bundle
    rb_ref, rb = bundles["jax"]["rb"], bundles["ours"]["rb"]
    assert sorted(rb) == sorted(rb_ref) and "bev_fts" in rb
    for key, val in rb_ref.items():
        mine = rb[key].numpy() if isinstance(rb[key], torch.Tensor) else np.asarray(rb[key])
        val = np.asarray(val)
        assert mine.shape == val.shape and mine.dtype == val.dtype, key
        if key == "bev_fts":
            # cell means of the CLIP grid as the point-cloud store holds it,
            # in bfloat16: grids that agree to ~1e-6 can round a point one
            # bfloat16 ulp apart
            np.testing.assert_allclose(mine, val, atol=ATOL, rtol=2 ** -7, err_msg=key)
        elif key == "view_fts":
            np.testing.assert_allclose(mine, val, atol=ATOL, rtol=RTOL, err_msg=key)
        else:
            np.testing.assert_array_equal(mine, val, err_msg=key)
    assert (rb_ref["targets"] != IGNORE_ID).any()
    # the replay on the same inputs: JAX's tower-fed features in ours
    for key in ("bev_fts", "view_fts"):
        rb[key] = (torch.from_numpy(np.asarray(rb_ref[key])) if isinstance(rb[key], torch.Tensor)
                   else np.asarray(rb_ref[key]))
    T = rb_ref["targets"].shape[0]
    keys = jax.random.split(jax.random.key(7), T + 2)
    loss_ref, grads_ref = jax_agent._fn("loss_grad")(
        jax_agent.params, dict(rb_ref, rng=keys[:T], rng_lang=keys[T], rng_pano=keys[T + 1]))
    ours.model.zero_grad(set_to_none=True)
    with ours._training():
        loss = ours._episode_loss(rb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref), rtol=1e-5)
    grads_ref = flax_to_state_dict(jax.tree.map(np.asarray, grads_ref))
    model_scale = max(float(g.abs().max()) for g in grads_ref.values())
    for name, p in ours.model.named_parameters():
        want = grads_ref[name].numpy()
        have = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        atol = 1e-7 * model_scale if name in FT_SHIFT_INVARIANT else 1e-5 * np.abs(want).max()
        np.testing.assert_allclose(have, want, rtol=1e-4, atol=atol, err_msg=name)


def test_cli_refuses_as_jax_does(tmp_path, monkeypatch):
    def message(fn, argv):
        with pytest.raises(SystemExit) as err:
            fn(argv)
        return str(err.value)

    base = ["--allow_random_frozen", "--output_dir", str(tmp_path)]
    for flags in (["--clip_ckpt", "clip.pt"], ["--ddppo_ckpt", "ddppo.pth"]):
        want = message(lambda a: jax_cli.build_frozen(jax_cli.parse_args(a)), base + flags)
        assert "require --habitat_config" in want
        assert message(cli.main, ["--device", "cpu", *base, *flags]) == want
    flags = ["--habitat_config", "h.yaml", "--num_env_workers", "2"]
    want = message(jax_cli.main, base + flags)
    assert "not supported yet" in want
    assert message(cli.main, ["--device", "cpu", *base, *flags]) == want
    # no habitat: the binding raises, as JAX's does
    monkeypatch.setitem(sys.modules, "habitat", None)
    for mod in (jax_hb, hb):
        with pytest.raises(ImportError):
            mod.HabitatContinuousEnv(None, [], batch_size=1)
