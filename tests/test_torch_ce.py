"""The port's continuous-environment path against the JAX package's, on the
CPU at a tiny configuration (hidden 32, one layer each, BEV 5, 12 views,
two episodes a batch).

Both agents run on identically built synthetic worlds with the same
parameters: the JAX agent's, perturbed by N(0, 0.02) so that no LayerNorm
sees an all-zero input, carried over by ``convert.load_flax_params`` (the
navigation model and the frozen waypoint predictor). Every dropout rate is
0, so both replays compute the same function. Tolerances, float32:

- the waypoint heatmap at atol 1e-5; the NMS then takes the same peaks, and
  each fixture's peaks are separated by far more than that (the NMS is an
  argmax over a softmax, so logits within 1e-6 could pick other peaks);
- argmax eval, with ``control`` and with ``teleport``: equal positions,
  headings and metrics, each step's fused logits at atol=rtol=1e-4;
- a teacher training rollout: its replay bundle key by key (BEV features at
  atol 1e-5), the episode loss at rtol 1e-5, every gradient at rtol 1e-4
  plus 1e-5 of the tensor's largest entry (rounding noise behind a
  softmax's shift invariance within 1e-7 of the model's largest gradient);
- sampled training rollouts with ghost noise from one seed: equal
  trajectories and ``np_rng`` streams;
- each of these with the BEV branch (SS-BEV) and without it (SS-ETP);
- CE pretraining at ``configs/ce_pretrain.json``'s flags (the depth
  embedding on, an 11x11 BEV at 1 m): mlm and sap losses at 1e-4.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from test_torch_finetune import FT_SHIFT_INVARIANT, perturbed
import vln_bevbert_tpu.configs as jax_configs
from vln_bevbert_tpu.ce import waypoint_predictor as jax_wp
from vln_bevbert_tpu.ce.agent import CEAgent as JaxCEAgent
from vln_bevbert_tpu.ce.env import SyntheticContinuousEnv as JaxEnv
from vln_bevbert_tpu.ce.env import make_synthetic_ce_episodes as jax_episodes
from vln_bevbert_tpu.configs import ModelConfig as JaxModelConfig
from vln_bevbert_tpu_torch import configs
from vln_bevbert_tpu_torch.ce import frozen
from vln_bevbert_tpu_torch.ce import waypoint_predictor as wp
from vln_bevbert_tpu_torch.ce.agent import CEAgent
from vln_bevbert_tpu_torch.ce.env import SyntheticContinuousEnv, make_synthetic_ce_episodes
from vln_bevbert_tpu_torch.convert import flax_to_state_dict, load_flax_params
from vln_bevbert_tpu_torch.nav.agent import IGNORE_ID

MODEL = dict(vocab_size=30522, hidden_size=32, num_attention_heads=2, intermediate_size=64,
             num_l_layers=1, num_pano_layers=1, num_x_layers=1, image_feat_size=16,
             obj_feat_size=0, bev_grid_feat_size=12, bev_dim=5, bev_res=1.5, dtype="float32",
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, feat_dropout=0.0)
SHAPES = dict(max_txt_len=64, max_steps=5, max_pano_len=20, max_gmap_len=16, max_local_len=8,
              max_objects=0, num_views=12, grid_hw=4, max_pc_steps=3)
DEPTH_SHAPE = (4, 2, 2)
HEAT_ATOL = 1e-5
NMS_MARGIN = 10 * HEAT_ATOL  # logits within HEAT_ATOL cannot reorder such peaks
WP_SHARPEN = 100.0


def ce_config(pkg_configs, use_bev=True):
    """The same FinetuneConfig in either package."""
    model = dict(MODEL, use_bev=use_bev)
    return pkg_configs.FinetuneConfig(
        model=pkg_configs.ModelConfig(**model), shapes=pkg_configs.ShapeConfig(**SHAPES),
        batch_size=2, max_action_len=4, learning_rate=1e-3,
        fusion="avg" if use_bev else "global")


def make_env(env_cls, episodes_fn):
    return env_cls(episodes_fn(np.random.default_rng(3), n=6), batch_size=2, num_views=12,
                   grid_hw=4, grid_feat_size=MODEL["bev_grid_feat_size"],
                   view_feat_size=MODEL["image_feat_size"], depth_feat_shape=DEPTH_SHAPE,
                   obstacles=[(3.0, 3.0, 0.4), (6.0, 5.0, 0.6)])


def make_pair(use_bev: bool):
    """(JAX agent, port agent) with the same perturbed parameters."""
    jax_agent = JaxCEAgent(ce_config(jax_configs, use_bev), make_env(JaxEnv, jax_episodes))
    jax_agent.init_params()
    params = perturbed(jax_agent.params)
    jax_agent.params = jax.tree.map(jax.numpy.asarray, params)
    jax_agent.opt_state = jax_agent.tx.init(jax_agent.params)
    # a sharper heatmap than random init's (logits of std ~0.01): its NMS
    # peaks then stand far apart (``nms_margin``)
    wp_tree = perturbed(jax_agent.wp_params)
    wp_tree["cls_fc2"]["kernel"] *= WP_SHARPEN
    jax_agent.wp_params = jax.tree.map(jax.numpy.asarray, wp_tree)
    ours = CEAgent(ce_config(configs, use_bev),
                   make_env(SyntheticContinuousEnv, make_synthetic_ce_episodes), device="cpu")
    ours.init_params(wp_params=flax_to_state_dict(wp_tree))
    load_flax_params(ours.model, params)
    return jax_agent, ours


@pytest.fixture(scope="module")
def agent_pair():
    """``agent_pair(use_bev)``: the module's (JAX agent, port agent) pair,
    with both agents' ``np_rng`` and env epoch reset for the calling test."""
    pairs = {}

    def get(use_bev: bool):
        if use_bev not in pairs:
            pairs[use_bev] = make_pair(use_bev)
        for a in pairs[use_bev]:
            a.np_rng = np.random.default_rng(11)
            a.env.reset_epoch()
        return pairs[use_bev]

    return get


def recording(jax_agent, ours):
    """Record every step's heatmap and fused logits on both sides."""
    rec = {"jax_heat": [], "our_heat": [], "jax_logits": [], "our_logits": []}
    wp_fn, nav_fn = jax_agent._jitted["waypoint"], jax_agent._fn("navigation")

    def jax_wp_rec(p, d):
        out = wp_fn(p, d)
        rec["jax_heat"].append(np.asarray(out))
        return out

    def jax_nav_rec(p, b):
        out = nav_fn(p, b)
        rec["jax_logits"].append(np.asarray(out["fused_logits"]))
        return out

    jax_agent._jitted["waypoint"], jax_agent._jitted["navigation"] = jax_wp_rec, jax_nav_rec
    waypoints, forward = ours._waypoints, ours._forward

    def our_wp_rec(obs, train):
        out = waypoints(obs, train)
        rec["our_heat"].append(out[2])
        return out

    def our_forward_rec(mode, batch):
        out = forward(mode, batch)
        if mode == "navigation":
            rec["our_logits"].append(out["fused_logits"].numpy())
        return out

    ours._waypoints, ours._forward = our_wp_rec, our_forward_rec

    def restore():
        jax_agent._jitted["waypoint"], jax_agent._jitted["navigation"] = wp_fn, nav_fn
        del ours._waypoints, ours._forward

    return rec, restore


def nms_margin(heat, max_predictions=5):
    """The smallest relative gap, over the NMS iterations, between the peak
    each iteration takes and the working map's runner-up (the NMS of
    ``heatmap_to_peaks``, replayed on the softmaxed, wrapped map)."""
    b, A, D = heat.shape
    flat = heat.reshape(b, -1).astype(np.float64)
    prob = np.exp(flat - flat.max(1, keepdims=True))
    prob = (prob / prob.sum(1, keepdims=True)).reshape(b, A, D)
    supp = np.concatenate([prob[:, -1:], prob, prob[:, :1]], axis=1)
    margin = np.inf
    for _ in range(max_predictions):
        flat = supp.reshape(b, -1)
        top = flat.max(1, keepdims=True)
        # the wrap rows repeat rows exactly: equal values tie alike on both sides
        second = np.where(flat < top, flat, 0.0).max(1, keepdims=True)
        live = top[:, 0] > 0
        margin = min(margin, float(((top - second) / top.clip(1e-300))[live].min()))
        ix = flat.argmax(1)
        supp = supp * (1.0 - jax_wp._suppression_mask(ix // D, ix % D, A + 2, D, (7.0, 5.0)))
    return margin


def check_heatmaps(rec):
    assert len(rec["our_heat"]) == len(rec["jax_heat"]) > 0
    for ours, ref in zip(rec["our_heat"], rec["jax_heat"]):
        np.testing.assert_allclose(ours, ref, atol=HEAT_ATOL, rtol=0)
        # the NMS decisions cannot flip within that tolerance
        assert nms_margin(ref) > NMS_MARGIN


# ------------------------------------------------------------ waypoints
def test_waypoint_heatmap_and_candidates_match_jax(agent_pair):
    jax_agent, ours = agent_pair(True)
    depth = np.random.default_rng(5).normal(size=(2 * 12, *DEPTH_SHAPE)).astype(np.float32)
    ref = np.asarray(jax_agent._jitted["waypoint"](jax_agent.wp_params, depth))
    with torch.inference_mode():
        got = ours.wp_model(torch.from_numpy(depth)).numpy()
    assert got.shape == ref.shape == (2, wp.NUM_ANGLES, wp.NUM_CLASSES)
    np.testing.assert_allclose(got, ref, atol=HEAT_ATOL, rtol=0)
    assert nms_margin(ref) > NMS_MARGIN
    assert not any(p.requires_grad for p in ours.wp_model.parameters())
    for in_train in (False, True):
        angles, dists, scores = jax_wp.extract_waypoints(ref, in_train=in_train,
                                                         rng=np.random.default_rng(2))
        a2, d2, s2 = wp.extract_waypoints(got, in_train=in_train, rng=np.random.default_rng(2))
        for k in range(2):
            np.testing.assert_array_equal(a2[k], angles[k])
            np.testing.assert_array_equal(d2[k], dists[k])
            np.testing.assert_allclose(s2[k], scores[k], atol=1e-6)


def reference_layout_state_dict(hidden=32, inter=64, depth=16, seed=0):
    """A random state dict with the published checkpoint's key layout
    (TRM_net.py:27-60; pytorch_transformers BERT layer names), including the
    rgb-branch parameters the forward never reads."""
    rng = np.random.default_rng(seed)

    def lin(name, out, inp):
        sd[f"{name}.weight"] = rng.normal(0, 0.2, (out, inp)).astype(np.float32)
        sd[f"{name}.bias"] = rng.normal(0, 0.2, out).astype(np.float32)

    sd = {}
    lin("visual_fc_depth.1", hidden, depth)
    lin("visual_fc_rgb.1", hidden, 8)
    lin("visual_merge.0", hidden, 2 * hidden)
    sd["mergefeats_LayerNorm.weight"] = np.ones(hidden, np.float32)
    sd["mergefeats_LayerNorm.bias"] = np.zeros(hidden, np.float32)
    for i in range(2):
        p = f"waypoint_TRM.bert.encoder.layer.{i}"
        for n in ("query", "key", "value"):
            lin(f"{p}.attention.self.{n}", hidden, hidden)
        lin(f"{p}.attention.output.dense", hidden, hidden)
        lin(f"{p}.intermediate.dense", inter, hidden)
        lin(f"{p}.output.dense", hidden, inter)
        for ln in (f"{p}.attention.output.LayerNorm", f"{p}.output.LayerNorm"):
            sd[f"{ln}.weight"] = rng.normal(1, 0.1, hidden).astype(np.float32)
            sd[f"{ln}.bias"] = rng.normal(0, 0.1, hidden).astype(np.float32)
    lin("vis_classifier.0", hidden, hidden)
    lin("vis_classifier.2", wp.NUM_CLASSES * (wp.NUM_ANGLES // wp.NUM_IMGS), hidden)
    return sd


def test_load_waypoint_ckpt_gives_the_heatmap_of_jaxs_remap(tmp_path):
    sd = reference_layout_state_dict()
    depth = np.random.default_rng(1).normal(size=(2 * 12, *DEPTH_SHAPE)).astype(np.float32)
    jax_cfg = JaxModelConfig(**MODEL)
    tree = jax_wp.load_waypoint_ckpt(sd)
    ref = np.asarray(jax_wp.WaypointPredictor(jax_cfg).apply({"params": tree}, depth))

    model = wp.WaypointPredictor(configs.ModelConfig(**MODEL), depth_feat_size=16)
    model.load_state_dict(wp.load_waypoint_ckpt({"module." + k: v for k, v in sd.items()}))
    with torch.no_grad():
        got = model(torch.from_numpy(depth)).numpy()
    np.testing.assert_allclose(got, ref, atol=HEAT_ATOL, rtol=0)
    assert nms_margin(ref) > NMS_MARGIN
    want = model.state_dict()

    # the checkpoint files --waypoint_ckpt reads: the published torch format,
    # the JAX tree as a flat .npz, the port's own state dict
    published = tmp_path / "check_cwp_bestdist_hfov90"
    torch.save({"predictor": {"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}},
               published)
    npz = tmp_path / "wp.npz"
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    np.savez(npz, **flat)
    own = tmp_path / "wp.pt"
    torch.save(want, own)
    for path in (published, npz, own):
        got_sd = frozen.load_waypoint_params(str(path))
        assert sorted(got_sd) == sorted(want), path
        for k, v in want.items():
            torch.testing.assert_close(got_sd[k], v, rtol=0, atol=0, msg=f"{path}: {k}")
    with pytest.raises(ValueError, match="directory"):
        frozen.load_waypoint_params(str(tmp_path))


# ------------------------------------------------------------ rollouts
@pytest.mark.parametrize("use_bev", [True, False], ids=["ss_bev", "ss_etp"])
@pytest.mark.parametrize("back_algo", ["control", "teleport"])
def test_argmax_eval_matches_jax(agent_pair, use_bev, back_algo):
    jax_agent, ours = agent_pair(use_bev)
    jax_agent.cfg.ce_back_algo = ours.cfg.ce_back_algo = back_algo
    rec, restore = recording(jax_agent, ours)
    try:
        for _ in range(2):
            ref, _ = jax_agent.rollout(feedback="argmax", train=False)
            got, loss = ours.rollout(feedback="argmax", train=False)
            assert loss is None
            for a, b in zip(ref, got):
                assert a["instr_id"] == b["instr_id"]
                np.testing.assert_array_equal(np.stack(b["positions"]), np.stack(a["positions"]))
                assert b["headings"] == a["headings"]
        jax_agent.env.reset_epoch()
        ours.env.reset_epoch()
        assert ours.evaluate(num_batches=1) == jax_agent.evaluate(num_batches=1)
    finally:
        restore()
    check_heatmaps(rec)
    assert len(rec["our_logits"]) == len(rec["jax_logits"]) > 4
    for got, ref in zip(rec["our_logits"], rec["jax_logits"]):
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    assert ours.np_rng.random() == jax_agent.np_rng.random()


def _capture_bundle(agent):
    seen = {}

    def record(rb):
        seen["rb"] = rb
        return 0.0

    agent.learn_from_bundle = record
    return seen


@pytest.mark.parametrize("use_bev", [True, False], ids=["ss_bev", "ss_etp"])
def test_teacher_training_rollout_loss_and_gradients_match_jax(agent_pair, use_bev):
    jax_agent, ours = agent_pair(use_bev)
    bundles = {"jax": _capture_bundle(jax_agent), "ours": _capture_bundle(ours)}
    try:
        ref_traj, ref_loss = jax_agent.rollout(feedback="teacher", train=True)
        got_traj, got_loss = ours.rollout(feedback="teacher", train=True)
    finally:
        del jax_agent.learn_from_bundle, ours.learn_from_bundle
    assert ref_loss == got_loss == 0.0
    for a, b in zip(ref_traj, got_traj):
        np.testing.assert_array_equal(np.stack(b["positions"]), np.stack(a["positions"]))
    ref, got = bundles["jax"]["rb"], bundles["ours"]["rb"]
    assert sorted(got) == sorted(ref) and ("bev_fts" in ref) == use_bev
    for key, val in ref.items():
        mine = got[key]
        mine = mine.numpy() if isinstance(mine, torch.Tensor) else np.asarray(mine)
        val = np.asarray(val)
        assert mine.shape == val.shape and mine.dtype == val.dtype, key
        if key == "bev_fts":
            np.testing.assert_allclose(mine, val, atol=1e-5, rtol=0)
        else:
            np.testing.assert_array_equal(mine, val, err_msg=key)
    assert (ref["targets"] != IGNORE_ID).any()

    T = ref["targets"].shape[0]
    keys = jax.random.split(jax.random.key(7), T + 2)
    loss_ref, grads_ref = jax_agent._fn("loss_grad")(
        jax_agent.params, dict(ref, rng=keys[:T], rng_lang=keys[T], rng_pano=keys[T + 1]))
    ours.model.zero_grad(set_to_none=True)
    with ours._training():
        loss = ours._episode_loss(got)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref), rtol=1e-5)
    assert float(loss_ref) > 0
    grads_ref = flax_to_state_dict(jax.tree.map(np.asarray, grads_ref))
    model_scale = max(float(g.abs().max()) for g in grads_ref.values())
    reached = 0
    for name, p in ours.model.named_parameters():
        want = grads_ref[name].numpy()
        have = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        atol = 1e-5 * float(np.abs(want).max())
        if name in FT_SHIFT_INVARIANT:
            atol = 1e-7 * model_scale
        np.testing.assert_allclose(have, want, rtol=1e-4, atol=atol, err_msg=name)
        reached += bool(np.abs(want).max() > 0)
    assert reached > len(grads_ref) // 2
    ours.model.zero_grad(set_to_none=True)
    # the frozen predictor takes no gradient and stays out of the checkpoint
    assert all(p.grad is None for p in ours.wp_model.parameters())


@pytest.mark.parametrize("use_bev", [True, False], ids=["ss_bev", "ss_etp"])
def test_sampled_training_rollouts_draw_like_jax(agent_pair, use_bev):
    """Scheduled sampling with waypoint sampling and ghost noise: one
    ``np_rng`` drawn in the same order gives the same trajectories."""
    jax_agent, ours = agent_pair(use_bev)
    for a in (jax_agent, ours):
        a.ghost_aug = 0.3
        _capture_bundle(a)
    rec, restore = recording(jax_agent, ours)
    try:
        for ratio in (0.5, 0.0):
            ref, _ = jax_agent.rollout(feedback="sample", train=True, sample_ratio=ratio)
            got, _ = ours.rollout(feedback="sample", train=True, sample_ratio=ratio)
            for a, b in zip(ref, got):
                np.testing.assert_array_equal(np.stack(b["positions"]), np.stack(a["positions"]))
                assert b["headings"] == a["headings"]
    finally:
        restore()
        for a in (jax_agent, ours):
            a.ghost_aug = 0.0
            del a.learn_from_bundle
    check_heatmaps(rec)
    assert ours.np_rng.random() == jax_agent.np_rng.random()


def test_agent_checkpoint_holds_the_navigation_model_only(agent_pair, tmp_path):
    _, ours = agent_pair(True)
    path = ours.save_ckpt(str(tmp_path / "ckpt_1"))
    saved = torch.load(path, weights_only=True)["params"]
    assert sorted(saved) == sorted(ours.model.state_dict())
    assert not any(k.startswith(("depth_fc", "trm_layer", "cls_fc")) for k in saved)


# ------------------------------------------------------------ pretraining
def test_ce_pretraining_losses_match_jax():
    """``configs/ce_pretrain.json``'s flags at a tiny width: the depth
    embedding on, an 11x11 BEV at 1 m, mlm and sap. Neither tree holds a
    ``dep_linear``: no caller passes ``dep_fts``."""
    from test_torch_pretrain import SHAPES as PRE_SHAPES
    from test_torch_pretrain import TINY as PRE_TINY
    from test_torch_pretrain import tt
    from vln_bevbert_tpu.configs import OptimConfig, PretrainConfig
    from vln_bevbert_tpu.data.synthetic import synthetic_pretrain_batch
    from vln_bevbert_tpu.parallel.train_step import init_pretrain_state as jax_init
    from vln_bevbert_tpu.parallel.train_step import make_loss_fn as jax_make_loss_fn
    from vln_bevbert_tpu_torch.models.glocal import GlocalTextPathCMTPreTraining
    from vln_bevbert_tpu_torch.parallel.train_step import build_projector, make_loss_fn

    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "configs", "ce_pretrain.json")) as f:
        import json

        ce = json.load(f)
    flags = {k: ce["model"][k] for k in ("bev_dim", "bev_res", "use_depth_embedding")}
    assert flags == {"bev_dim": 11, "bev_res": 1.0, "use_depth_embedding": True}
    model = dataclasses.replace(PRE_TINY, **flags)
    tasks = tuple(ce["tasks"])
    cfg = PretrainConfig(model=model, shapes=PRE_SHAPES, tasks=tasks, train_batch_size=3,
                         optim=OptimConfig(warmup_steps=2, num_train_steps=10))
    rng = np.random.default_rng(0)
    batch = synthetic_pretrain_batch(rng, 3, PRE_SHAPES, model, with_objects=False, raw_bev=True)
    for key in ("txt_ids", "mlm_tgt", "mlm_ids"):
        batch[key] = (batch[key] % 300).astype(np.int32)
    jax_model, projector, state = jax_init(cfg, batch)
    params = jax.tree.map(np.asarray, perturbed(state.params))
    assert "dep_linear" not in params["bert"]["img_embeddings"]
    ours = GlocalTextPathCMTPreTraining(configs.ModelConfig(**dataclasses.asdict(model)), tasks)
    load_flax_params(ours, params)
    ours.train()
    our_proj = build_projector(ours.cfg, configs.ShapeConfig(**dataclasses.asdict(PRE_SHAPES)))
    for task in tasks:
        loss_ref, _ = jax_make_loss_fn(jax_model, projector)(
            jax.tree.map(jax.numpy.asarray, params), batch, task, jax.random.key(0))
        loss, _ = make_loss_fn(ours, our_proj)(tt(batch), task)
        np.testing.assert_allclose(float(loss.detach()), float(loss_ref), atol=1e-4, rtol=1e-4)
    with pytest.raises(NotImplementedError, match="dep_fts"):
        ours.bert.img_embeddings(
            torch.zeros(1, 2, model.image_feat_size), torch.zeros(1, 2, 7),
            torch.zeros(1, 2, dtype=torch.long), torch.ones(1, dtype=torch.long),
            dep_fts=torch.zeros(1, 2, 128))
