"""The port's object-grounding navigation (REVERIE/SOON) against the JAX
package, on the CPU, at the tiny shapes of ``test_obj_nav.py``.

Parameters go JAX -> port through ``convert.load_flax_params`` with every
dropout rate 0 where outputs are compared, so both sides compute the same
function:

- the object slots of ``ImageEmbeddings`` (their own ``obj_linear`` and the
  shared ``img_linear`` branch), the object keys of ``LocalBEVEncoder`` and
  the navigation model's ``obj_logits``, at float32 atol=rtol=1e-4;
- the REVERIE eval rollout: equal trajectories and ``pred_objid``, fused and
  object logits of every step at 1e-4, equal metrics (sr, spl, rgs, rgspl,
  oracle_sr);
- the bundle a teacher-forced training rollout replays, object slots and
  object targets included (equal key by key, BEV features within 1e-5);
- the replay's episode loss and gradients with the object cross-entropy,
  from perturbed parameters, at ``test_torch_finetune.py``'s tolerances;
- the pretrain -> fine-tune transfer of the object parameters;
- the CLI's config and synthetic object world for reverie and soon.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from test_torch_finetune import FT_SHIFT_INVARIANT, NO_DROPOUT, perturbed
from test_torch_host import assert_same
from test_torch_models import _merge
from test_torch_nav import _tiny_config
from test_torch_obj_pretrain import SHAPES as PRE_SHAPES
from test_torch_obj_pretrain import TASKS as PRE_TASKS
from test_torch_obj_pretrain import obj_batch, obj_model
from vln_bevbert_tpu.cli import finetune as jax_cli
from vln_bevbert_tpu.configs import FinetuneConfig, ModelConfig, OptimConfig, PretrainConfig
from vln_bevbert_tpu.configs import ShapeConfig
from vln_bevbert_tpu.data.loader import make_synthetic_annotations
from vln_bevbert_tpu.data.nav_graph import (
    build_scanvp_cands,
    load_nav_graphs,
    write_synthetic_connectivity,
)
from vln_bevbert_tpu.data.synthetic import synthetic_replay_bundle
from vln_bevbert_tpu.models import encoders as jenc
from vln_bevbert_tpu.models.nav import GlocalTextPathNavCMT as JaxNav
from vln_bevbert_tpu.models.surgery import count_transferred as jax_count
from vln_bevbert_tpu.nav import obj_env as jax_obj_env
from vln_bevbert_tpu.nav.agent import GMapNavAgent as JaxAgent
from vln_bevbert_tpu.nav.agent import make_replay_agent as jax_replay_agent
from vln_bevbert_tpu.parallel.train_step import init_pretrain_state as jax_init_pretrain
from vln_bevbert_tpu_torch.cli import finetune as cli
from vln_bevbert_tpu_torch.convert import flax_to_state_dict, load_flax_params
from vln_bevbert_tpu_torch.models import encoders as tenc
from vln_bevbert_tpu_torch.models.glocal import GlocalTextPathCMTPreTraining
from vln_bevbert_tpu_torch.models.nav import GlocalTextPathNavCMT
from vln_bevbert_tpu_torch.models.surgery import count_transferred, transfer_pretrained
from vln_bevbert_tpu_torch.nav import obj_env as port_obj_env
from vln_bevbert_tpu_torch.nav.agent import IGNORE_ID, GMapNavAgent, make_replay_agent

TOL = dict(atol=1e-4, rtol=1e-4)
TINY = ModelConfig(
    vocab_size=30522, hidden_size=32, num_attention_heads=2, intermediate_size=64,
    num_l_layers=1, num_pano_layers=1, num_x_layers=1, image_feat_size=16,
    obj_feat_size=20, obj_prob_size=8, bev_grid_feat_size=12, bev_dim=5,
    bev_res=1.5, dtype="float32",
)
SHAPES = ShapeConfig(
    max_txt_len=48, max_steps=5, max_pano_len=40, max_gmap_len=16,
    max_local_len=8, max_objects=3, num_views=2, grid_hw=4, max_pc_steps=3,
)
# object features of their own width, and of the views' width (REVERIE's)
BRANCHES = {"obj_linear": 20, "shared_img_linear": TINY.image_feat_size}


def nav_cfg(branch="obj_linear", **kw) -> FinetuneConfig:
    model = dataclasses.replace(TINY, obj_feat_size=BRANCHES[branch])
    return FinetuneConfig(model=model, shapes=SHAPES, batch_size=2, max_action_len=4,
                          dataset="reverie", **kw)


def tt(x):
    if isinstance(x, dict):
        return {k: tt(v) for k, v in x.items()}
    return torch.from_numpy(np.array(x))


def close(ours, ref, **tol):
    np.testing.assert_allclose(ours.detach().float().numpy(), np.asarray(ref, np.float32),
                               **(tol or TOL))


def make_obj_env(pkg_env, root, model=TINY, cls="ReverieObjectNavBatch"):
    """One scan, 8 nodes, two objects per viewpoint, in-memory features; the
    goal object of each item is the first object of its last viewpoint. The
    same world on every call."""
    rng = np.random.default_rng(11)
    conn = os.path.join(root, "conn")
    if not os.path.exists(os.path.join(conn, "scans.txt")):
        write_synthetic_connectivity(conn, rng, n_scans=1, n_nodes=8)
    rng = np.random.default_rng(12)
    graphs = load_nav_graphs(conn)
    dbs = cli.synthetic_feature_dbs(
        rng, {s: g.node_ids for s, g in graphs.items()},
        image_feat_size=model.image_feat_size, grid_feat_size=model.bev_grid_feat_size,
        grid_hw=SHAPES.grid_hw, num_views=SHAPES.num_views,
    )
    del dbs["sem_db"]
    obj_data, obj2vps, oid = {}, {}, 0
    for scan, g in graphs.items():
        for vp in g.node_ids:
            ids = [str(oid), str(oid + 1)]
            oid += 2
            obj_data[f"{scan}_{vp}"] = {
                "fts": rng.normal(size=(2, model.obj_feat_size + model.obj_prob_size)
                                  ).astype(np.float32),
                "directions": rng.uniform(-1, 1, (2, 2)).astype(np.float32),
                "sizes": rng.uniform(20, 100, (2, 2)).astype(np.float32),
                "obj_ids": ids,
            }
            for i in ids:
                obj2vps[f"{scan}_{i}"] = [vp]
    annos = make_synthetic_annotations(graphs, rng, n_items=6, min_len=2, max_len=4)
    for a in annos:
        scan, goal = a["scan"], a["path"][-1]
        a["objId"] = obj_data[f"{scan}_{goal}"]["obj_ids"][0]
        a["end_vps"] = [goal]
    return getattr(pkg_env, cls)(
        annos, graphs, build_scanvp_cands(graphs), batch_size=2,
        image_feat_size=model.image_feat_size, obj_db=pkg_env.ObjectDB(obj_data),
        obj2vps=obj2vps, max_objects=SHAPES.max_objects, **dbs)


def agent_pair(root, cfg):
    """(JAX agent, port agent) on the same world with the same parameters:
    JAX's initial ones, perturbed (seed 3) so that greedy episodes walk
    several steps and ground some goal objects."""
    jax_agent = JaxAgent(cfg, make_obj_env(jax_obj_env, root, cfg.model))
    jax_agent.init_params()
    jax_agent.params = jax.tree.map(jax.numpy.asarray, perturbed(jax_agent.params, seed=3))
    agent = GMapNavAgent(cfg, make_obj_env(port_obj_env, root, cfg.model), device="cpu")
    load_flax_params(agent.model, jax.tree.map(np.asarray, jax_agent.params))
    return jax_agent, agent


# ------------------------------------------------------------------ modules
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_object_slots_of_the_modules_match_flax(branch):
    """``ImageEmbeddings`` with object slots, ``LocalBEVEncoder`` with object
    keys, and the navigation model's panorama and navigation modes."""
    cfg = dataclasses.replace(TINY, obj_feat_size=BRANCHES[branch])
    rng = np.random.default_rng(0)
    B, V, O, A, D, L, N, K = 2, 7, 3, cfg.angle_feat_size, cfg.hidden_size, 6, 5, 4
    C = cfg.num_bev_tokens
    pano_in = {
        "view_fts": rng.normal(size=(B, V, cfg.image_feat_size)).astype(np.float32),
        "loc_fts": rng.normal(size=(B, V + O, A + 3)).astype(np.float32),
        "nav_types": rng.integers(0, 3, size=(B, V + O)).astype(np.int32),
        "view_lens": np.array([V, 3], np.int32),
        "obj_fts": rng.normal(size=(B, O, cfg.obj_feat_size)).astype(np.float32),
        "obj_lens": np.array([O, 1], np.int32),
    }
    txt_masks = np.ones((B, L), bool)
    txt_masks[1, 4:] = False
    nav_in = {
        "txt_embeds": rng.normal(size=(B, L, D)).astype(np.float32), "txt_masks": txt_masks,
        "gmap_img_embeds": rng.normal(size=(B, N, D)).astype(np.float32),
        "gmap_step_ids": rng.integers(0, 5, (B, N)).astype(np.int32),
        "gmap_pos_fts": rng.normal(size=(B, N, A + 3)).astype(np.float32),
        "gmap_masks": np.ones((B, N), bool),
        "gmap_pair_dists": rng.uniform(0, 1, (B, N, N)).astype(np.float32),
        "gmap_visited_masks": np.eye(B, N, 1, dtype=bool),
        "bev_fts": rng.normal(size=(B, C, cfg.bev_grid_feat_size)).astype(np.float32),
        "bev_pos_fts": rng.normal(size=(B, C, A + 6)).astype(np.float32),
        "bev_masks": rng.uniform(size=(B, C)) < 0.8,
        "bev_nav_masks": rng.uniform(size=(B, C)) < 0.2,
        "bev_cand_idxs": rng.integers(0, C, (B, K)).astype(np.int32),
        "local_masks": np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool),
        "fuse_map": (rng.uniform(size=(B, N, K)) < 0.3).astype(np.float32),
        "obj_embeds": rng.normal(size=(B, O, D)).astype(np.float32),
        "obj_masks": np.array([[1, 1, 0], [1, 0, 0]], bool),
    }
    tok = rng.normal(size=(D,)).astype(np.float32)

    img = jenc.ImageEmbeddings(cfg)
    args = [pano_in[k] for k in ("view_fts", "loc_fts", "nav_types", "view_lens")]
    params = img.init(jax.random.key(0), *args, pano_in["obj_fts"], pano_in["obj_lens"],
                      token_type_vis=tok)["params"]
    assert ("obj_linear" in params) == (branch == "obj_linear")
    ref_x, ref_m = img.apply({"params": params}, *args, pano_in["obj_fts"],
                             pano_in["obj_lens"], token_type_vis=tok)
    ours = tenc.ImageEmbeddings(cfg)
    load_flax_params(ours, jax.tree.map(np.asarray, params))
    x, m = ours.eval()(*map(tt, args), tt(tok), tt(pano_in["obj_fts"]), tt(pano_in["obj_lens"]))
    close(x, ref_x)
    np.testing.assert_array_equal(m.numpy(), np.asarray(ref_m))

    local = jenc.LocalBEVEncoder(cfg)
    largs = [nav_in[k] for k in ("txt_embeds", "txt_masks", "bev_fts", "bev_pos_fts",
                                 "bev_masks", "bev_nav_masks", "obj_embeds", "obj_masks")]
    params = local.init(jax.random.key(1), *largs)["params"]
    ref_bev, ref_obj = local.apply({"params": params}, *largs)
    ours = tenc.LocalBEVEncoder(cfg)
    load_flax_params(ours, jax.tree.map(np.asarray, params))
    bev, obj = ours.eval()(*map(tt, largs))
    close(bev, ref_bev)
    close(obj, ref_obj)

    model = JaxNav(cfg)
    lang_in = {"txt_ids": np.ones((B, L), np.int32), "txt_masks": txt_masks}
    params = {}
    for mode, inp in (("navigation", nav_in), ("language", lang_in), ("panorama", pano_in)):
        params = _merge(params, jax.tree.map(
            np.asarray, model.init(jax.random.key(2), mode, inp)["params"]))
    assert "og_head" in params
    ours = GlocalTextPathNavCMT(cfg)
    load_flax_params(ours, params)
    ours.eval()
    (x, m), (rx, rm) = ours("panorama", tt(pano_in)), model.apply(
        {"params": params}, "panorama", pano_in)
    close(x, rx)
    np.testing.assert_array_equal(m.numpy(), np.asarray(rm))
    out, ref = ours("navigation", tt(nav_in)), model.apply({"params": params}, "navigation",
                                                           nav_in)
    for key in ("global_logits", "local_logits", "fused_logits", "bev_embeds", "obj_logits"):
        close(out[key], ref[key])
    assert (out["obj_logits"].detach().numpy()[~nav_in["obj_masks"]] <= -9999).all()


# ------------------------------------------------------------------ rollouts
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_reverie_eval_rollout_matches_jax(tmp_path, branch):
    jax_agent, agent = agent_pair(tmp_path, nav_cfg(branch))
    jax_logits, our_logits = [], []
    jax_nav = jax_agent._fn("navigation")

    def jax_nav_recorded(params, batch):
        out = jax_nav(params, batch)
        jax_logits.append((np.asarray(out["fused_logits"]), np.asarray(out["obj_logits"])))
        return out

    jax_agent._jitted["navigation"] = jax_nav_recorded
    forward = agent._forward

    def forward_recorded(mode, batch):
        out = forward(mode, batch)
        if mode == "navigation":
            our_logits.append((out["fused_logits"].numpy(), out["obj_logits"].numpy()))
        return out

    agent._forward = forward_recorded
    jax_preds = jax_agent.test(max_batches=2)
    our_preds = agent.test(max_batches=2)

    for key in ("instr_id", "trajectory", "pred_objid"):
        assert [p[key] for p in our_preds] == [p[key] for p in jax_preds], key
    assert all(p["pred_objid"] is not None for p in our_preds)
    assert len(our_logits) == len(jax_logits) > 4
    for ours, ref in zip(our_logits, jax_logits):
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a, b, **TOL)
    got, want = agent.env.eval_metrics(our_preds), jax_agent.env.eval_metrics(jax_preds)
    assert got == want
    for key in ("sr", "spl", "rgs", "rgspl", "oracle_sr"):
        assert 0.0 <= got[0][key] <= 100.0, key


def test_teacher_training_rollout_replays_the_jax_object_bundle(tmp_path):
    jax_agent, agent = agent_pair(tmp_path, nav_cfg())
    bundles = {}
    for name, a in (("jax", jax_agent), ("ours", agent)):
        def record(rb, name=name):
            bundles[name] = rb
            return 0.0

        a.learn_from_bundle = record
        trajs, loss = a.rollout(feedback="teacher", train=True)
        assert loss == 0.0
        bundles[name + "_trajs"] = [(t["path"], t["pred_objid"]) for t in trajs]
    ref, got = bundles["jax"], bundles["ours"]
    assert bundles["ours_trajs"] == bundles["jax_trajs"]
    assert sorted(got) == sorted(ref) and {"obj_fts", "obj_lens", "obj_targets"} <= set(ref)
    for key, val in ref.items():
        mine = got[key]
        mine = mine.numpy() if isinstance(mine, torch.Tensor) else np.asarray(mine)
        val = np.asarray(val)
        assert mine.shape == val.shape and mine.dtype == val.dtype, key
        if key == "bev_fts":
            np.testing.assert_allclose(mine, val, atol=1e-5, rtol=0)
        else:
            np.testing.assert_array_equal(mine, val, err_msg=key)
    assert ref["loc_fts"].shape[2] == SHAPES.max_pano_len + SHAPES.max_objects
    assert (ref["obj_targets"] != IGNORE_ID).any()  # the teacher reaches goal objects
    assert (ref["nav_types"] == 2).any()


# ------------------------------------------------------------------- replay
REPLAY_CFG = FinetuneConfig(
    model=dataclasses.replace(TINY, **NO_DROPOUT),
    shapes=ShapeConfig(max_txt_len=16, max_steps=5, max_pano_len=6, max_gmap_len=8,
                       max_local_len=4, max_objects=3, num_views=2, grid_hw=4,
                       max_pc_steps=2),
    batch_size=2, max_action_len=5, learning_rate=5e-5, weight_decay=0.1,
)
# og_head's bias and LayerNorm shift add alike to every object logit
OBJ_SHIFT_INVARIANT = FT_SHIFT_INVARIANT + ("og_head.fc2.bias", "og_head.ln.bias")


def padded_object_bundle(seed=11, padded=2):
    """A synthetic replay bundle with object slots whose last ``padded``
    steps are zeros with IGNORE_ID targets, as ``_learn`` pads."""
    rb = synthetic_replay_bundle(np.random.default_rng(seed), REPLAY_CFG, REPLAY_CFG.batch_size)
    for key, val in rb.items():
        if key not in ("txt_ids", "txt_masks", "step_idx"):
            val[-padded:] = IGNORE_ID if key in ("targets", "obj_targets") else 0
    assert (rb["obj_targets"][:-padded] != IGNORE_ID).any()
    return rb


def test_object_episode_loss_and_gradients_match_jax():
    jax_agent = jax_replay_agent(REPLAY_CFG, batch_size=REPLAY_CFG.batch_size)
    params = perturbed(jax_agent.params)
    ours = make_replay_agent(REPLAY_CFG, REPLAY_CFG.batch_size, device="cpu")
    load_flax_params(ours.model, params)
    rb = padded_object_bundle()
    T = rb["targets"].shape[0]
    keys = jax.random.split(jax.random.key(7), T + 2)
    loss_ref, grads_ref = jax_agent._fn("loss_grad")(
        jax.tree.map(jax.numpy.asarray, params),
        dict(rb, rng=keys[:T], rng_lang=keys[T], rng_pano=keys[T + 1]))
    # without the object term, JAX's loss would be smaller
    no_obj = dict(rb, obj_targets=np.full_like(rb["obj_targets"], IGNORE_ID))
    assert float(loss_ref) > float(jax_agent._fn("loss_grad")(
        jax.tree.map(jax.numpy.asarray, params),
        dict(no_obj, rng=keys[:T], rng_lang=keys[T], rng_pano=keys[T + 1]))[0])

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
    named = dict(ours.model.named_parameters())
    assert set(named) == set(grads_ref) and "og_head.fc1.weight" in named
    for name, p in named.items():
        ref = grads_ref[name].numpy()
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        atol = 1e-5 * float(np.abs(ref).max())
        if name in OBJ_SHIFT_INVARIANT:  # rounding noise: within 1e-7 of the model's scale
            atol = 1e-7 * model_scale
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=atol, err_msg=name)
    for name in ("og_head.fc1.weight", "bert.img_embeddings.obj_linear.weight"):
        assert np.abs(grads_ref[name].numpy()).max() > 0, name


# ----------------------------------------------------------------- transfer
@pytest.mark.parametrize("branch", ["obj_linear", "shared_img_linear"])
def test_object_transfer_counts_match_jax(branch):
    """An object pretraining model (mlm, mrc, sap, og, masksem) into an object
    navigation model: everything but the word embeddings (another vocabulary)
    transfers, ``og_head`` and the object embedding included."""
    pre_model = obj_model(branch)
    pre_cfg = PretrainConfig(model=pre_model, shapes=PRE_SHAPES, tasks=PRE_TASKS,
                             optim=OptimConfig(warmup_steps=2, num_train_steps=10),
                             train_batch_size=3)
    _, _, state = jax_init_pretrain(pre_cfg, obj_batch(pre_model))
    pre_params = jax.tree.map(np.asarray, state.params)
    cfg = FinetuneConfig(model=dataclasses.replace(pre_model, vocab_size=500),
                         shapes=REPLAY_CFG.shapes, batch_size=2, max_action_len=5)
    nav_params = jax.tree.map(np.asarray, jax_replay_agent(cfg, batch_size=2).params)

    pre = GlocalTextPathCMTPreTraining(pre_model, PRE_TASKS)
    load_flax_params(pre, pre_params)
    agent = GMapNavAgent(cfg, None, device="cpu")
    load_flax_params(agent.model, nav_params)
    fresh = agent.model.state_dict()
    n = count_transferred(pre.state_dict(), fresh)
    assert n == jax_count(pre_params, nav_params) == len(fresh) - 1
    got = transfer_pretrained(pre.state_dict(), fresh)
    for name in ("og_head.fc2.weight", "bert.img_embeddings.img_linear.weight",
                 *(["bert.img_embeddings.obj_linear.weight"] if branch == "obj_linear" else [])):
        assert torch.equal(got[name], pre.state_dict()[name]), name
    assert "obj_classifier.fc1.weight" not in got


# ---------------------------------------------------------------------- CLI
@pytest.mark.parametrize("dataset", ["reverie", "soon"])
def test_cli_object_config_and_world_match_jax(tmp_path, monkeypatch, dataset):
    """``--synthetic --dataset reverie|soon``: the port's config equals the
    JAX CLI's (its batch is per chip there), and so do the object envs built
    in memory: env types, annotations with their goal objects, the object
    store, the goal table and the first observations."""
    argv = ["--synthetic", "--dataset", dataset, "--config", _tiny_config(tmp_path),
            "--output_dir", str(tmp_path)]
    build_envs, seen = jax_cli.build_envs, {}

    def stop(cfg, args):
        seen["cfg"] = cfg
        raise RuntimeError("config built")

    monkeypatch.setattr(jax_cli, "build_envs", stop)
    with pytest.raises(RuntimeError, match="config built"):
        jax_cli.main(argv + ["--test"])
    ref = seen["cfg"]
    ref.batch_size //= jax.device_count()
    args = cli.parse_args(argv + ["--device", "cpu"])
    cfg = cli.make_config(args)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.model.obj_feat_size == 768

    jax_args = jax_cli.parse_args(argv + ["--synth_dir", str(tmp_path / "synth")])
    jax_train, jax_vals, jax_aug = build_envs(ref, jax_args)
    train, vals, aug = cli.build_synthetic_envs(cfg, args)
    assert jax_aug is None and aug is None and vals.keys() == jax_vals.keys()
    for a, b in [(jax_train, train)] + [(jax_vals[k], vals[k]) for k in vals]:
        assert type(a).__name__ == type(b).__name__ == (
            "SoonObjectNavBatch" if dataset == "soon" else "ReverieObjectNavBatch")
        assert a.multi_endpoints == b.multi_endpoints
        assert_same(a.data, b.data, "annotations")
        assert_same(a.obj_db.data, b.obj_db.data, "objects")
        assert_same(a.obj2vps, b.obj2vps, "obj2vps")
        assert_same(a.reset(), b.reset(), "reset obs")
    assert train.multi_endpoints and not vals["val_unseen"].multi_endpoints
