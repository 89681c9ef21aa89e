"""Parity of the port's object-grounding pretraining (REVERIE/SOON object
slots; the mrc and og tasks) with the JAX package, on the CPU.

The same parameters (initialised by JAX's ``init_pretrain_state``, carried
over by ``convert.py``) and the same numpy object batch
(``synthetic_pretrain_batch(with_objects=True, raw_bev=True)``, so the step's
lift-splat runs too) go through both, with every dropout rate 0. Each case
runs twice: object features of their own width (``obj_linear``/``obj_ln``)
and of the views' width (shared ``img_linear``/``img_ln``, the REVERIE
configuration's 768 == 768).

Tolerances as in ``test_torch_pretrain.py``: losses and metrics at
atol=rtol=1e-4; a parameter's gradient within 1e-5 of its own largest
magnitude, plus 1e-10 of the largest gradient in the model.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_pretrain import SHAPES as BASE_SHAPES
from test_torch_pretrain import TINY as BASE_TINY
from test_torch_pretrain import _close, tt
from vln_bevbert_tpu.configs import OptimConfig, PretrainConfig
from vln_bevbert_tpu.data.synthetic import synthetic_pretrain_batch
from vln_bevbert_tpu.models import GlocalTextPathCMTPreTraining as JaxPreTraining
from vln_bevbert_tpu.parallel.train_step import init_pretrain_state as jax_init
from vln_bevbert_tpu.parallel.train_step import make_loss_fn as jax_make_loss_fn
from vln_bevbert_tpu_torch.convert import flax_to_state_dict, load_flax_params, module_to_flax
from vln_bevbert_tpu_torch.models.glocal import GlocalTextPathCMTPreTraining
from vln_bevbert_tpu_torch.parallel.optim import decay_mask
from vln_bevbert_tpu_torch.parallel.train_step import build_projector, make_loss_fn

TASKS = ("mlm", "mrc", "sap", "og", "masksem")
# object slots at the views' width share img_linear; another width has its own
BRANCHES = {"obj_linear": 30, "shared_img_linear": BASE_TINY.image_feat_size}
SHAPES = dataclasses.replace(BASE_SHAPES, max_objects=3)


def obj_model(branch: str):
    return dataclasses.replace(BASE_TINY, obj_feat_size=BRANCHES[branch], obj_prob_size=9)


def obj_batch(model, batch=3):
    """The first seed's batch in which every row has objects at its last
    step (so og grounds each row) and mrc classifies some of them."""
    for seed in range(100):
        rng = np.random.default_rng(seed)
        b = synthetic_pretrain_batch(rng, batch, SHAPES, model, with_objects=True,
                                     raw_bev=True)
        last_lens = b["traj_obj_lens"][np.arange(batch), b["traj_last_step"]]
        if (last_lens > 0).all() and (b["obj_mrc_masks"] & (np.arange(SHAPES.max_objects)
                                                             < last_lens[:, None])).any():
            break
    for key in ("txt_ids", "mlm_tgt", "mlm_ids"):
        b[key] = (b[key] % 300).astype(np.int32)
    b["bev_mrc_masks"][:, ::2] = True  # masksem supervises some splatted cells
    assert (b["obj_labels"] >= 0).all()
    return b


@pytest.fixture(scope="module", params=list(BRANCHES))
def models(request):
    """(branch, JAX projector, numpy params, batch, port model, port projector)."""
    model_cfg = obj_model(request.param)
    cfg = PretrainConfig(model=model_cfg, shapes=SHAPES,
                         optim=OptimConfig(warmup_steps=2, num_train_steps=10),
                         tasks=TASKS, train_batch_size=3)
    batch = obj_batch(model_cfg)
    _, projector, state = jax_init(cfg, batch)
    params = jax.tree.map(np.asarray, state.params)
    ours = GlocalTextPathCMTPreTraining(model_cfg, TASKS)
    load_flax_params(ours, params)
    ours.train()  # dropout is on; every rate is 0
    return request.param, projector, params, batch, ours, build_projector(model_cfg, SHAPES)


def test_object_pretraining_tree_converts_both_ways_strictly(models):
    branch, _, params, _, ours, _ = models
    back = module_to_flax(ours)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    img = params["bert"]["img_embeddings"]
    assert ("obj_linear" in img) == (branch == "obj_linear") == ("obj_ln" in img)
    assert {"obj_classifier", "og_head"} <= set(params)
    mask = decay_mask(ours)
    assert mask["og_head.fc1.weight"] and not mask["og_head.ln.weight"]
    assert mask["obj_classifier.fc2.weight"] and not mask["obj_classifier.fc2.bias"]


@pytest.mark.parametrize("task", TASKS)
def test_object_task_loss_and_metrics_match_jax(models, task):
    branch, projector, params, batch, ours, our_proj = models
    jax_model = JaxPreTraining(obj_model(branch), tasks=TASKS)
    loss_ref, metrics_ref = jax_make_loss_fn(jax_model, projector)(
        params, batch, task, jax.random.key(0))
    loss, metrics = make_loss_fn(ours, our_proj)(tt(batch), task)
    assert loss.dtype == torch.float32 and np.isfinite(float(loss_ref)) and float(loss_ref) > 0
    _close(loss, loss_ref)
    assert set(metrics) == set(metrics_ref)
    for key, ref in metrics_ref.items():
        _close(metrics[key], ref)


@pytest.mark.parametrize("task", ["mrc", "og"])
def test_object_task_gradients_match_jax(models, task):
    branch, projector, params, batch, ours, our_proj = models
    jax_model = JaxPreTraining(obj_model(branch), tasks=TASKS)
    grads_ref = jax.grad(lambda p: jax_make_loss_fn(jax_model, projector)(
        p, batch, task, jax.random.key(0))[0])(params)
    grads_ref = flax_to_state_dict(jax.tree.map(np.asarray, grads_ref))
    ours.zero_grad(set_to_none=True)
    loss, _ = make_loss_fn(ours, our_proj)(tt(batch), task)
    loss.backward()
    named = dict(ours.named_parameters())
    assert set(named) == set(grads_ref)
    model_scale = max(float(g.abs().max()) for g in grads_ref.values())
    for name, p in named.items():
        ref = grads_ref[name].numpy()
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        atol = 1e-5 * float(np.abs(ref).max()) + 1e-10 * model_scale
        np.testing.assert_allclose(got, ref, atol=atol, rtol=0, err_msg=name)
    # the task reaches its head and the object slots' embedding
    head = "obj_classifier" if task == "mrc" else "og_head"
    obj_in = ("bert.img_embeddings.obj_linear.weight" if branch == "obj_linear"
              else "bert.img_embeddings.img_linear.weight")
    for name in (f"{head}.fc1.weight", obj_in):
        assert np.abs(grads_ref[name].numpy()).max() > 0, name


def test_object_pretraining_trainer_runs_every_task(tmp_path):
    """``PretrainTrainer`` over a ``TextPathData`` with an ``ObjectDB`` of the
    synthetic REVERIE world (the library path of object pretraining), with
    dropout on: each of the five tasks runs, losses and gradient norms are
    finite, og_acc lies in [0, 1], and the checkpoint restores bit for bit."""
    from vln_bevbert_tpu_torch.cli.finetune import synthetic_feature_dbs
    from vln_bevbert_tpu_torch.data.loader import PretrainLoader, make_synthetic_object_world
    from vln_bevbert_tpu_torch.data.nav_graph import (
        build_scanvp_cands,
        load_nav_graphs,
        write_synthetic_connectivity,
    )
    from vln_bevbert_tpu_torch.data.pathdata import TextPathData
    from vln_bevbert_tpu_torch.nav.obj_env import ObjectDB
    from vln_bevbert_tpu_torch.pretrain.trainer import PretrainTrainer

    model = dataclasses.replace(obj_model("obj_linear"), vocab_size=30522,
                                hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                                feat_dropout=0.4)
    cfg = PretrainConfig(model=model, shapes=SHAPES, tasks=TASKS, mix_ratio=(1,) * 5,
                         task_block_size=1, train_batch_size=2, seed=3,
                         optim=OptimConfig(warmup_steps=2, num_train_steps=10),
                         output_dir=str(tmp_path))
    rng = np.random.default_rng(5)
    write_synthetic_connectivity(str(tmp_path / "conn"), rng, n_scans=1, n_nodes=10)
    graphs = load_nav_graphs(str(tmp_path / "conn"))
    dbs = synthetic_feature_dbs(rng, {s: g.node_ids for s, g in graphs.items()},
                                image_feat_size=model.image_feat_size,
                                grid_feat_size=model.bev_grid_feat_size,
                                grid_hw=SHAPES.grid_hw, num_views=SHAPES.num_views,
                                num_sem=model.num_sem_classes)
    annos, obj_data, _ = make_synthetic_object_world(
        graphs, rng, n_items=10, obj_feat_size=model.obj_feat_size,
        obj_prob_size=model.obj_prob_size)
    db = TextPathData(annos, graphs, build_scanvp_cands(graphs), **dbs,
                      obj_db=ObjectDB(obj_data), image_feat_size=model.image_feat_size,
                      obj_feat_size=model.obj_feat_size, obj_prob_size=model.obj_prob_size,
                      max_objects=SHAPES.max_objects, max_txt_len=SHAPES.max_txt_len,
                      bev_dim=model.bev_dim, bev_res=model.bev_res,
                      num_views=SHAPES.num_views, dataset="reverie")
    trainer = PretrainTrainer(cfg, PretrainLoader(db, cfg, seed=cfg.seed, prefetch=0), "cpu")
    meters = trainer.train()
    assert {k.split("/")[0] for k in meters} == set(TASKS)
    for key, val in meters.items():
        assert np.isfinite(val), key
    assert 0.0 <= meters["og/og_acc"] <= 1.0 and meters["mrc/mrc_n"] >= 1
    path = trainer.save(trainer.state.step)
    fresh = PretrainTrainer(cfg, trainer.train_loader, "cpu")
    fresh.restore(path)
    for a, b in zip(fresh.model.parameters(), trainer.model.parameters()):
        assert torch.equal(a, b)
