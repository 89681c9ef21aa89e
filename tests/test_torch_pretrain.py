"""Parity of the port's pretraining model (vln_bevbert_tpu_torch.models.glocal,
parallel.train_step) with the JAX package: the same parameters (initialised
by JAX's ``init_pretrain_state``, carried over by ``convert.py``) and the
same numpy batch (``synthetic_pretrain_batch(raw_bev=True)``, so the step's
lift-splat runs too) go through both, with every dropout rate 0 so that both
sides are deterministic.

Tolerances, float32 throughout: losses and metrics at atol=rtol=1e-4 (the
algorithm; sums run in another order). A parameter's gradient within 1e-5 of
its own largest magnitude, plus 1e-10 of the largest gradient in the model:
gradients that cancel to ~0 (a head's bias under softmax) keep float32
rounding noise of the model's scale (measured: <= 1e-6 relative, and
absolute errors <= 3e-8 where a gradient of 1.5e-8 sits beside 3e4).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from vln_bevbert_tpu.configs import ModelConfig, OptimConfig, PretrainConfig, ShapeConfig
from vln_bevbert_tpu.data.synthetic import synthetic_pretrain_batch
from vln_bevbert_tpu.models import GlocalTextPathCMTPreTraining as JaxPreTraining
from vln_bevbert_tpu.parallel.train_step import init_pretrain_state as jax_init
from vln_bevbert_tpu.parallel.train_step import make_loss_fn as jax_make_loss_fn
from vln_bevbert_tpu_torch.convert import flax_to_state_dict, load_flax_params, module_to_flax
from vln_bevbert_tpu_torch.models.glocal import GlocalTextPathCMTPreTraining
from vln_bevbert_tpu_torch.models.nav import GlocalTextPathNavCMT
from vln_bevbert_tpu_torch.parallel.train_step import build_projector, make_loss_fn

TOL = dict(atol=1e-4, rtol=1e-4)
TASKS = ("mlm", "sap", "sem", "masksem")
TINY = ModelConfig(
    vocab_size=400, hidden_size=64, num_attention_heads=2, intermediate_size=128,
    num_l_layers=2, num_pano_layers=2, num_x_layers=2, image_feat_size=24,
    bev_grid_feat_size=20, bev_dim=5, num_sem_classes=7, dtype="float32",
    max_position_embeddings=64, hidden_dropout_prob=0.0,
    attention_probs_dropout_prob=0.0, feat_dropout=0.0,
)
SHAPES = ShapeConfig(
    max_txt_len=16, max_steps=3, max_pano_len=8, max_gmap_len=10,
    max_local_len=6, max_objects=0, num_views=2, grid_hw=4, max_masked_tokens=4,
)


def tiny_cfg(**kw) -> PretrainConfig:
    return PretrainConfig(model=TINY, shapes=SHAPES,
                          optim=OptimConfig(warmup_steps=2, num_train_steps=10),
                          tasks=TASKS, train_batch_size=3, **kw)


def make_batch(batch=3, seed=0):
    rng = np.random.default_rng(seed)
    b = synthetic_pretrain_batch(rng, batch, SHAPES, TINY, with_objects=False, raw_bev=True)
    for key in ("txt_ids", "mlm_tgt", "mlm_ids"):
        b[key] = (b[key] % 300).astype(np.int32)
    b["bev_mrc_masks"][:, ::2] = True  # masksem supervises some splatted cells
    return b


def tt(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def models():
    """(JAX model, projector, numpy params, batch, port model, port projector)."""
    cfg = tiny_cfg()
    batch = make_batch()
    model, projector, state = jax_init(cfg, batch)
    params = jax.tree.map(np.asarray, state.params)
    ours = GlocalTextPathCMTPreTraining(TINY, TASKS)
    load_flax_params(ours, params)
    ours.train()  # dropout is on; every rate is 0
    return model, projector, params, batch, ours, build_projector(TINY, SHAPES)


def test_pretraining_tree_converts_both_ways_strictly(models):
    *_, params, _, ours, _ = models
    back = module_to_flax(ours)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    # the MLM branch's language layers exist in a pretraining tree only: a
    # navigation model refuses them, and a model without mlm has none
    with pytest.raises(KeyError, match="unused flax params"):
        load_flax_params(GlocalTextPathNavCMT(TINY).bert, params["bert"])
    no_mlm = GlocalTextPathCMTPreTraining(TINY, ("sap", "masksem"))
    assert not any("lang_self_attn" in n for n, _ in no_mlm.named_parameters())
    # the object tasks build their heads once the config has object slots
    with pytest.raises(ValueError, match="object tokens"):
        GlocalTextPathCMTPreTraining(TINY, ("mlm", "og"))
    obj_cfg = dataclasses.replace(TINY, obj_feat_size=30, obj_prob_size=9)
    names = {n for n, _ in GlocalTextPathCMTPreTraining(obj_cfg, ("mlm", "og", "mrc"))
             .named_parameters()}
    assert {"og_head.fc2.weight", "obj_classifier.fc2.weight",
            "bert.img_embeddings.obj_linear.weight"} <= names


def _close(ours, ref, **tol):
    np.testing.assert_allclose(np.asarray(ours.detach().float().numpy()),
                               np.asarray(ref, np.float32), **(tol or TOL))


CASES = [("mlm", "cattn"), ("sap", "cattn")] + [
    (task, mode) for task in ("sem", "masksem") for mode in ("cattn", "sattn", "embed")
]


@pytest.mark.parametrize("task,mode", CASES)
def test_task_loss_and_metrics_match_jax(models, task, mode):
    model, projector, params, batch, ours, our_proj = models
    jax_model = JaxPreTraining(TINY, tasks=TASKS, sem_pred_token=mode)
    loss_ref, metrics_ref = jax_make_loss_fn(jax_model, projector)(
        params, batch, task, jax.random.key(0))
    ours.sem_pred_token = mode
    loss, metrics = make_loss_fn(ours, our_proj)(tt(batch), task)
    assert loss.dtype == torch.float32 and np.isfinite(float(loss_ref))
    _close(loss, loss_ref)
    assert set(metrics) == set(metrics_ref)
    for key, ref in metrics_ref.items():
        _close(metrics[key], ref)


@pytest.mark.parametrize("task", TASKS)
def test_gradients_match_jax(models, task):
    model, projector, params, batch, ours, our_proj = models
    ours.sem_pred_token = "cattn"
    grads_ref = jax.grad(lambda p: jax_make_loss_fn(model, projector)(
        p, batch, task, jax.random.key(0))[0])(params)
    grads_ref = flax_to_state_dict(jax.tree.map(np.asarray, grads_ref))
    ours.zero_grad(set_to_none=True)
    loss, _ = make_loss_fn(ours, our_proj)(tt(batch), task)
    loss.backward()
    named = dict(ours.named_parameters())
    assert set(named) == set(grads_ref)
    model_scale = max(float(g.abs().max()) for g in grads_ref.values())
    reached = 0
    for name, p in named.items():
        ref = grads_ref[name].numpy()
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        atol = 1e-5 * float(np.abs(ref).max()) + 1e-10 * model_scale
        np.testing.assert_allclose(got, ref, atol=atol, rtol=0, err_msg=name)
        reached += bool(np.abs(ref).max() > 0)
    assert reached > len(named) // 3  # the task's forward reaches its branch
