"""Parity of the port's pretraining validation (``PretrainTrainer.validate``,
``eval_step``, ``sem_predictions``; ``utils/mlabel.py``) with the JAX
package's trainer, and the rule that validation changes nothing in training.

Both trainers read the same numpy batches (``synthetic_pretrain_batch`` keyed
by the batch index, the raw BEV inputs included, so ``prepare_bev`` splats)
and hold the same parameters: JAX's initial ones plus N(0, 0.02) noise
(JAX's zero biases make many BEV cells' semantic scores tie exactly, and an
AUC's ranks would then rest on float32 rounding), carried over by
``convert.py``.

Tolerances, float32 throughout: per-task losses and metrics and the macro
AUC/F1 within 1e-4 abs (sums in another order); semantic scores within
1e-5 abs (sigmoids in (0, 1)), their labels and the selected cells equal.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_obj_pretrain import SHAPES as OBJ_SHAPES
from test_torch_obj_pretrain import TASKS as OBJ_TASKS
from test_torch_obj_pretrain import obj_batch, obj_model
from test_torch_pretrain import SHAPES, TINY, make_batch
from test_torch_pretrain_cli import _tiny_config
from vln_bevbert_tpu.configs import OptimConfig, PretrainConfig
from vln_bevbert_tpu.pretrain import PretrainTrainer as JaxTrainer
from vln_bevbert_tpu_torch import configs as port_configs
from vln_bevbert_tpu_torch.cli import pretrain as cli
from vln_bevbert_tpu_torch.convert import load_flax_params
from vln_bevbert_tpu_torch.pretrain.trainer import PretrainTrainer
from vln_bevbert_tpu_torch.utils import mlabel

TASKS = ("mlm", "sap", "masksem")
MODEL = dataclasses.replace(TINY, num_sem_classes=7)


class FakeLoader:
    """Batch ``step`` of ``make(step)``, for both packages' trainers."""

    global_batch_size = 3

    def __init__(self, tasks, make):
        self.tasks, self.make = tasks, make

    def build_batch(self, step, task=None):
        return task or self.tasks[step % len(self.tasks)], self.make(step)

    def __iter__(self):
        step = 0
        while True:
            yield self.build_batch(step)
            step += 1


def port_config(cfg) -> port_configs.PretrainConfig:
    return port_configs._update(port_configs.PretrainConfig(), dataclasses.asdict(cfg))


def trainers(tmp_path, model, shapes, tasks, make):
    """(JAX trainer, port trainer) on the same loaders and parameters."""
    cfg = PretrainConfig(model=model, shapes=shapes, tasks=tasks, mix_ratio=(1,) * len(tasks),
                         optim=OptimConfig(warmup_steps=2, num_train_steps=10),
                         train_batch_size=3, valid_steps=0)
    ref = JaxTrainer(cfg, FakeLoader(tasks, make), {"val": FakeLoader(tasks, make)},
                     output_dir=str(tmp_path / "jax"))
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.02, a.shape)).astype(np.float32),
        ref.state.params)
    ref.state = ref.state.replace(params=jax.tree.map(jax.numpy.asarray, params))
    ours = PretrainTrainer(port_config(cfg), FakeLoader(tasks, make), "cpu",
                           output_dir=str(tmp_path / "port"),
                           val_loaders={"val": FakeLoader(tasks, make)})
    load_flax_params(ours.model, params)
    return ref, ours


def batch_at(step):
    return make_batch(seed=step)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return trainers(tmp_path_factory.mktemp("validate"), MODEL, SHAPES, TASKS, batch_at)


def test_validate_matches_jax(pair):
    ref, ours = pair
    want, got = ref.validate(step=4, num_batches=2), ours.validate(step=4, num_batches=2)
    assert sorted(got) == sorted(want)
    assert {"val/sem/auc_macro", "val/sem/f1_macro", "val/masksem/loss", "val/mlm/mlm_acc",
            "val/sap/sap_facc"} <= set(got)
    for key, val in want.items():
        np.testing.assert_allclose(got[key], val, atol=1e-4, rtol=0, err_msg=key)
    assert 0.0 <= got["val/sem/auc_macro"] <= 1.0 and ours.model.training


def test_sem_predictions_match_jax(pair):
    ref, ours = pair
    batch = batch_at(3)
    for task in ("masksem", "sem"):
        scores_ref, labels_ref = ref.sem_predictions(batch, task)
        scores, labels = ours.sem_predictions(batch, task)
        assert scores.shape == scores_ref.shape and scores.shape[1] == MODEL.num_sem_classes
        assert len(scores) > 0
        np.testing.assert_array_equal(labels, labels_ref)
        np.testing.assert_allclose(scores, scores_ref, atol=1e-5, rtol=0, err_msg=task)
    assert ours.model.training


@pytest.mark.parametrize("task", TASKS)
def test_eval_step_matches_jax(pair, task):
    ref, ours = pair
    batch = batch_at(5)
    loss_ref, metrics_ref = ref.eval_step(batch, task)
    loss, metrics = ours.eval_step(batch, task)
    assert set(metrics) == set(metrics_ref) and ours.model.training
    np.testing.assert_allclose(float(loss), float(loss_ref), atol=1e-4, rtol=0)
    for key, val in metrics_ref.items():
        np.testing.assert_allclose(float(metrics[key]), float(val), atol=1e-4, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("task", ["mrc", "og"])
def test_object_eval_step_matches_jax(tmp_path, task):
    """mrc and og on the object batches of ``test_torch_obj_pretrain.py``."""
    model = obj_model("obj_linear")
    ref, ours = trainers(tmp_path, model, OBJ_SHAPES, OBJ_TASKS, lambda step: obj_batch(model))
    batch = obj_batch(model)
    loss_ref, metrics_ref = ref.eval_step(batch, task)
    loss, metrics = ours.eval_step(batch, task)
    assert set(metrics) == set(metrics_ref) and float(loss_ref) > 0
    np.testing.assert_allclose(float(loss), float(loss_ref), atol=1e-4, rtol=0)
    for key, val in metrics_ref.items():
        np.testing.assert_allclose(float(metrics[key]), float(val), atol=1e-4, rtol=0,
                                   err_msg=key)


def test_multilabel_report_matches_jax():
    """The port's copy of ``utils/mlabel.py``: equal reports, a class with one
    label value has no AUC (nan) and leaves the macro mean."""
    from vln_bevbert_tpu.utils import mlabel as jax_mlabel

    rng = np.random.default_rng(0)
    labels = rng.uniform(size=(60, 5)) < 0.3
    labels[:, 2] = False
    scores = np.round(labels * 0.5 + rng.uniform(size=(60, 5)) * 0.6, 1)  # with ties
    want = jax_mlabel.multilabel_report(scores, labels, class_names=list("abcde"))
    got = mlabel.multilabel_report(scores, labels, class_names=list("abcde"))
    assert sorted(got) == sorted(want) and np.isnan(got["auc/c"])
    for key, val in want.items():
        np.testing.assert_equal(got[key], val, err_msg=key)
    assert mlabel.MP3D_CATEGORIES == jax_mlabel.MP3D_CATEGORIES


def test_validation_changes_nothing_in_training(tmp_path):
    """The CLI's trainer at the tiny configuration, dropout on, 6 steps with
    validation every 2 steps and without: bit-equal losses, the dropout
    generator in the same state, the module back in training mode, and a
    checkpoint after each validation."""
    runs = {}
    for valid_steps in (2, 0):
        out = tmp_path / f"v{valid_steps}"
        trainer = cli.build(cli.parse_args([
            "--synthetic", "--device", "cpu", "--num_steps", "6", "--batch_size", "2",
            "--seed", "3", "--tasks", "mlm.1.sap.1.masksem.1",
            "--config", _tiny_config(tmp_path), "--output_dir", str(out)]))
        trainer.cfg.valid_steps = valid_steps
        block_fn, losses, validated = trainer.block_fn, [], []
        validate = trainer.validate

        def recorded(state, batch, task, length, stacked=False, block_fn=block_fn,
                     losses=losses):
            metrics = block_fn(state, batch, task, length, stacked)
            losses.append(metrics["loss"].clone())
            return metrics

        def counted(step, num_batches=8, validate=validate, validated=validated):
            validated.append(validate(step, num_batches=1))
            return validated[-1]

        trainer.block_fn, trainer.validate = recorded, counted
        trainer.train()
        gen = trainer.model.feat_dropout.generator
        runs[valid_steps] = (torch.stack(losses), gen.get_state(), validated, out)
        assert trainer.model.training
    (with_val, gen_val, validated, out), (without, gen_plain, none, _) = runs[2], runs[0]
    assert len(with_val) == 6 and torch.equal(with_val, without)
    assert torch.equal(gen_val, gen_plain)
    assert len(validated) == 3 and not none
    # one batch of B=2 may hold no masked cell with a label: the AUC is nan then
    assert all(np.isfinite(v) for r in validated for k, v in r.items() if "/sem/" not in k)
    assert {"val_unseen/mlm/loss", "val_unseen/sem/auc_macro"} <= set(validated[0])
    assert sorted(p.name for p in out.iterdir() if p.name.startswith("ckpt_")) == [
        "ckpt_2", "ckpt_4", "ckpt_6"]
