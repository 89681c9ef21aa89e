"""Data-parallel pretraining of the port (``parallel/distributed.py``,
``parallel/mesh.py``, the rank's dropout seeds, the loader's rank rows, the
global loss counts and the gradient all-reduce): two gloo ranks on the CPU
(``dp_ranks.py``, spawned once for the module) against the port's one
process at the global batch, and against the JAX package's 2-device mesh.

Tolerances. Ranks against one process, dropout on (the same masks: the
rank draws the global rows' seeds): losses and metrics at rtol 1e-5
(``sem_logits_mean``, a mean near 0, at atol 1e-4) and
parameters at atol 1e-5 after three clipped AdamW steps, as JAX's own
``test_dp_equals_single_device`` holds its mesh; the softmax's
shift-invariant biases (``SHIFT_INVARIANT``) have gradients of rounding
noise that Adam normalises to steps of ~lr either way, and are held to
that bound. Ranks against JAX's mesh, every dropout rate 0, one sap step
without warmup (one jitted mesh program, as JAX's own test
compiles): the tolerances of ``test_torch_train_step.py``'s full steps
(loss and grad_norm rtol 1e-5, parameters atol 4e-6). The loader's rows and
the dropout masks are bitwise; so are the ranks' parameters against each
other.
"""

import concurrent.futures
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dp_ranks
from test_torch_host import assert_same, config_file, dbs_of, feature_dicts, synthetic_world
from test_torch_pretrain import TINY, make_batch, tiny_cfg
from test_torch_pretrain_cli import _tiny_config as pretrain_config
from test_torch_finetune import REPLAY_CFG
from test_torch_train_step import SHIFT_INVARIANT
from vln_bevbert_tpu import configs as jax_configs
from vln_bevbert_tpu.data.loader import PretrainLoader as JaxLoader
from vln_bevbert_tpu.data.pathdata import TextPathData as JaxPathData
from vln_bevbert_tpu.data.synthetic import synthetic_replay_bundle
from vln_bevbert_tpu.parallel import make_mesh
from vln_bevbert_tpu.parallel.distributed import merge_results as jax_merge
from vln_bevbert_tpu.parallel.mesh import device_prefetch as jax_prefetch
from vln_bevbert_tpu.parallel.mesh import shard_batch as jax_shard_batch
from vln_bevbert_tpu.parallel.mesh import shard_replay_bundle as jax_shard_bundle
from vln_bevbert_tpu.models import GlocalTextPathCMTPreTraining as JaxPreTraining
from vln_bevbert_tpu.parallel.optim import make_optimizer
from vln_bevbert_tpu.parallel.train_step import TrainState as JaxTrainState
from vln_bevbert_tpu.parallel.train_step import build_projector as jax_build_projector
from vln_bevbert_tpu.parallel.train_step import make_pretrain_step as jax_make_step
from vln_bevbert_tpu_torch import configs
from vln_bevbert_tpu_torch.convert import flax_to_state_dict, module_to_flax
from vln_bevbert_tpu_torch.data.loader import PretrainLoader
from vln_bevbert_tpu_torch.data.pathdata import TextPathData
from vln_bevbert_tpu_torch.ops.dropout import Dropout, set_dropout_generator, step_rows
from vln_bevbert_tpu_torch.parallel import distributed
from vln_bevbert_tpu_torch.parallel.mesh import device_prefetch, shard_batch, shard_replay_bundle
from vln_bevbert_tpu_torch.parallel.train_step import init_pretrain_state, load_checkpoint
from vln_bevbert_tpu_torch.utils.rng import make_generator

WORLD, GLOBAL_B = 2, 4
TASKS = ("mlm", "sap", "masksem")
JAX_TASKS = ("sap",)
DROPOUT = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1, feat_dropout=0.4)
PREDS = [[{"instr_id": "x", "v": 1}], [{"instr_id": "x", "v": 2}, {"instr_id": "y"}]]


def to_port(jax_cfg):
    """The port's PretrainConfig with the fields of a JAX one."""
    return configs._update(configs.PretrainConfig(), dataclasses.asdict(jax_cfg))


def jax_cfg():
    """The pretraining test's configuration with one layer a stack (one
    small program to compile) and without warmup (the first step moves the
    parameters)."""
    return dataclasses.replace(
        tiny_cfg(), model=dataclasses.replace(TINY, num_l_layers=1, num_pano_layers=1,
                                              num_x_layers=1),
        optim=jax_configs.OptimConfig(warmup_steps=0, num_train_steps=10))


def jax_state():
    """(JAX model, projector, TrainState) of ``jax_cfg`` on the port's
    initial parameters plus N(0, 0.02) (no all-zero biases, see
    test_torch_train_step.py), built without JAX's jitted init."""
    cfg = jax_cfg()
    model, _, _ = init_pretrain_state(to_port(cfg), 0, "cpu")
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(rng.normal(0, 0.02, p.shape).astype(np.float32)))
    params = jax.tree.map(jnp.asarray, module_to_flax(model))
    tx = make_optimizer(cfg.optim, params_for_mask=params, include_clip=False)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=tx.init(params), tx=tx,
                          clip_norm=float(cfg.optim.grad_norm))
    jax_model = JaxPreTraining(cfg.model, tasks=tuple(cfg.tasks),
                               sem_pred_token=cfg.sem_pred_token)
    return jax_model, jax_build_projector(cfg.model, cfg.shapes), state


def cli_argv(tmp, batch_size):
    cfg = json.loads(open(pretrain_config(tmp)).read())
    cfg["valid_steps"] = 3  # one validation, with the semantic AUC/F1
    path = tmp / "dp.json"
    path.write_text(json.dumps(cfg))
    return ["--synthetic", "--device", "cpu", "--batch_size", str(batch_size), "--seed", "3",
            "--tasks", "mlm.1.sap.1.masksem.1", "--num_steps", "3", "--config", str(path)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results and the one process's, by scenario."""
    tmp = tmp_path_factory.mktemp("dp")
    batch = make_batch(GLOBAL_B, seed=5)
    *_, state = jax_state()
    drop_cfg = to_port(tiny_cfg())
    drop_cfg.model = dataclasses.replace(drop_cfg.model, **DROPOUT)
    specs = {
        "gather": (dp_ranks.gather, {"preds": PREDS}),
        "dropout_step": (dp_ranks.pretrain_steps, {
            "cfg": drop_cfg, "seed": 7, "batch": batch, "tasks": TASKS}),
        "jax_step": (dp_ranks.pretrain_steps, {
            "cfg": to_port(jax_cfg()), "seed": 0, "batch": batch, "tasks": JAX_TASKS,
            "params": flax_to_state_dict(jax.tree.map(np.asarray, state.params))}),
        "cli": (dp_ranks.cli, {"module": "pretrain", "argv": cli_argv(tmp, GLOBAL_B // WORLD),
                               "out": [str(tmp / "rank0"), str(tmp / "rank1")]}),
    }
    ranks = dp_ranks.Ranks(dp_ranks.chain, WORLD, str(tmp / "work"), list(specs.values()))
    # meanwhile: JAX's mesh (its compile in a thread) and the one process at
    # the global batch, on one thread (the tiny models gain nothing from more)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            jax_run = pool.submit(jax_mesh_steps, batch)
            one = {k: fn(0, 1, s) for k, (fn, s) in specs.items() if k != "cli"}
            one["cli"] = dp_ranks.cli(0, 1, {"module": "pretrain", "argv": cli_argv(tmp, GLOBAL_B),
                                             "out": [str(tmp / "one")]})
            jax_ref = jax_run.result()
    finally:
        torch.set_num_threads(threads)
    ranks = ranks.results()
    return {"tmp": tmp, "ranks": [dict(zip(specs, r["results"])) for r in ranks],
            "loaded": [r["jax_modules"] for r in ranks], "one": one,
            "jax": dict(jax_ref, start=specs["jax_step"][1]["params"])}


def jax_mesh_steps(batch):
    """``JAX_TASKS`` steps of JAX's pretraining step over a 2-device mesh
    from ``jax_state``: their metrics and the parameters after them."""
    model, projector, state = jax_state()
    mesh = make_mesh(jax.devices()[:WORLD])
    step = jax_make_step(model, projector, mesh)
    metrics = []
    with mesh:
        sharded = jax_shard_batch(mesh, batch)
        for task in JAX_TASKS:
            state, m = step(state, sharded, jax.random.key(0), task)
            metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "params": flax_to_state_dict(jax.tree.map(np.asarray, state.params))}


def test_ranks_load_no_jax(runs):
    assert runs["loaded"] == [[], []]


@pytest.mark.parametrize("lists", [PREDS, [[{"instr_id": "a"}], []], [[], [{"instr_id": "b"}]]])
def test_merge_results_matches_jax(lists):
    assert distributed.merge_results(lists) == jax_merge(lists)
    assert distributed.all_gather_objects({"a": 1}) == [{"a": 1}]  # one process
    assert distributed.is_primary() and distributed.world_size() == 1


def test_all_gather_objects_over_two_ranks_merges_as_jax(runs):
    for rank, res in enumerate(runs["ranks"]):
        got = res["gather"]
        assert [g["rank"] for g in got["gathered"]] == [0, 1]
        assert [g["preds"] for g in got["gathered"]] == PREDS
        assert got["merged"] == jax_merge(PREDS) == runs["one"]["gather"]["merged"]
        assert got["merged"][0]["v"] == 1


def test_shards_match_the_jax_meshs_device_shards():
    """A rank's rows of a batch and of a replay bundle (step-leading arrays
    split on axis 1, text on axis 0, rng entries whole) are the device
    shards of JAX's mesh."""
    mesh = make_mesh(jax.devices()[:WORLD])
    batch = make_batch(GLOBAL_B, seed=2)
    rb = synthetic_replay_bundle(np.random.default_rng(3), REPLAY_CFG, GLOBAL_B)
    rb["rng"] = np.arange(rb["targets"].shape[0])  # kept whole
    for ours, theirs in ((shard_batch, jax_shard_batch),
                         (shard_replay_bundle, jax_shard_bundle)):
        data = batch if ours is shard_batch else rb
        sharded = theirs(mesh, data)
        for rank in range(WORLD):
            mine = ours(data, rank, WORLD)
            assert mine.keys() == data.keys()
            for key, arr in sharded.items():
                shard = next(s for s in arr.addressable_shards
                             if s.device == mesh.devices[rank])
                np.testing.assert_array_equal(mine[key], np.asarray(shard.data), err_msg=key)


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_device_prefetch_yields_what_jax_yields(depth):
    """(tag, batch) items in order, every batch uploaded, however deep the
    queue and however few the items."""
    items = [(f"task{i}", make_batch(2, seed=i)) for i in range(3)]
    got = list(device_prefetch(iter(items), "cpu", depth=depth))
    want = list(jax_prefetch(iter(items), depth=depth))
    assert [t for t, _ in got] == [t for t, _ in want] == [t for t, _ in items]
    for (_, mine), (_, theirs) in zip(got, want):
        assert mine.keys() == theirs.keys()
        for key, val in theirs.items():
            assert isinstance(mine[key], torch.Tensor), key
            np.testing.assert_array_equal(mine[key].numpy(), np.asarray(val), err_msg=key)


def test_loader_rank_batches_concatenate_to_the_global_batch(tmp_path):
    """Rank r's batches at n_devices=2 are rows [r b, (r + 1) b) of the one
    process's global batch, which is the JAX loader's, bit for bit."""
    loaders = {}
    for pkg, cfg_mod, path_cls in (("vln_bevbert_tpu", jax_configs, JaxPathData),
                                   ("vln_bevbert_tpu_torch", configs, TextPathData)):
        cfg = cfg_mod.load_config(cfg_mod.PretrainConfig, config_file(tmp_path, pretrain_config),
                                  train_batch_size=2, num_workers=0)
        graphs, cands, annos = synthetic_world(pkg, tmp_path, n_items=16)
        dicts = feature_dicts(graphs, feat=cfg.model.image_feat_size,
                              grid=cfg.model.bev_grid_feat_size, hw=cfg.shapes.grid_hw,
                              views=cfg.shapes.num_views)
        db = path_cls(annos, graphs, cands,
                      **dbs_of(pkg, dicts, ("view_db", "grid_db", "depth_db", "sem_db")),
                      image_feat_size=cfg.model.image_feat_size,
                      max_txt_len=cfg.shapes.max_txt_len, bev_dim=cfg.model.bev_dim,
                      bev_res=cfg.model.bev_res, num_views=cfg.shapes.num_views)
        if pkg.endswith("torch"):
            loaders["ranks"] = [PretrainLoader(db, cfg, seed=11, prefetch=0, n_devices=WORLD,
                                               dp_rank=r) for r in range(WORLD)]
            loaders["one"] = PretrainLoader(db, cfg, seed=11, prefetch=0, n_devices=WORLD)
        else:
            loaders["jax"] = JaxLoader(db, cfg, seed=11, prefetch=0, n_devices=WORLD)
    assert loaders["one"].global_batch_size == WORLD * 2
    for step in range(4):
        task, ref = loaders["jax"].build_batch(step)
        assert_same((task, ref), loaders["one"].build_batch(step), f"step {step}")
        parts = [ld.build_batch(step) for ld in loaders["ranks"]]
        assert {t for t, _ in parts} == {task}
        for key, val in ref.items():
            assert all(len(b[key]) == 2 for _, b in parts)
            np.testing.assert_array_equal(np.concatenate([b[key] for _, b in parts]), val,
                                          err_msg=f"step {step} {key}")
    # iteration hands out the same rows
    it = iter(loaders["ranks"][1])
    task, got = next(it)
    it.close()
    assert_same(got, loaders["ranks"][1].build_batch(0)[1])


@pytest.mark.parametrize("layout", ["batch", "steps", "rank1"])
def test_dropout_ranks_draw_the_one_process_masks(layout):
    """Two ranks' Dropout outputs, joined, equal one process's on the global
    rows bitwise, and every generator ends in the same state."""
    T, B = 3, 4
    shape = {"batch": (B, 5, 6), "steps": (T, B, 5, 6), "rank1": (B,)}[layout]
    x = torch.from_numpy(np.random.default_rng(0).normal(size=shape).astype(np.float32)) + 3

    def apply(rank, world, rows):
        drop = Dropout(0.3).train()
        gen = make_generator(9)
        set_dropout_generator(drop, gen, rank, world)
        if layout == "steps":
            with step_rows(T):
                y = drop(rows.reshape(-1, *rows.shape[2:]))
            return y.reshape(T, -1, *rows.shape[2:]), gen.get_state()
        return drop(rows), gen.get_state()

    one, one_state = apply(0, 1, x)
    b = B // WORLD
    axis = 1 if layout == "steps" else 0
    for rank in range(WORLD):
        rows = x.narrow(axis, rank * b, b)
        got, state = apply(rank, WORLD, rows)
        assert torch.equal(got, one.narrow(axis, rank * b, b)), rank
        assert torch.equal(state, one_state)
    kept = (one != 0).float().mean()
    assert 0.4 < float(kept) < 0.95


def _atol(key, atol):
    """``sem_logits_mean`` is a mean of logits of either sign near 0: its
    float32 sums in another order (other rows a process, other threads)
    differ by ~1e-5 of the logits' O(1) scale, far more than of the mean."""
    return 1e-4 if key.endswith("sem_logits_mean") else atol


def _close(got, ref, name, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=name)


def test_ranks_hold_equal_parameters(runs):
    for key in ("dropout_step", "jax_step"):
        p0, p1 = (r[key]["params"] for r in runs["ranks"])
        assert all(torch.equal(p0[n], p1[n]) for n in p0), key


def test_pretrain_steps_with_dropout_equal_one_process(runs):
    ranks, one = runs["ranks"][0]["dropout_step"], runs["one"]["dropout_step"]
    for task, got, ref in zip(TASKS, ranks["metrics"], one["metrics"]):
        assert got.keys() == ref.keys()
        for key in ref:
            _close(got[key], ref[key], f"{task} {key}", rtol=1e-5)
    lr_sum = 1.5 * tiny_cfg().optim.learning_rate  # warmup of 2: lr 0, lr / 2, lr
    start = dict(init_pretrain_state(to_port(tiny_cfg()), 7, "cpu")[0].named_parameters())
    moved = 0
    for name, ref in one["params"].items():
        got = ranks["params"][name]
        atol = 6 * lr_sum if name in SHIFT_INVARIANT else 1e-5
        _close(got, ref, name, atol=atol)
        moved += not torch.equal(ref, start[name].detach())
    assert moved > len(one["params"]) // 2


def test_pretrain_steps_over_two_ranks_match_the_jax_mesh(runs):
    ranks, ref = runs["ranks"][0]["jax_step"], runs["jax"]
    for task, got, want in zip(JAX_TASKS, ranks["metrics"], ref["metrics"]):
        for key in ("loss", "grad_norm"):
            _close(got[key], want[key], f"{task} {key}", rtol=1e-5)
    start = runs["jax"]["start"]
    params_ref = ref["params"]
    lr_sum = len(JAX_TASKS) * jax_cfg().optim.learning_rate
    moved = 0
    for name, ref in params_ref.items():
        moved += not torch.equal(ref, start[name])
        atol = 6 * lr_sum if name in SHIFT_INVARIANT else 4e-6
        _close(ranks["params"][name], ref, name, atol=atol)
    assert moved > len(params_ref) // 2


def test_cli_pretrain_over_two_ranks_equals_one_process(runs):
    tmp = runs["tmp"]
    ranks = [r["cli"]["res"] for r in runs["ranks"]]
    one = runs["one"]["cli"]["res"]
    assert ranks[0] == ranks[1] and ranks[0].keys() == one.keys()
    for key in one:
        _close(ranks[0][key], one[key], key, rtol=1e-5, atol=_atol(key, 1e-7))
    # only rank 0 writes; it writes what the one process writes
    assert not (tmp / "rank1").exists()
    assert sorted(os.listdir(tmp / "rank0")) == sorted(os.listdir(tmp / "one")) == [
        "ckpt_3", "metrics.jsonl"]
    got = load_checkpoint(str(tmp / "rank0" / "ckpt_3"), "cpu")
    ref = load_checkpoint(str(tmp / "one" / "ckpt_3"), "cpu")
    assert got["step"] == ref["step"] == 3
    for name, val in ref["params"].items():
        atol = 1e-4 if name in SHIFT_INVARIANT else 1e-5
        _close(got["params"][name], val, name, atol=atol)
    logged = [json.loads(line) for line in open(tmp / "rank0" / "metrics.jsonl")]
    logged_one = [json.loads(line) for line in open(tmp / "one" / "metrics.jsonl")]
    val = [r for r in logged if "val_unseen/sem/auc_macro" in r]
    val_one = [r for r in logged_one if "val_unseen/sem/auc_macro" in r]
    assert len(val) == len(val_one) == 1
    for key, ref in val_one[0].items():
        if key.startswith("val_unseen/"):
            _close(val[0][key], ref, key, rtol=1e-5, atol=_atol(key, 1e-6))
