"""Data-parallel DAgger fine-tuning of the port (``nav/agent.py`` with a
rank and a world, ``cli/finetune.py`` under a process group): two gloo
ranks on the CPU (``dp_ranks.py``, spawned once for the module) against
the port's one process at the global batch, and the replay update against
the JAX package's 2-device mesh.

Tolerances, float32: the replay's loss at rtol 1e-5 and its gradients at
rtol 1e-4 atol 1e-6, as JAX's ``test_finetune_replay_dp_equals_single_device``
holds its mesh, against JAX (every dropout rate 0, with and without object
slots) and against one process (dropout on: the ranks draw the global rows'
seeds, so the masks are the one process's); the parameters after the
AdamW update at atol 1e-5, but those whose gradient is rounding noise
(the softmax's shift-invariant biases), which Adam moves by ~lr either way.
The sampled and exploring actions equal the one process's; the CLI's
losses at rtol 1e-5, its checkpoint as the update's parameters, its merged
predictions equal and their metrics at rtol 1e-12 (means over the rows in
another order).
"""

import concurrent.futures
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import dp_ranks
from test_torch_finetune import FT_SHIFT_INVARIANT, REPLAY_CFG, padded_bundle
from test_torch_finetune_cli import finetune_config
from test_torch_obj_nav import OBJ_SHIFT_INVARIANT
from test_torch_obj_nav import REPLAY_CFG as OBJ_REPLAY_CFG
from vln_bevbert_tpu.nav.agent import GMapNavAgent as JaxAgent
from vln_bevbert_tpu.nav.agent import _EnvStub as JaxEnvStub
from vln_bevbert_tpu.parallel import make_mesh
from vln_bevbert_tpu.parallel.mesh import replicate_tree
from vln_bevbert_tpu.parallel.mesh import shard_replay_bundle as jax_shard_bundle
from vln_bevbert_tpu_torch import configs
from vln_bevbert_tpu_torch.convert import flax_to_state_dict, module_to_flax
from vln_bevbert_tpu_torch.nav.agent import IGNORE_ID, make_replay_agent
from vln_bevbert_tpu_torch.parallel.train_step import load_checkpoint

WORLD, GLOBAL_B = 2, 4
DROPOUT = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1, feat_dropout=0.4)


def to_port(jax_cfg):
    """The port's FinetuneConfig with the fields of a JAX one."""
    return configs._update(configs.FinetuneConfig(), dataclasses.asdict(jax_cfg))


def bundle(cfg, seed):
    """A global-batch replay bundle of ``cfg`` whose last two steps are
    padding (``test_torch_finetune.padded_bundle``); with objects the
    object targets pad too."""
    rb = padded_bundle(dataclasses.replace(cfg, batch_size=GLOBAL_B), seed=seed)
    if "obj_targets" in rb:
        rb["obj_targets"][-2:] = IGNORE_ID
    return rb


def perturbed_params(cfg):
    """The port's initial parameters of ``cfg`` plus N(0, 0.02) (no all-zero
    biases), as a state dict."""
    agent = make_replay_agent(to_port(cfg), GLOBAL_B, device="cpu")
    rng = np.random.default_rng(1)
    return {n: p.detach() + torch.from_numpy(rng.normal(0, 0.02, p.shape).astype(np.float32))
            for n, p in agent.model.named_parameters()}


def jax_loss_grad(cfg, rb, params):
    """JAX's replay loss and gradients over a 2-device mesh (its agent's
    ``loss_grad`` on a sharded bundle, parameters replicated)."""
    mesh = make_mesh(jax.devices()[:WORLD])
    agent = JaxAgent(dataclasses.replace(cfg, batch_size=GLOBAL_B), JaxEnvStub(GLOBAL_B),
                     mesh=mesh)
    model = make_replay_agent(to_port(cfg), GLOBAL_B, device="cpu").model
    model.load_state_dict(params)
    flax = jax.tree.map(jax.numpy.asarray, module_to_flax(model))
    T = rb["targets"].shape[0]
    keys = jax.random.split(jax.random.key(7), T + 2)
    rb = dict(rb, rng=keys[:T], rng_lang=keys[T], rng_pano=keys[T + 1])
    loss, grads = agent._fn("loss_grad")(replicate_tree(mesh, flax), jax_shard_bundle(mesh, rb))
    return float(loss), flax_to_state_dict(jax.tree.map(np.asarray, grads))


def cli_argv(tmp, batch_size):
    return ["--synthetic", "--device", "cpu", "--config", finetune_config(tmp), "--iters", "1",
            "--feedback", "teacher", "--batch_size", str(batch_size)]


def pick_spec():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(GLOBAL_B, 6)).astype(np.float32)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    masks = rng.random((GLOBAL_B, 6)) < 0.7
    masks[0] = False  # a row with nothing to explore
    return {"cfg": to_port(dataclasses.replace(REPLAY_CFG, expl_max_ratio=0.3)), "seed": 5,
            "logits": logits, "probs": probs, "masks": masks,
            "visited": rng.random((GLOBAL_B, 6)) < 0.3}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_ft")
    drop_cfg = dataclasses.replace(REPLAY_CFG, model=dataclasses.replace(REPLAY_CFG.model,
                                                                          **DROPOUT))
    cases = {"plain": (REPLAY_CFG, 11), "objects": (OBJ_REPLAY_CFG, 12),
             "dropout": (drop_cfg, 13)}
    inputs = {k: (cfg, bundle(cfg, seed), perturbed_params(cfg))
              for k, (cfg, seed) in cases.items()}
    specs = {k: (dp_ranks.replay, {"cfg": to_port(cfg), "rb": rb, "params": params, "seed": 3})
             for k, (cfg, rb, params) in inputs.items()}
    specs["pick"] = (dp_ranks.pick, pick_spec())
    specs["cli"] = (dp_ranks.cli, {"module": "finetune", "argv": cli_argv(tmp, GLOBAL_B // WORLD),
                                   "out": [str(tmp / "rank0"), str(tmp / "rank1")]})
    ranks = dp_ranks.Ranks(dp_ranks.chain, WORLD, str(tmp / "work"), list(specs.values()))
    # meanwhile: JAX's mesh (its compiles in threads) and the one process at
    # the global batch, on one thread (the tiny models gain nothing from more)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            jax_ref = {k: pool.submit(jax_loss_grad, *inputs[k]) for k in ("plain", "objects")}
            one = {k: fn(0, 1, s) for k, (fn, s) in specs.items() if k != "cli"}
            one["cli"] = dp_ranks.cli(0, 1, {"module": "finetune", "argv": cli_argv(tmp, GLOBAL_B),
                                             "out": [str(tmp / "one")]})
            jax_ref = {k: f.result() for k, f in jax_ref.items()}
    finally:
        torch.set_num_threads(threads)
    ranks = ranks.results()
    return {"tmp": tmp, "ranks": [dict(zip(specs, r["results"])) for r in ranks],
            "loaded": [r["jax_modules"] for r in ranks], "one": one, "jax": jax_ref}


def test_ranks_load_no_jax(runs):
    assert runs["loaded"] == [[], []]


def _grads_close(got, ref, label):
    for name, want in ref.items():
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(want), rtol=1e-4,
                                   atol=1e-6, err_msg=f"{label} {name}")


@pytest.mark.parametrize("case", ["plain", "objects", "dropout"])
def test_replay_over_two_ranks_equals_one_process(runs, case):
    ranks, one = [r[case] for r in runs["ranks"]], runs["one"][case]
    np.testing.assert_allclose(ranks[0]["loss"], one["loss"], rtol=1e-5)
    assert ranks[0]["loss"] == ranks[1]["loss"] > 0
    _grads_close(ranks[0]["grads"], one["grads"], case)
    assert all(torch.equal(ranks[0]["grads"][n], ranks[1]["grads"][n]) for n in one["grads"])
    np.testing.assert_allclose(ranks[0]["update_loss"], one["update_loss"], rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["grad_norm"], one["grad_norm"], rtol=1e-5)
    noise = OBJ_SHIFT_INVARIANT if case == "objects" else FT_SHIFT_INVARIANT
    lr = REPLAY_CFG.learning_rate
    for name, want in one["params"].items():
        assert torch.equal(ranks[0]["params"][name], ranks[1]["params"][name]), name
        np.testing.assert_allclose(ranks[0]["params"][name], want, rtol=0,
                                   atol=3 * lr if name in noise else 1e-5, err_msg=name)


@pytest.mark.parametrize("case", ["plain", "objects"])
def test_replay_over_two_ranks_matches_the_jax_mesh(runs, case):
    loss, grads = runs["jax"][case]
    got = runs["ranks"][0][case]
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    noise = OBJ_SHIFT_INVARIANT if case == "objects" else FT_SHIFT_INVARIANT
    scale = max(float(g.abs().max()) for g in grads.values())
    for name, want in grads.items():
        atol = 1e-7 * scale if name in noise else 1e-6  # rounding noise, as in test_torch_finetune
        np.testing.assert_allclose(np.asarray(got["grads"][name]), np.asarray(want), rtol=1e-4,
                                   atol=atol, err_msg=f"{case} {name}")


def test_sampled_and_exploring_actions_equal_one_process(runs):
    one = runs["one"]["pick"]
    got = [r["pick"] for r in runs["ranks"]]
    for fb in ("sample", "expl_sample", "argmax"):
        np.testing.assert_array_equal(np.concatenate([g[fb] for g in got]), one[fb], err_msg=fb)
    for g in got:
        assert g["rng"] == one["rng"]  # every rank drew what the one process drew
        np.testing.assert_allclose(g["entropy"], one["entropy"], rtol=1e-12)


def test_cli_finetune_over_two_ranks_equals_one_process(runs):
    tmp = runs["tmp"]
    ranks = [r["cli"]["res"] for r in runs["ranks"]]
    one = runs["one"]["cli"]["res"]
    # the merged predictions' metrics; means over another order of the rows
    assert ranks[0] == ranks[1] and ranks[0].keys() == one.keys() == {"val_unseen"}
    assert ranks[0]["val_unseen"].keys() == one["val_unseen"].keys()
    for key, want in one["val_unseen"].items():
        np.testing.assert_allclose(ranks[0]["val_unseen"][key], want, rtol=1e-12, err_msg=key)
    assert not (tmp / "rank1").exists()
    files = sorted(os.listdir(tmp / "one"))
    assert sorted(os.listdir(tmp / "rank0")) == files == [
        "ckpt_best", "ckpt_latest", "metrics.jsonl", "preds_val_unseen_1.json"]
    logged = [json.loads(line) for line in open(tmp / "rank0" / "metrics.jsonl")]
    logged_one = [json.loads(line) for line in open(tmp / "one" / "metrics.jsonl")]
    loss = [r["train/IL_loss"] for r in logged if "train/IL_loss" in r]
    loss_one = [r["train/IL_loss"] for r in logged_one if "train/IL_loss" in r]
    assert len(loss) == 1 and loss[0] > 0
    np.testing.assert_allclose(loss, loss_one, rtol=1e-5)
    preds = {p["instr_id"]: p for p in json.load(open(tmp / "rank0" / "preds_val_unseen_1.json"))}
    preds_one = {p["instr_id"]: p for p in json.load(open(tmp / "one" / "preds_val_unseen_1.json"))}
    assert preds == preds_one and len(preds) == 16
    got = load_checkpoint(str(tmp / "rank0" / "ckpt_latest"), "cpu")["params"]
    ref = load_checkpoint(str(tmp / "one" / "ckpt_latest"), "cpu")["params"]
    for name, want in ref.items():
        atol = 3e-5 if name in FT_SHIFT_INVARIANT else 1e-5  # lr 1e-5 by default
        np.testing.assert_allclose(got[name], want, rtol=0, atol=atol, err_msg=name)
