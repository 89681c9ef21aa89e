"""The port's checkpoints and fine-tuning CLI end to end on the CPU, at a tiny
configuration, each run in a process that must not load JAX:

pretraining writes ``ckpt_<step>`` (parameters, optimizer state, step) that
``restore`` reloads bit for bit and ``auto_resume`` finds; fine-tuning
starts from it (every navigation parameter transfers), trains DAgger
iterations with evaluations, writes ``ckpt_best``/``ckpt_latest``, the
IL-loss log and the prediction dumps; ``--test --pretrain_ckpt ckpt_latest``
evaluates to the same predictions; ``--data_root`` training reads an HDF5
world.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_nav import SHAPES as NAV_SHAPES
from test_torch_pretrain_cli import _tiny_config as pretrain_config
from vln_bevbert_tpu.data.loader import make_synthetic_annotations
from vln_bevbert_tpu.data.nav_graph import load_nav_graphs, write_synthetic_connectivity
from vln_bevbert_tpu_torch.cli import pretrain
from vln_bevbert_tpu_torch.parallel.train_step import load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax")


def run_main(module: str, argv: list) -> dict:
    """``vln_bevbert_tpu_torch.cli.<module>.main(argv)`` in a fresh process;
    returns its result and the JAX modules it loaded."""
    code = (
        "import json, sys\n"
        f"from vln_bevbert_tpu_torch.cli import {module}\n"
        f"res = {module}.main(sys.argv[1:])\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {JAX_MODULES!r})\n"
        "print(json.dumps({'bad': bad, 'res': res}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, *argv], capture_output=True,
                          text=True, timeout=400, cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    return out["res"]


def finetune_config(tmp_path) -> str:
    """The pretraining test's model at the navigation test's shapes."""
    with open(pretrain_config(tmp_path)) as f:
        model = json.load(f)["model"]
    path = tmp_path / "finetune.json"
    path.write_text(json.dumps({"model": model, "shapes": NAV_SHAPES.__dict__,
                                "max_action_len": 4, "batch_size": 2}))
    return str(path)


def logged(out_dir) -> list:
    return [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """(tmp dir, args of a 2-step CPU pretraining run, its output dir)."""
    tmp = tmp_path_factory.mktemp("pretrain")
    out = tmp / "out"
    argv = ["--synthetic", "--device", "cpu", "--batch_size", "2", "--seed", "3",
            "--tasks", "mlm.1.sap.1.masksem.1", "--config", pretrain_config(tmp),
            "--output_dir", str(out)]
    meters = run_main("pretrain", argv + ["--num_steps", "2"])
    assert meters and all(np.isfinite(v) for v in meters.values())
    return tmp, argv, out


def test_pretrain_checkpoint_restores_bitwise_and_resumes(pretrained):
    tmp, argv, out = pretrained
    path = out / "ckpt_2"
    assert sorted(os.listdir(out)) == ["ckpt_2", "metrics.jsonl"]
    ckpt = load_checkpoint(str(path), "cpu")
    assert ckpt["step"] == ckpt["opt_state"]["count"] == 2

    trainer = pretrain.build(pretrain.parse_args(argv + ["--resume", str(path)]))
    state = trainer.state
    assert state.step == 2
    for i, (name, p) in enumerate(trainer.model.named_parameters()):
        assert torch.equal(p.detach(), ckpt["params"][name]), name
        assert torch.equal(state.tx.mu[i], ckpt["opt_state"]["mu"][name]), name
        assert torch.equal(state.tx.nu[i], ckpt["opt_state"]["nu"][name]), name
    assert state.tx.mu[0].dtype == torch.bfloat16
    assert any(float(m.abs().max()) > 0 for m in state.tx.mu)

    trainer.train(3)  # resumes at step 2
    assert state.step == 3
    newer = trainer.save(state.step)
    fresh = pretrain.build(pretrain.parse_args(argv + ["--num_steps", "3"]))
    assert fresh.state.step == 0
    assert fresh.auto_resume() == newer and fresh.state.step == 3
    for a, b in zip(fresh.model.parameters(), trainer.model.parameters()):
        assert torch.equal(a, b)
    os.remove(newer)


def test_finetune_from_pretrained_then_test_from_checkpoint(pretrained, tmp_path):
    tmp, _, pre_out = pretrained
    out = tmp_path / "ft"
    config = finetune_config(tmp_path)
    res = run_main("finetune", [
        "--synthetic", "--device", "cpu", "--pretrain_ckpt", str(pre_out / "ckpt_2"),
        "--iters", "2", "--log_every", "1", "--config", config, "--output_dir", str(out)])
    for key in ("sr", "spl", "nDTW"):
        assert 0.0 <= res["val_unseen"][key] <= 100.0
    files = set(os.listdir(out))
    assert {"ckpt_best", "ckpt_latest", "preds_val_unseen_1.json",
            "preds_val_unseen_2.json"} <= files
    records = logged(out)
    transfer = next(r for r in records if "pretrain/transferred" in r)
    assert transfer["pretrain/transferred"] == transfer["pretrain/params"] > 100
    losses = [r for r in records if "train/IL_loss" in r]
    assert [r["step"] for r in losses] == [1, 2]
    assert all(np.isfinite(r["train/IL_loss"]) and r["train/IL_loss"] > 0 for r in losses)
    assert any("best/score" in r for r in records)
    latest = load_checkpoint(str(out / "ckpt_latest"), "cpu")
    assert latest["opt_state"]["count"] == 4  # 2 DAgger iterations, 2 updates each

    test_out = tmp_path / "test"
    again = run_main("finetune", [
        "--synthetic", "--device", "cpu", "--test", "--pretrain_ckpt", str(out / "ckpt_latest"),
        "--config", config, "--output_dir", str(test_out)])
    assert again["val_unseen"] == res["val_unseen"]

    def by_id(path):  # an eval's order follows the env's shuffles before it
        return {p["instr_id"]: p["trajectory"] for p in json.loads(path.read_text())}

    final = by_id(out / "preds_val_unseen_2.json")
    assert by_id(test_out / "preds_val_unseen_0.json") == final and len(final) == 16


def test_finetune_trains_on_an_hdf5_world(tmp_path):
    """``--data_root``: training and evaluation read HDF5 stores without JAX."""
    from vln_bevbert_tpu.data.feature_db import write_synthetic_features
    from test_torch_nav import TINY, _tiny_config

    root = tmp_path / "data"
    rng = np.random.default_rng(0)
    write_synthetic_connectivity(str(root / "connectivity"), rng, n_scans=1, n_nodes=9)
    graphs = load_nav_graphs(str(root / "connectivity"))
    write_synthetic_features(
        str(root), rng, {s: g.node_ids for s, g in graphs.items()}, pack=False,
        image_feat_size=TINY.image_feat_size, grid_feat_size=TINY.bev_grid_feat_size,
        grid_hw=NAV_SHAPES.grid_hw, num_views=NAV_SHAPES.num_views,
    )
    for split in ("train", "val_unseen"):
        items = make_synthetic_annotations(graphs, rng, n_items=4, min_len=2, max_len=4)
        (root / f"R2R_{split}_enc.json").write_text(json.dumps([
            {"path_id": i, "scan": it["scan"], "path": it["path"],
             "heading": it["heading"], "instructions": ["synthetic instruction"],
             "instr_encodings": [[int(t) for t in it["instr_encoding"]]]}
            for i, it in enumerate(items)
        ]))
    out = tmp_path / "out"
    res = run_main("finetune", [
        "--data_root", str(root), "--device", "cpu", "--val_splits", "val_unseen",
        "--batch_size", "2", "--iters", "1", "--log_every", "1", "--feedback", "sample",
        "--config", _tiny_config(tmp_path), "--output_dir", str(out)])
    assert 0.0 <= res["val_unseen"]["sr"] <= 100.0
    losses = [r["train/IL_loss"] for r in logged(out) if "train/IL_loss" in r]
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert {"ckpt_best", "ckpt_latest", "preds_val_unseen_1.json"} <= set(os.listdir(out))


def test_profile_finetune_times_a_rollout_and_an_update(tmp_path):
    """``cli.profile_finetune`` on the CPU at the tiny configuration: both
    parts run and are timed; device figures stay unmeasured off the card."""
    from vln_bevbert_tpu_torch.cli import profile_finetune

    out = profile_finetune.main(["--device", "cpu", "--repeats", "1",
                                 "--config", finetune_config(tmp_path),
                                 "--output_dir", str(tmp_path / "out")])
    assert out["card"] == "no card" and out["batch_size"] == 2
    assert 1 <= out["update"]["replay_steps"] <= 4
    assert len(out["rollout"]["steps_per_run"]) == 2
    for part in ("rollout", "update"):
        assert out[part]["host_ms"] > 0 and out[part]["traced_ms"] > 0
        assert out[part]["device_busy_share"] is None and out[part]["peak_MiB"] is None
