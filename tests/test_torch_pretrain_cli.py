"""The port's pretraining slice end to end on the CPU:
``vln_bevbert_tpu_torch.cli.pretrain --synthetic`` at a tiny configuration,
dropout on, through the MetaLoader schedule of every task, in a process that
never imports JAX."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_pretrain import SHAPES
from vln_bevbert_tpu.data.loader import MetaLoader
from vln_bevbert_tpu_torch.cli import pretrain as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASKS, STEPS, SEED = ("mlm", "sap", "masksem"), 9, 3


def _tiny_config(tmp_path) -> str:
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps({
        "model": {"vocab_size": 30522, "hidden_size": 64, "num_attention_heads": 2,
                  "intermediate_size": 128, "num_l_layers": 2, "num_pano_layers": 1,
                  "num_x_layers": 2, "image_feat_size": 24, "bev_grid_feat_size": 20,
                  "bev_dim": 5, "num_sem_classes": 7, "dtype": "float32"},
        "shapes": {**SHAPES.__dict__, "max_txt_len": 64},
        "optim": {"warmup_steps": 4},
        "task_block_size": 1, "log_steps": 1,
    }))
    return str(path)


def test_cli_trains_every_task_on_cpu_without_jax(tmp_path):
    schedule = [MetaLoader(TASKS, (1, 1, 1), SEED).task_for_step(s) for s in range(STEPS)]
    assert all(schedule.count(t) >= 2 for t in TASKS)
    code = (
        "import json, sys\n"
        "from vln_bevbert_tpu_torch.cli import pretrain\n"
        "trainer = pretrain.build(pretrain.parse_args(sys.argv[1:]))\n"
        "meters = trainer.train()\n"
        "rates = sorted({m.rate for m in trainer.model.modules() if hasattr(m, 'rate')})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('vln_bevbert_tpu', 'jax', 'jaxlib', 'flax', 'optax', 'orbax'))\n"
        "print(json.dumps({'bad': bad, 'meters': meters, 'step': trainer.state.step,\n"
        "                  'training': trainer.model.training, 'rates': rates}))\n"
    )
    out_dir = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-c", code, "--synthetic", "--device", "cpu",
         "--num_steps", str(STEPS), "--batch_size", "2", "--seed", str(SEED),
         "--tasks", "mlm.1.sap.1.masksem.1", "--config", _tiny_config(tmp_path),
         "--output_dir", str(out_dir)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert out["step"] == STEPS and out["training"] and out["rates"] == [0.1, 0.4]
    for task in TASKS:
        for key in ("loss", "grad_norm"):
            assert np.isfinite(out["meters"][f"{task}/{key}"]), (task, key)
    logged = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in logged] == list(range(1, STEPS + 1))
    lrs = [r["train/lr"] for r in logged]
    assert lrs[0] == 0.0 and lrs[1] < lrs[2] < lrs[3] < lrs[4]   # warmup
    assert lrs[5] < lrs[4]                                       # then decay


def test_cli_cuda_device_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.build(cli.parse_args(["--synthetic", "--device", "cuda",
                                  "--output_dir", str(tmp_path)]))
    with pytest.raises(NotImplementedError, match="--init_bert"):
        cli.build(cli.parse_args(["--synthetic", "--device", "cpu", "--init_bert",
                                  "--output_dir", str(tmp_path)]))


def test_profile_train_ab_runs_both_dropouts_through_the_trainer(tmp_path):
    """``cli.profile_train --ab`` on the CPU at the tiny configuration: four
    arms (kernel, eager, eager, kernel) over the same schedule, each timed per
    task; the eager arms leave ``Dropout.forward`` as it was."""
    from vln_bevbert_tpu_torch.cli import profile_train
    from vln_bevbert_tpu_torch.ops.dropout import Dropout

    forward = Dropout.forward
    out = profile_train.main([
        "--ab", "--ab_steps", str(STEPS), "--device", "cpu", "--batch_size", "2",
        "--seed", str(SEED), "--tasks", "mlm.1.sap.1.masksem.1",
        "--config", _tiny_config(tmp_path), "--output_dir", str(tmp_path / "out")])
    assert Dropout.forward is forward
    assert [a["dropout"] for a in out["arms"]] == ["kernel", "eager", "eager", "kernel"]
    for arm in out["arms"]:
        assert arm["steps"] == STEPS and sorted(arm["ms_per_task"]) == sorted(TASKS)
        assert np.isfinite(arm["samples_per_s_at_mix"]) and arm["peak_MiB"] is None
    assert [s["site"] for s in out["sites"]] == ["attn_probs", "hidden", "feat"]
    assert out["sites"][0]["shape"] == [2, 2, 25, 25]
    assert all(s["kernel_device_ms"] is None for s in out["sites"])  # not measured off the card


def test_trainer_saves_at_every_valid_steps_crossing(tmp_path):
    """As the JAX trainer does (``pretrain/trainer.py:125-127``), ``train``
    writes ``ckpt_<step>`` whenever the step reaches a multiple of
    ``valid_steps``; a run cut short still leaves one to resume from."""
    trainer = cli.build(cli.parse_args([
        "--synthetic", "--device", "cpu", "--num_steps", "4", "--batch_size", "2",
        "--config", _tiny_config(tmp_path), "--output_dir", str(tmp_path / "out")]))
    trainer.cfg.valid_steps = 2
    trainer.train()
    assert sorted(f for f in os.listdir(tmp_path / "out") if f.startswith("ckpt_")) == [
        "ckpt_2", "ckpt_4"]
    trainer.restore(str(tmp_path / "out" / "ckpt_2"))
    assert trainer.state.step == 2
