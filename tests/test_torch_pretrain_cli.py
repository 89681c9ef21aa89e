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


def write_data_root(root, config_path, rng_seed=0) -> dict:
    """A small reference layout under ``root``: ``connectivity/``, the four
    HDF5 stores at the tiny configuration's widths, and per split the native
    ``r2r_{split}_enc.jsonl`` plus the same items split over a jsonl and a
    json file (``--train_files`` / ``--val_files``)."""
    from vln_bevbert_tpu_torch.configs import PretrainConfig, load_config
    from vln_bevbert_tpu_torch.data.feature_db import write_synthetic_features
    from vln_bevbert_tpu_torch.data.loader import make_synthetic_annotations
    from vln_bevbert_tpu_torch.data.nav_graph import load_nav_graphs, write_synthetic_connectivity

    cfg = load_config(PretrainConfig, config_path)
    rng = np.random.default_rng(rng_seed)
    write_synthetic_connectivity(str(root / "connectivity"), rng, n_scans=2, n_nodes=8)
    graphs = load_nav_graphs(str(root / "connectivity"))
    write_synthetic_features(str(root), rng, {s: g.node_ids for s, g in graphs.items()},
                             image_feat_size=cfg.model.image_feat_size,
                             grid_feat_size=cfg.model.bev_grid_feat_size,
                             grid_hw=cfg.shapes.grid_hw, num_views=cfg.shapes.num_views,
                             num_sem=cfg.model.num_sem_classes)
    files = {}
    for split in ("train", "val_unseen"):
        items = make_synthetic_annotations(graphs, rng, n_items=6, min_len=2, max_len=5)
        items = [{**it, "instr_encoding": [int(t) for t in it["instr_encoding"]]}
                 for it in items]
        lines = "".join(json.dumps(it) + "\n" for it in items)
        (root / f"r2r_{split}_enc.jsonl").write_text(lines)
        (root / f"{split}_a.jsonl").write_text("".join(json.dumps(it) + "\n" for it in items[:4]))
        (root / f"{split}_b.json").write_text(json.dumps(items[4:]))
        files[split] = f"{root / f'{split}_a.jsonl'},{root / f'{split}_b.json'}"
    return files


@pytest.mark.parametrize("layout", ["native", "traj_files"])
def test_data_root_batches_equal_the_jax_clis(tmp_path, layout):
    """``--data_root`` over a small HDF5 layout: the first train and
    val_unseen batches of every task equal those of the JAX CLI's
    ``build_real_db`` loaders (train at ``seed``, val_unseen at ``seed + 1``);
    then 2 steps with ``valid_steps`` 2 validate val_unseen before the save."""
    from vln_bevbert_tpu.cli.pretrain import build_real_db
    from vln_bevbert_tpu.configs import PretrainConfig, load_config
    from vln_bevbert_tpu.data.loader import PretrainLoader

    config = _tiny_config(tmp_path)
    root = tmp_path / "data"
    files = write_data_root(root, config)
    extra = (["--train_files", files["train"], "--val_files", files["val_unseen"]]
             if layout == "traj_files" else [])
    trainer = cli.build(cli.parse_args([
        "--data_root", str(root), "--device", "cpu", "--num_steps", "2", "--batch_size", "2",
        "--seed", str(SEED), "--config", config, "--output_dir", str(tmp_path / "out"),
        *extra]))
    cfg = load_config(PretrainConfig, config, seed=SEED, train_batch_size=2)
    traj = {s: f.split(",") for s, f in files.items()} if extra else {}
    loaders = {
        "train": (trainer.train_loader, PretrainLoader(
            build_real_db(cfg, str(root), "r2r", "train", traj.get("train")), cfg,
            seed=SEED, prefetch=0)),
        "val_unseen": (trainer.val_loaders["val_unseen"], PretrainLoader(
            build_real_db(cfg, str(root), "r2r", "val_unseen", traj.get("val_unseen")), cfg,
            seed=SEED + 1, prefetch=0)),
    }
    assert len(loaders["train"][0].nav_db) == len(loaders["train"][1].nav_db) == 6
    for split, (ours, ref) in loaders.items():
        for step, task in enumerate(TASKS):
            (t_ours, b_ours), (t_ref, b_ref) = (ours.build_batch(step, task=task),
                                                ref.build_batch(step, task=task))
            assert t_ours == t_ref and sorted(b_ours) == sorted(b_ref)
            for key, val in b_ref.items():
                np.testing.assert_array_equal(b_ours[key], val, err_msg=f"{split} {task} {key}")

    calls = []
    validate, save = trainer.validate, trainer.save
    trainer.validate = lambda step: calls.append(("validate", step)) or validate(step, 1)
    trainer.save = lambda step: calls.append(("save", step)) or save(step)
    trainer.cfg.valid_steps = 2
    trainer.train()
    assert calls == [("validate", 2), ("save", 2)]
    logged = [json.loads(line) for line in
              (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()]
    val = [r for r in logged if "val_unseen/mlm/loss" in r]
    assert len(val) == 1 and val[0]["step"] == 2 and np.isfinite(val[0]["val_unseen/mlm/loss"])


def test_init_bert_transfers_every_entry_it_maps(tmp_path, monkeypatch, capsys):
    """``--init_bert`` with ``load_hf_bert`` replaced by the tree of a bare
    HF ``BertConfig`` model at the tiny widths: every ``bert`` entry that
    ``hf_bert_to_tree`` maps (5 embedding entries, 12 per language layer)
    lands in the model, and the CLI prints the count."""
    transformers = pytest.importorskip("transformers")
    from vln_bevbert_tpu_torch.configs import PretrainConfig, load_config
    from vln_bevbert_tpu_torch.models import surgery

    config = _tiny_config(tmp_path)
    m = load_config(PretrainConfig, config).model
    hf_cfg = transformers.BertConfig(
        vocab_size=m.vocab_size, hidden_size=m.hidden_size, num_hidden_layers=m.num_l_layers,
        num_attention_heads=m.num_attention_heads, intermediate_size=m.intermediate_size,
        max_position_embeddings=m.max_position_embeddings)
    torch.manual_seed(0)
    hf = transformers.BertModel(hf_cfg)
    sd = {f"bert.{k}": v.detach().numpy() for k, v in hf.state_dict().items()}
    asked = []

    def fake_load(name, num_l_layers):
        asked.append((name, num_l_layers))
        return surgery.hf_bert_to_tree(sd, num_l_layers=num_l_layers)

    monkeypatch.setattr(surgery, "load_hf_bert", fake_load)
    trainer = cli.build(cli.parse_args([
        "--synthetic", "--init_bert", "--device", "cpu", "--batch_size", "2",
        "--config", config, "--output_dir", str(tmp_path / "out")]))
    assert asked == [("bert-base-uncased", m.num_l_layers)]
    src = surgery.hf_state_dict(fake_load("bert-base-uncased", m.num_l_layers))
    own = trainer.model.state_dict()
    assert len(src) == 5 + 12 * m.num_l_layers
    for name, val in src.items():
        assert torch.equal(own[name], val), name
    np.testing.assert_array_equal(
        own["bert.lang_encoder.layer_1.attn.att.qkv.weight"][: m.hidden_size].numpy(),
        sd["bert.encoder.layer.1.attention.self.query.weight"])
    assert f"--init_bert: {len(src)} of " in capsys.readouterr().out


def test_init_bert_without_transformers_names_the_flag(monkeypatch):
    """Where ``transformers`` cannot be imported, ``load_hf_bert`` raises an
    ImportError that names ``--init_bert``; nothing falls back."""
    import builtins

    from vln_bevbert_tpu_torch.models import surgery

    real_import = builtins.__import__

    def no_transformers(name, *args, **kw):
        if name.split(".")[0] == "transformers":
            raise ImportError("no transformers")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_transformers)
    with pytest.raises(ImportError, match="--init_bert"):
        surgery.load_hf_bert()
