"""The port's CE CLI (``vln_bevbert_tpu_torch.cli.ce_train``) on the CPU at a
tiny configuration.

- The pipeline as users run it, in one process that must load no JAX module:
  CE pretraining (``cli.pretrain`` at ``configs/ce_pretrain.json``'s flags)
  writes ``ckpt_2``; SS-BEV training from it (every navigation parameter
  transfers) runs 2 iterations with an evaluation and a ``ckpt_<done>`` file
  after each; ``--run_type eval`` over those files writes one stats file per
  checkpoint and a second run reuses them; ``--run_type inference`` writes
  R2R-CE json and RxR jsonl over every episode; SS-ETP trains.
- ``--data_path``/``--gt_path``: release-format ``.json.gz`` episodes, as
  the JAX loaders read them, evaluated with ``control`` back-tracking.
- The config equals the JAX CLI's for ss-bev and ss-etp; ``--waypoint_ckpt``
  loads the published layout; the flags of later slices, a missing card and
  a random frozen predictor without ``--allow_random_frozen`` are refused.
"""

import dataclasses
import gzip
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_ce import reference_layout_state_dict
from test_torch_pretrain_cli import _tiny_config as pretrain_config
from vln_bevbert_tpu.ce.dataset import apply_gt_paths, load_gt_paths, load_vlnce_episodes
from vln_bevbert_tpu.cli import ce_train as jax_cli
from vln_bevbert_tpu_torch.ce.waypoint_predictor import load_waypoint_ckpt
from vln_bevbert_tpu_torch.cli import ce_train as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MODULES = ("vln_bevbert_tpu", "jax", "jaxlib", "flax", "optax", "orbax")
CE_SHAPES = {"max_txt_len": 64, "max_steps": 4, "max_pano_len": 16, "max_gmap_len": 12,
             "max_local_len": 8, "max_objects": 0, "num_views": 12, "grid_hw": 4,
             "max_pc_steps": 3, "max_masked_tokens": 4}


def ce_configs(tmp_path):
    """(CE pretraining config, CE fine-tuning config): the pretraining
    test's tiny model with ``configs/ce_pretrain.json``'s tasks, BEV and
    depth embedding, and CE's 12 views."""
    with open(pretrain_config(tmp_path)) as f:
        tiny = json.load(f)
    with open(os.path.join(REPO, "configs", "ce_pretrain.json")) as f:
        ce = json.load(f)
    model = {**tiny["model"], **ce["model"], "image_feat_size": tiny["model"]["image_feat_size"]}
    pre = tmp_path / "ce_pretrain_tiny.json"
    pre.write_text(json.dumps({**tiny, "tasks": ce["tasks"], "mix_ratio": ce["mix_ratio"],
                               "model": model, "shapes": CE_SHAPES}))
    ft = tmp_path / "ce_tiny.json"
    ft.write_text(json.dumps({"model": model, "shapes": CE_SHAPES, "batch_size": 2,
                              "max_action_len": 3}))
    return str(pre), str(ft)


def test_ce_pipeline_runs_on_cpu_without_jax(tmp_path):
    pre_cfg, ce_cfg = ce_configs(tmp_path)
    out = str(tmp_path / "ce")
    code = (
        "import json, sys\n"
        "from vln_bevbert_tpu_torch.cli import ce_train, pretrain\n"
        "pre_cfg, ce_cfg, root, out = sys.argv[1:5]\n"
        "base = ['--device', 'cpu', '--config', ce_cfg, '--allow_random_frozen',\n"
        "        '--n_episodes', '4', '--output_dir', out]\n"
        "pretrain.main(['--synthetic', '--device', 'cpu', '--num_steps', '2', '--batch_size',\n"
        "               '2', '--config', pre_cfg, '--output_dir', root + '/pt'])\n"
        "res = {'train': ce_train.main(base + ['--pretrain_ckpt', root + '/pt/ckpt_2',\n"
        "                                      '--iters', '2', '--log_every', '1'])}\n"
        "res['eval'] = ce_train.main(base + ['--run_type', 'eval', '--ckpt_path_dir', out,\n"
        "                                    '--eval_batches', '1'])\n"
        "stats = out + '/stats_ckpt_2_val_unseen.json'\n"
        "json.dump(dict(json.load(open(stats)), success=0.125), open(stats, 'w'))\n"
        "res['eval_again'] = ce_train.main(base + ['--run_type', 'eval', '--ckpt_path_dir',\n"
        "                                          out, '--eval_batches', '1'])\n"
        "res['r2r'] = ce_train.main(base + ['--run_type', 'inference', '--ckpt_path_dir',\n"
        "                                   out + '/ckpt_2'])\n"
        "ce_train.main(base + ['--run_type', 'inference', '--ckpt_path_dir', out + '/ckpt_2',\n"
        "                      '--task_type', 'rxr', '--predictions_file', 'preds.jsonl'])\n"
        "res['etp'] = ce_train.main(base[:-1] + [root + '/etp', '--trainer', 'ss-etp',\n"
        "                                        '--iters', '1', '--log_every', '1'])\n"
        f"res['bad'] = sorted(m for m in sys.modules if m.split('.')[0] in {JAX_MODULES!r})\n"
        "print(json.dumps(res))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, pre_cfg, ce_cfg, str(tmp_path), out],
                          capture_output=True, text=True, timeout=400, cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["bad"] == []

    logged = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert logged[0]["pretrain/transferred"] == logged[0]["pretrain/params"] > 100
    train = [r for r in logged if "train/loss" in r]
    assert [r["step"] for r in train] == [1, 2]
    assert all(np.isfinite(r["train/loss"]) and r["train/loss"] > 0 for r in train)
    for metrics in (res["train"], res["etp"]):
        assert 0.0 <= metrics["success"] <= 1.0 and 0.0 <= metrics["ndtw"] <= 1.0
    ckpts = sorted(f for f in os.listdir(out) if f.startswith("ckpt"))
    assert ckpts == ["ckpt_1", "ckpt_2"]
    assert sorted(res["eval"]) == ckpts
    for name in ckpts:
        assert os.path.exists(os.path.join(out, f"stats_{name}_val_unseen.json"))
    # the second evaluation reads the stats files back instead of evaluating
    assert res["eval_again"]["ckpt_2"] == dict(res["eval"]["ckpt_2"], success=0.125)
    assert res["eval_again"]["ckpt_1"] == res["eval"]["ckpt_1"]

    preds = json.load(open(os.path.join(out, "preds.json")))
    assert preds == res["r2r"] and sorted(preds) == [f"ce_{i}" for i in range(4)]
    for steps in preds.values():
        assert steps and all(set(s) == {"position", "heading"} and len(s["position"]) == 3
                             for s in steps)
    lines = [json.loads(line) for line in open(os.path.join(out, "preds.jsonl"))]
    assert [p["instruction_id"] for p in lines] == [0, 1, 2, 3]
    for p in lines:
        assert all(a != b for a, b in zip(p["path"], p["path"][1:]))
    assert os.path.exists(tmp_path / "etp" / "ckpt_1")


def write_release_episodes(root):
    """Four R2R_VLNCE-format episodes and their dense gt locations."""
    rng = np.random.default_rng(0)
    eps, gt = [], {}
    for i in range(4):
        start = [float(rng.uniform(0, 5)), 0.0, float(rng.uniform(0, 5))]
        path = [start]
        for _ in range(2):
            p = path[-1]
            path.append([p[0] + float(rng.uniform(1, 2)), 0.0, p[2] + float(rng.uniform(1, 2))])
        eps.append({
            "episode_id": i, "trajectory_id": i, "scene_id": "mp3d/S/S.glb",
            "start_position": start, "start_rotation": [0.0, 0.38268343, 0.0, 0.92387953],
            "goals": [{"position": path[-1], "radius": 3.0}], "reference_path": path,
            "instruction": {"instruction_text": "go",
                            "instruction_tokens": rng.integers(2000, 4000, 12).tolist()},
        })
        dense = np.linspace(path[0], path[-1], 6).tolist()
        gt[str(i)] = {"locations": dense, "actions": [1] * 5 + [0]}
    data_path, gt_path = root / "val_unseen.json.gz", root / "val_unseen_gt.json.gz"
    with gzip.open(data_path, "wt") as f:
        json.dump({"episodes": eps, "instruction_vocab": {"word_list": []}}, f)
    with gzip.open(gt_path, "wt") as f:
        json.dump(gt, f)
    return str(data_path), str(gt_path)


def test_ce_cli_evaluates_release_format_episodes(tmp_path):
    _, ce_cfg = ce_configs(tmp_path)
    data_path, gt_path = write_release_episodes(tmp_path)
    args = cli.parse_args(["--device", "cpu", "--config", ce_cfg, "--allow_random_frozen",
                           "--data_path", data_path, "--gt_path", gt_path])
    cfg, agent = cli.build(args)
    want = apply_gt_paths(load_vlnce_episodes(data_path), load_gt_paths(gt_path))
    assert [e.episode_id for e in agent.env.episodes] == [e.episode_id for e in want]
    for ours, ref in zip(agent.env.episodes, want):
        for key in ("instr_encoding", "start_pos", "gt_positions", "goal"):
            np.testing.assert_array_equal(getattr(ours, key), getattr(ref, key))
        assert ours.start_heading == ref.start_heading
    assert cfg.ce_back_algo == "control" and len(want[0].gt_positions) == 6
    metrics = cli.main(["--device", "cpu", "--config", ce_cfg, "--allow_random_frozen",
                        "--data_path", data_path, "--gt_path", gt_path, "--run_type", "eval",
                        "--eval_batches", "2", "--output_dir", str(tmp_path / "out")])
    assert 0.0 <= metrics["success"] <= 1.0 and np.isfinite(metrics["ndtw"])
    logged = json.loads((tmp_path / "out" / "metrics.jsonl").read_text().splitlines()[-1])
    assert logged["eval/success"] == metrics["success"]


@pytest.mark.parametrize("extra", [
    [], ["--trainer", "ss-etp", "--back_algo", "teleport", "--ml_weight", "0.5"]])
def test_config_matches_the_jax_clis(tmp_path, monkeypatch, extra):
    """The JAX CLI's config just before it builds its agent (its batch is
    per chip there) equals the port's."""
    import vln_bevbert_tpu.ce.agent as jax_agent_mod

    _, ce_cfg = ce_configs(tmp_path)
    argv = ["--config", ce_cfg, "--allow_random_frozen", "--batch_size", "3",
            "--output_dir", str(tmp_path), *extra]
    seen = {}

    class Stop(RuntimeError):
        pass

    def capture(cfg, *a, **kw):
        seen["cfg"] = cfg
        raise Stop

    monkeypatch.setattr(jax_agent_mod, "CEAgent", capture)
    with pytest.raises(Stop):
        jax_cli.main(argv)
    ref = seen["cfg"]
    ref.batch_size //= jax.device_count()
    cfg = cli.make_config(cli.parse_args(argv + ["--device", "cpu"]))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    default = cli.make_config(cli.parse_args([]))
    assert (default.model.bev_dim, default.model.bev_res, default.model.hidden_size) == (11, 1.0,
                                                                                       768)


def test_waypoint_ckpt_flag_loads_the_published_layout(tmp_path):
    _, ce_cfg = ce_configs(tmp_path)
    sd = reference_layout_state_dict(hidden=64, inter=128, depth=128 * 4 * 4)
    path = tmp_path / "check_cwp_bestdist_hfov90"
    torch.save({"predictor": {"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}},
               path)
    _, agent = cli.build(cli.parse_args(["--device", "cpu", "--config", ce_cfg,
                                         "--n_episodes", "2", "--waypoint_ckpt", str(path)]))
    want = load_waypoint_ckpt(sd)
    got = agent.wp_model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_refused_flags_and_devices(tmp_path, monkeypatch):
    _, ce_cfg = ce_configs(tmp_path)
    base = ["--device", "cpu", "--config", ce_cfg, "--output_dir", str(tmp_path)]
    with pytest.raises(SystemExit, match="allow_random_frozen"):
        cli.build(cli.parse_args(base))
    for flags, slice_name in (
        (["--habitat_config", "h.yaml"], "Habitat sensor stack"),
        (["--clip_ckpt", "clip.pt"], "Habitat sensor stack"),
        (["--ddppo_ckpt", "ddppo.pt"], "Habitat sensor stack"),
        (["--trainer", "dagger", "--habitat_config", "h.yaml"], "Habitat sensor stack"),
        (["--num_env_workers", "2", "--clip_ckpt", "clip.pt"], "Habitat sensor stack"),
    ):
        with pytest.raises(SystemExit, match=f"not ported yet.*{slice_name}"):
            cli.main(base + ["--allow_random_frozen", *flags])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--allow_random_frozen", "--config", ce_cfg, "--output_dir", str(tmp_path)])
