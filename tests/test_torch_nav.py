"""The port's navigation-eval slice against the JAX agent.

Both agents run greedy eval on identically built synthetic worlds with the
same parameters (converted from the JAX agent's). Trajectories and eval
metrics must be equal and each step's fused logits agree at float32
atol=rtol=1e-4. The CLI runs on the CPU only when asked to, and the port
never imports JAX.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from vln_bevbert_tpu.configs import FinetuneConfig, ModelConfig, ShapeConfig
from vln_bevbert_tpu.data.loader import make_synthetic_annotations
from vln_bevbert_tpu.data.nav_graph import (
    build_scanvp_cands,
    load_nav_graphs,
    write_synthetic_connectivity,
)
from vln_bevbert_tpu.nav.agent import GMapNavAgent as JaxAgent
from vln_bevbert_tpu.nav.env import R2RNavBatch
from vln_bevbert_tpu_torch.cli import finetune as cli
from vln_bevbert_tpu_torch.convert import load_flax_params
from vln_bevbert_tpu_torch.nav.agent import GMapNavAgent

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ModelConfig(
    vocab_size=30522, hidden_size=32, num_attention_heads=2, intermediate_size=64,
    num_l_layers=1, num_pano_layers=1, num_x_layers=1, image_feat_size=16,
    obj_feat_size=0, bev_grid_feat_size=12, bev_dim=5, bev_res=1.5,
    dtype="float32",
)
SHAPES = ShapeConfig(
    max_txt_len=64, max_steps=6, max_pano_len=40, max_gmap_len=16,
    max_local_len=8, max_objects=0, num_views=4, grid_hw=4, max_pc_steps=4,
)
CFG = FinetuneConfig(model=TINY, shapes=SHAPES, batch_size=2, max_action_len=6)


def make_env(root):
    """One scan, 9 nodes, in-memory features: the same world on every call."""
    rng = np.random.default_rng(7)
    conn = os.path.join(root, "conn")
    if not os.path.exists(os.path.join(conn, "scans.txt")):
        write_synthetic_connectivity(conn, rng, n_scans=1, n_nodes=9)
    rng = np.random.default_rng(8)
    graphs = load_nav_graphs(conn)
    dbs = cli.synthetic_feature_dbs(
        rng, {s: g.node_ids for s, g in graphs.items()},
        image_feat_size=TINY.image_feat_size, grid_feat_size=TINY.bev_grid_feat_size,
        grid_hw=SHAPES.grid_hw, num_views=SHAPES.num_views,
    )
    del dbs["sem_db"]  # navigation reads no semantics
    annos = make_synthetic_annotations(graphs, rng, n_items=6, min_len=2, max_len=4)
    return R2RNavBatch(annos, graphs, build_scanvp_cands(graphs), batch_size=2,
                       image_feat_size=TINY.image_feat_size, **dbs)


def test_eval_slice_matches_jax(tmp_path):
    jax_agent = JaxAgent(CFG, make_env(tmp_path))
    jax_agent.init_params()
    agent = GMapNavAgent(CFG, make_env(tmp_path), device="cpu")
    load_flax_params(agent.model, jax.tree.map(np.asarray, jax_agent.params))

    jax_logits, our_logits = [], []
    jax_nav = jax_agent._fn("navigation")

    def jax_nav_recorded(params, batch):
        out = jax_nav(params, batch)
        jax_logits.append(np.asarray(out["fused_logits"]))
        return out

    jax_agent._jitted["navigation"] = jax_nav_recorded
    forward = agent._forward

    def forward_recorded(mode, batch):
        out = forward(mode, batch)
        if mode == "navigation":
            our_logits.append(out["fused_logits"].numpy())
        return out

    agent._forward = forward_recorded
    jax_preds = jax_agent.test(max_batches=2)
    our_preds = agent.test(max_batches=2)

    assert [p["instr_id"] for p in our_preds] == [p["instr_id"] for p in jax_preds]
    assert [p["trajectory"] for p in our_preds] == [p["trajectory"] for p in jax_preds]
    assert len(our_logits) == len(jax_logits) > 2
    for ours, ref in zip(our_logits, jax_logits):
        np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4)
    assert agent.env.eval_metrics(our_preds) == jax_agent.env.eval_metrics(jax_preds)


def test_teacher_rollout_follows_ground_truth(tmp_path):
    agent = GMapNavAgent(CFG, make_env(tmp_path), device="cpu")
    agent.init_params()
    trajs, loss = agent.rollout(feedback="teacher")
    assert loss is None
    by_id = {t["instr_id"]: sum(t["path"], []) for t in trajs}
    for item in agent.env.batch:
        assert by_id[item["instr_id"]][: len(item["path"])] == item["path"]
    with pytest.raises(ValueError, match="feedback"):
        agent.rollout(feedback="beam")


def _tiny_config(tmp_path):
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps({
        "model": TINY.__dict__, "shapes": SHAPES.__dict__, "max_action_len": 4,
    }))
    return str(path)


def test_cli_runs_cpu_slice_without_jax(tmp_path):
    """The port and its CPU slice run in a process that never imports JAX."""
    code = (
        "import json, sys\n"
        "from vln_bevbert_tpu_torch.cli import finetune\n"
        "res = finetune.main(sys.argv[1:])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('vln_bevbert_tpu', 'jax', 'jaxlib', 'flax', 'optax', 'orbax'))\n"
        "print(json.dumps({'bad': bad, 'res': res}))\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run(
        [sys.executable, "-c", code, "--synthetic", "--test", "--device", "cpu",
         "--batch_size", "2", "--config", _tiny_config(tmp_path),
         "--output_dir", str(tmp_path / "out")],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    metrics = out["res"]["val_unseen"]
    assert 0.0 <= metrics["sr"] <= 100.0 and metrics["nav_error"] >= 0.0
    preds = json.loads((tmp_path / "out" / "preds_val_unseen_0.json").read_text())
    assert len(preds) == 16


def test_cli_data_root_reads_hdf5_without_jax(tmp_path):
    """``--data_root``: the port evaluates from HDF5 stores through its own
    ``H5FeatureDB``, which casts float16 rows with numpy, in a process that
    loads neither JAX nor the JAX package."""
    import h5py

    from vln_bevbert_tpu.data.feature_db import write_synthetic_features
    from vln_bevbert_tpu_torch.data.feature_db import H5FeatureDB

    root = tmp_path / "data"
    rng = np.random.default_rng(0)
    write_synthetic_connectivity(str(root / "connectivity"), rng, n_scans=1, n_nodes=9)
    graphs = load_nav_graphs(str(root / "connectivity"))
    paths = write_synthetic_features(
        str(root), rng, {s: g.node_ids for s, g in graphs.items()}, pack=False,
        image_feat_size=TINY.image_feat_size, grid_feat_size=TINY.bev_grid_feat_size,
        grid_hw=SHAPES.grid_hw, num_views=SHAPES.num_views,
    )
    for split in ("train", "val_unseen"):
        items = make_synthetic_annotations(graphs, rng, n_items=4, min_len=2, max_len=4)
        (root / f"R2R_{split}_enc.json").write_text(json.dumps([
            {"path_id": i, "scan": it["scan"], "path": it["path"],
             "heading": it["heading"], "instructions": ["synthetic instruction"],
             "instr_encodings": [[int(t) for t in it["instr_encoding"]]]}
            for i, it in enumerate(items)
        ]))

    depth = H5FeatureDB(paths["depth"])
    scan, vp = "scan00", graphs["scan00"].node_ids[0]
    with h5py.File(paths["depth"], "r") as f:
        want = f[f"{scan}_{vp}"][...]
    assert want.dtype == np.float16
    got = depth.get(scan, vp)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want.astype(np.float32))
    depth.close()

    code = (
        "import json, sys\n"
        "from vln_bevbert_tpu_torch.cli import finetune\n"
        "res = finetune.main(sys.argv[1:])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('vln_bevbert_tpu', 'jax', 'jaxlib', 'flax'))\n"
        "print(json.dumps({'bad': bad, 'res': res}))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code, "--data_root", str(root), "--test",
         "--device", "cpu", "--val_splits", "val_unseen", "--batch_size", "2",
         "--config", _tiny_config(tmp_path), "--output_dir", str(tmp_path / "out")],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert 0.0 <= out["res"]["val_unseen"]["sr"] <= 100.0
    preds = json.loads((tmp_path / "out" / "preds_val_unseen_0.json").read_text())
    assert len(preds) == 4


def test_cli_cuda_device_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--synthetic", "--test", "--device", "cuda",
                  "--output_dir", str(tmp_path)])
    # the object-grounding datasets build their object envs and object slots
    cfg, train_envs, val_envs, agent = cli.build(cli.parse_args([
        "--synthetic", "--dataset", "soon", "--device", "cpu",
        "--config", _tiny_config(tmp_path), "--output_dir", str(tmp_path)]))
    assert [type(e).__name__ for e in train_envs] == ["SoonObjectNavBatch"]
    assert type(val_envs["val_unseen"]).__name__ == "SoonObjectNavBatch"
    assert cfg.model.obj_feat_size == 768 and agent.model.og_head is not None


def test_synthetic_world_matches_jax_cli_draws(tmp_path):
    """The in-memory stores hold what the JAX CLI's HDF5 files hold."""
    from vln_bevbert_tpu.data.feature_db import H5FeatureDB, write_synthetic_features

    vps = {"scan00": ["a", "b"]}
    kw = dict(image_feat_size=8, grid_feat_size=6, grid_hw=2, num_views=3)
    paths = write_synthetic_features(str(tmp_path), np.random.default_rng(5), vps,
                                     pack=False, **kw)
    ours = cli.synthetic_feature_dbs(np.random.default_rng(5), vps, **kw)
    for key, path, dtype in (("view_db", "img_ft", np.float32),
                             ("grid_db", "rgb", np.float16),
                             ("depth_db", "depth", np.float32),
                             ("sem_db", "sem", np.uint8)):
        h5 = H5FeatureDB(paths[path], dtype=dtype)
        for vp in vps["scan00"]:
            got = ours[key].get("scan00", vp)
            assert got.dtype == dtype
            np.testing.assert_array_equal(got, h5.get("scan00", vp))
        h5.close()
