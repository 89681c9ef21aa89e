"""The port's own host layer (configs, geometry, data, nav env and graph,
metrics, the native graph engine, logging) against the JAX package's
originals, and the rule that the port loads nothing of the JAX package.

The port keeps its own copy of these modules, so each copy is held to its
original on the same seeds: configs by ``dataclasses.asdict``, the synthetic
world's graphs, distances and candidates, ``R2RNavBatch`` observations and
metrics, ``PretrainLoader`` batches, and DTW and the Floyd graph through the
native engine and the Python fallback. Arrays must be equal; floats computed
by the same code in the same order must be equal too.
"""

import dataclasses
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_nav import SHAPES, TINY, _tiny_config
from test_torch_pretrain_cli import _tiny_config as pretrain_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the copied modules; ``data.feature_db`` leaves out the XLA float16 cast
COPIED = ("configs", "geometry", "data.nav_graph", "data.pathdata", "data.batching",
          "data.loader", "data.feature_db", "data.annotations", "nav.eval_utils", "native",
          "nav.graph_map", "nav.env", "utils.logging")
LEFT_OUT = {"data.feature_db": {"fast_cast"}}
FORBIDDEN = ("vln_bevbert_tpu", "jax", "jaxlib", "flax", "optax", "orbax")


def config_file(tmp_path, make):
    """A tiny config written by ``make`` into a directory of its own (the
    helpers of the other test files all write ``tiny.json``)."""
    d = tmp_path / make.__module__
    d.mkdir(exist_ok=True)
    return make(d)


def pair(name):
    return (importlib.import_module(f"vln_bevbert_tpu.{name}"),
            importlib.import_module(f"vln_bevbert_tpu_torch.{name}"))


def assert_same(a, b, path="value"):
    """Equal nested dicts / lists / tuples / arrays / scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b or (a != a and b != b), f"{path}: {a!r} != {b!r}"


def synthetic_world(pkg, root, seed=3, n_scans=2, n_nodes=9, n_items=8):
    """(graphs, candidates, annotations) of a package's synthetic world."""
    nav_graph = importlib.import_module(f"{pkg}.data.nav_graph")
    loader = importlib.import_module(f"{pkg}.data.loader")
    rng = np.random.default_rng(seed)
    conn = os.path.join(root, pkg, "conn")
    nav_graph.write_synthetic_connectivity(conn, rng, n_scans=n_scans, n_nodes=n_nodes)
    graphs = nav_graph.load_nav_graphs(conn)
    annos = loader.make_synthetic_annotations(graphs, rng, n_items=n_items, min_len=2,
                                              max_len=5)
    return graphs, nav_graph.build_scanvp_cands(graphs), annos


def feature_dicts(graphs, seed=4, feat=TINY.image_feat_size, grid=TINY.bev_grid_feat_size,
                  hw=SHAPES.grid_hw, views=SHAPES.num_views, num_sem=40):
    rng = np.random.default_rng(seed)
    out = {"view_db": {}, "grid_db": {}, "depth_db": {}, "sem_db": {}}
    for scan, g in graphs.items():
        for vp in g.node_ids:
            key = f"{scan}_{vp}"
            out["view_db"][key] = rng.normal(size=(36, feat)).astype(np.float32)
            out["grid_db"][key] = rng.normal(size=(views, hw * hw, grid)).astype(np.float16)
            out["depth_db"][key] = rng.uniform(0.02, 0.9, (views, hw, hw)).astype(np.float32)
            out["sem_db"][key] = rng.integers(0, num_sem, (views, hw, hw)).astype(np.uint8)
    return out


def dbs_of(pkg, dicts, keys):
    db = importlib.import_module(f"{pkg}.data.feature_db")
    return {k: db.DictFeatureDB(dicts[k]) for k in keys}


# ------------------------------------------------------------------ checks
def check_configs(tmp_path):
    jax_cfg, port_cfg = pair("configs")
    for cls in ("ModelConfig", "ShapeConfig", "OptimConfig", "PretrainConfig",
                "FinetuneConfig"):
        assert_same(dataclasses.asdict(getattr(jax_cfg, cls)()),
                    dataclasses.asdict(getattr(port_cfg, cls)()), cls)
    for cls, path, overrides in (
        ("FinetuneConfig", config_file(tmp_path, _tiny_config),
         {"batch_size": 3, "seed": 7, "model.hidden_dropout_prob": 0.2}),
        ("PretrainConfig", config_file(tmp_path, pretrain_config),
         {"train_batch_size": 5, "seed": 7, "optim.learning_rate": 1e-4}),
    ):
        a = jax_cfg.load_config(getattr(jax_cfg, cls), path, **overrides)
        b = port_cfg.load_config(getattr(port_cfg, cls), path, **overrides)
        assert_same(dataclasses.asdict(a), dataclasses.asdict(b), cls)
        assert (a.model.num_bev_tokens, a.shapes.num_points) == (
            b.model.num_bev_tokens, b.shapes.num_points)


def check_synthetic_world(tmp_path):
    jax_world = synthetic_world("vln_bevbert_tpu", tmp_path)
    port_world = synthetic_world("vln_bevbert_tpu_torch", tmp_path)
    (jg, jc, ja), (pg, pc, pa) = jax_world, port_world
    assert jg.keys() == pg.keys()
    for scan in jg:
        a, b = jg[scan], pg[scan]
        assert a.node_ids == b.node_ids and a.adjacency == b.adjacency
        for attr in ("positions", "distances", "predecessors", "hops"):
            np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr), err_msg=attr)
        u, v = a.node_ids[0], a.node_ids[-1]
        assert a.path(u, v) == b.path(u, v) and a.distance(u, v) == b.distance(u, v)
    assert_same(jc, pc, "candidates")
    assert_same(ja, pa, "annotations")
    jdir, pdir = tmp_path / "vln_bevbert_tpu" / "conn", tmp_path / "vln_bevbert_tpu_torch" / "conn"
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(pdir))
    for name in os.listdir(jdir):  # the connectivity files written
        assert (jdir / name).read_bytes() == (pdir / name).read_bytes(), name


def check_nav_env(tmp_path):
    envs, worlds = {}, {}
    for pkg in ("vln_bevbert_tpu", "vln_bevbert_tpu_torch"):
        graphs, cands, annos = worlds[pkg] = synthetic_world(pkg, tmp_path)
        env_mod = importlib.import_module(f"{pkg}.nav.env")
        dicts = feature_dicts(graphs)
        envs[pkg] = env_mod.R2RNavBatch(
            annos, graphs, cands, batch_size=3, image_feat_size=TINY.image_feat_size, seed=5,
            **dbs_of(pkg, dicts, ("view_db", "grid_db", "depth_db")))
    jenv, penv = envs["vln_bevbert_tpu"], envs["vln_bevbert_tpu_torch"]
    for _ in range(3):  # three minibatches, each reset, then a move per slot
        assert_same(jenv.reset(), penv.reset(), "reset obs")
        for env in (jenv, penv):
            for slot, ob in enumerate(env.get_obs()):
                if ob["candidate"]:
                    env.teleport(slot, ob["candidate"][0]["viewpointId"], ob["heading"])
        assert_same(jenv.get_obs(), penv.get_obs(), "obs after a move")
    preds = []
    for i, item in enumerate(jenv.data):
        path = item["path"] if i % 2 else item["path"][:1] + item["path"][:-1]
        preds.append({"instr_id": item["instr_id"], "trajectory": [[vp] for vp in path]})
    assert_same(jenv.eval_metrics(preds), penv.eval_metrics(preds), "metrics")


def check_pretrain_loader(tmp_path):
    batches = {}
    for pkg in ("vln_bevbert_tpu", "vln_bevbert_tpu_torch"):
        cfg_mod = importlib.import_module(f"{pkg}.configs")
        pathdata = importlib.import_module(f"{pkg}.data.pathdata")
        loader = importlib.import_module(f"{pkg}.data.loader")
        cfg = cfg_mod.load_config(cfg_mod.PretrainConfig, config_file(tmp_path, pretrain_config),
                                  train_batch_size=2, num_workers=0)
        graphs, cands, annos = synthetic_world(pkg, tmp_path, n_items=16)
        dicts = feature_dicts(graphs, feat=cfg.model.image_feat_size,
                              grid=cfg.model.bev_grid_feat_size, hw=cfg.shapes.grid_hw,
                              views=cfg.shapes.num_views)
        db = pathdata.TextPathData(
            annos, graphs, cands,
            **dbs_of(pkg, dicts, ("view_db", "grid_db", "depth_db", "sem_db")),
            image_feat_size=cfg.model.image_feat_size, max_txt_len=cfg.shapes.max_txt_len,
            bev_dim=cfg.model.bev_dim, bev_res=cfg.model.bev_res,
            num_views=cfg.shapes.num_views)
        pl = loader.PretrainLoader(db, cfg, seed=11)
        batches[pkg] = [pl.build_batch(step) for step in range(6)]
        batches[pkg] += [pl.build_batch(9, task=t) for t in ("mlm", "sap", "masksem")]
    tasks = [task for task, _ in batches["vln_bevbert_tpu"]]
    assert set(tasks) >= {"mlm", "sap", "masksem"}
    assert_same(batches["vln_bevbert_tpu"], batches["vln_bevbert_tpu_torch"], "batches")


def check_dtw_and_floyd(tmp_path):
    jnat, pnat = pair("native")
    jeval, peval = pair("nav.eval_utils")
    jmap, pmap = pair("nav.graph_map")
    assert pnat.available() and jnat.available()
    rng = np.random.default_rng(2)
    costs = rng.uniform(0, 5, size=(7, 5))
    assert pnat.dtw_costmatrix(costs) == jnat.dtw_costmatrix(costs)
    a, b = rng.normal(size=(6, 3)), rng.normal(size=(4, 3))
    assert pnat.dtw_positions(a, b) == jnat.dtw_positions(a, b)
    graphs, _, _ = synthetic_world("vln_bevbert_tpu", tmp_path)
    g = next(iter(graphs.values()))
    pred, ref = g.node_ids[:4], g.node_ids[2:6]
    edges = [(g.node_ids[i], g.node_ids[j]) for i, nb in enumerate(g.adjacency) for j in nb]
    for native in (True, False):  # the C++ engine, then the Python fallback
        saved = [(m._lib, m._build_failed) for m in (jnat, pnat)]
        if not native:
            for m in (jnat, pnat):
                m._lib, m._build_failed = None, True
        try:
            assert_same(jeval.compute_dtw_metrics(g.distance, pred, ref),
                        peval.compute_dtw_metrics(g.distance, pred, ref), "dtw")
            floyd = [jmap.make_floyd_graph(use_native=native),
                     pmap.make_floyd_graph(use_native=native)]
        finally:
            for m, (lib, failed) in zip((jnat, pnat), saved):
                m._lib, m._build_failed = lib, failed
        assert type(floyd[1]).__name__ == ("NativeFloydGraph" if native else "FloydGraph")
        for fg in floyd:
            for u, v in edges:
                fg.add_edge(u, v, g.distance(u, v))
            for vp in g.node_ids[:5]:
                fg.update(vp)
        for u in g.node_ids[:5]:
            for v in g.node_ids[:5]:
                assert floyd[0].distance(u, v) == floyd[1].distance(u, v)
                assert floyd[0].path(u, v) == floyd[1].path(u, v)
    assert jeval.compute_cls(g.distance, pred, ref) == peval.compute_cls(g.distance, pred, ref)


CHECKS = {"configs": check_configs, "synthetic_world": check_synthetic_world,
          "nav_env": check_nav_env, "pretrain_loader": check_pretrain_loader,
          "dtw_and_floyd": check_dtw_and_floyd}


@pytest.mark.parametrize("name", list(CHECKS))
def test_host_module_matches_its_jax_original(name, tmp_path):
    CHECKS[name](tmp_path)


@pytest.mark.parametrize("name", COPIED)
def test_copied_module_keeps_the_originals_public_names(name):
    jax_mod, port_mod = pair(name)
    public = {k for k in vars(jax_mod) if not k.startswith("_")
              and getattr(vars(jax_mod)[k], "__module__", jax_mod.__name__) == jax_mod.__name__}
    missing = public - set(vars(port_mod)) - LEFT_OUT.get(name, set())
    assert not missing, f"{name}: {sorted(missing)}"


def test_port_loads_nothing_of_the_jax_package(tmp_path):
    """Every module of the port and chip_smoke import, then the three CPU CLI
    paths run (eval, pretraining, fine-tuning) at a tiny configuration, in
    one process that loads no JAX module and no module of the JAX package."""
    from test_torch_finetune_cli import finetune_config

    code = (
        "import importlib, json, pkgutil, sys\n"
        "import vln_bevbert_tpu_torch as port\n"
        "names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "from vln_bevbert_tpu_torch.cli import finetune, pretrain\n"
        "out, tiny, ft, pt = sys.argv[1:5]\n"
        "ev = finetune.main(['--synthetic', '--test', '--device', 'cpu', '--config', tiny,\n"
        "                    '--output_dir', out + '/eval'])\n"
        "pre = pretrain.main(['--synthetic', '--device', 'cpu', '--num_steps', '2',\n"
        "                     '--batch_size', '2', '--config', pt, '--output_dir', out + '/pt'])\n"
        "tr = finetune.main(['--synthetic', '--device', 'cpu', '--iters', '1', '--config', ft,\n"
        "                    '--output_dir', out + '/ft'])\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps({'bad': bad, 'names': names, 'sr': [ev['val_unseen']['sr'],\n"
        "                  tr['val_unseen']['sr']], 'loss': list(pre)}))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path), config_file(tmp_path, _tiny_config),
         config_file(tmp_path, finetune_config), config_file(tmp_path, pretrain_config)],
        capture_output=True, text=True, timeout=400, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert {"vln_bevbert_tpu_torch._build", "vln_bevbert_tpu_torch.data.feature_db",
            "vln_bevbert_tpu_torch.native", "vln_bevbert_tpu_torch.nav.env"} <= set(out["names"])
    assert all(0.0 <= sr <= 100.0 for sr in out["sr"]) and out["loss"]
