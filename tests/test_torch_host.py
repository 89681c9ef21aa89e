"""The port's own host layer (configs, geometry, data, nav env and graph,
metrics, the native graph engine, logging) against the JAX package's
originals, and the rule that the port loads nothing of the JAX package.

The port keeps its own copy of these modules, so each copy is held to its
original on the same seeds: configs by ``dataclasses.asdict``, the synthetic
world's graphs, distances and candidates, ``R2RNavBatch`` observations and
metrics, the REVERIE/SOON object envs' observations and metrics,
``PretrainLoader`` batches with and without object stores, and DTW and the
Floyd graph through the native engine and the Python fallback, and the CE
host layer (habitat geometry, the synthetic continuous env and its
low-level controller, the ghost-node map, the VLN-CE loaders, the waypoint
NMS and sampling), the FIFO npz shard store behind the recollection
stores, and the Habitat sensor stack's host layer (observation transforms,
the sensor functions and top-down map, the habitat binding without towers
and the MatterSim binding over the JAX tests' fake simulators, the
precompute pipeline's synthetic frames and projection encoder). Arrays must be equal; floats computed
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
# the copied modules; ``data.feature_db`` leaves out the XLA float16 cast,
# and its ``build_pack`` removes a stale sidecar that the original leaves in
# place (``test_big_row_store_drops_a_stale_pack``: the one behaviour of a
# copy held to differ from its original); ``ce.waypoint_predictor`` keeps
# the host NMS and sampling of the original beside its torch module
COPIED = ("configs", "geometry", "data.nav_graph", "data.pathdata", "data.batching",
          "data.loader", "data.feature_db", "data.annotations", "nav.eval_utils", "native",
          "nav.graph_map", "nav.env", "nav.obj_env", "utils.logging", "ce.geometry_ce",
          "ce.env", "ce.graph_map", "ce.control", "ce.dataset", "ce.waypoint_predictor",
          "ce.inference", "utils.mlabel", "models.surgery", "utils.npz_store", "ce.env_pool",
          "ce.obs_transforms", "ce.sensors", "ce.habitat_binding", "nav.mattersim_binding",
          "precompute.pipeline")
# ``precompute.pipeline`` runs the port's tower (``DeviceClipEncoder``) in
# place of ``JaxClipEncoder``
LEFT_OUT = {"data.feature_db": {"fast_cast"}, "ce.waypoint_predictor": {"jax", "jnp"},
            "precompute.pipeline": {"JaxClipEncoder"}}
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
    # the R4R and RxR pretraining configurations (RxR: XLM-R's vocabulary)
    for name, vocab in (("r4r_pretrain.json", 30522), ("rxr_pretrain.json", 250002)):
        path = os.path.join(REPO, "configs", name)
        a = jax_cfg.load_config(jax_cfg.PretrainConfig, path)
        b = port_cfg.load_config(port_cfg.PretrainConfig, path)
        assert_same(dataclasses.asdict(a), dataclasses.asdict(b), name)
        assert b.model.vocab_size == vocab


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


def object_world(pkg, tmp_path, obj_feat_size=6, obj_prob_size=5):
    """A package's synthetic world with the JAX loader's object fixtures
    (``make_synthetic_object_world``): (graphs, candidates, annotations,
    object records, goal table)."""
    loader = importlib.import_module(f"{pkg}.data.loader")
    graphs, cands, _ = synthetic_world(pkg, tmp_path, n_items=1)
    annos, obj_data, obj2vps = loader.make_synthetic_object_world(
        graphs, np.random.default_rng(6), n_items=12, obj_feat_size=obj_feat_size,
        obj_prob_size=obj_prob_size)
    return graphs, cands, annos, obj_data, obj2vps


def check_obj_env(tmp_path):
    envs = {}
    for pkg in ("vln_bevbert_tpu", "vln_bevbert_tpu_torch"):
        graphs, cands, annos, obj_data, obj2vps = object_world(pkg, tmp_path)
        obj_env = importlib.import_module(f"{pkg}.nav.obj_env")
        dicts = feature_dicts(graphs)
        envs[pkg] = obj_env.ReverieObjectNavBatch(
            annos, graphs, cands, batch_size=3, image_feat_size=TINY.image_feat_size, seed=5,
            obj_db=obj_env.ObjectDB(obj_data), obj2vps=obj2vps, max_objects=1,
            multi_endpoints=True, **dbs_of(pkg, dicts, ("view_db", "grid_db", "depth_db")))
    jenv, penv = envs["vln_bevbert_tpu"], envs["vln_bevbert_tpu_torch"]
    for _ in range(3):  # resampled goals, then a move per slot
        assert_same(jenv.reset(), penv.reset(), "reset obs")
        assert_same(jenv.batch, penv.batch, "episodes")
        for env in (jenv, penv):
            for slot, ob in enumerate(env.get_obs()):
                if ob["candidate"]:
                    env.teleport(slot, ob["candidate"][0]["viewpointId"], ob["heading"])
        assert_same(jenv.get_obs(), penv.get_obs(), "obs after a move")
    preds = []
    for i, (instr_id, (_, path, obj_id)) in enumerate(jenv.gt_trajs.items()):
        path = path if i % 2 else path[:1] + path[:-1]
        preds.append({"instr_id": instr_id, "trajectory": [[vp] for vp in path],
                      "pred_objid": obj_id if i % 3 else "none"})
    assert_same(jenv.eval_metrics(preds), penv.eval_metrics(preds), "metrics")
    assert 0 < jenv.eval_metrics(preds)[0]["rgs"] < 100
    soon = {}
    for pkg, env in envs.items():
        soon[pkg] = importlib.import_module(f"{pkg}.nav.obj_env").SoonObjectNavBatch.__new__(
            importlib.import_module(f"{pkg}.nav.obj_env").SoonObjectNavBatch)
        soon[pkg].graphs = env.graphs
    g = next(iter(jenv.graphs.values()))
    a, b = g.node_ids[0], g.node_ids[3]
    corners = {"left_top": (0.3, 0.3), "right_top": (0.7, 0.3), "right_bottom": (0.7, -0.1),
               "left_bottom": (0.3, -0.1)}
    gt = {"scan": next(iter(jenv.graphs)), "path": g.path(a, b), "bboxes": {b: {
        "heading": 0.5, "elevation": 0.1,
        "target": {k: {"heading": h, "elevation": e} for k, (h, e) in corners.items()}}}}
    for pred_path in ([[a]] + [[vp] for vp in g.path(a, b)], [[a]]):
        for h, e in ((0.5, 0.1), (2.0, 0.1)):
            assert_same(soon["vln_bevbert_tpu"].eval_soon_item(pred_path, h, e, gt),
                        soon["vln_bevbert_tpu_torch"].eval_soon_item(pred_path, h, e, gt),
                        "soon scores")
    quad = [(0, 0), (2, 0), (2, 2), (0, 2)]
    jmod, pmod = pair("nav.obj_env")
    for pt in ((1, 1), (3, 1), (0, 0)):
        for q in (quad, quad[::-1]):
            assert jmod.point_in_convex_quad(pt, q) == pmod.point_in_convex_quad(pt, q)


def check_obj_pretrain_loader(tmp_path):
    """Object pretraining batches (mlm, mrc, sap, og, masksem) of the two
    loaders over ``TextPathData`` with an ``ObjectDB``."""
    batches = {}
    for pkg in ("vln_bevbert_tpu", "vln_bevbert_tpu_torch"):
        cfg_mod = importlib.import_module(f"{pkg}.configs")
        pathdata = importlib.import_module(f"{pkg}.data.pathdata")
        loader = importlib.import_module(f"{pkg}.data.loader")
        obj_env = importlib.import_module(f"{pkg}.nav.obj_env")
        cfg = cfg_mod.load_config(cfg_mod.PretrainConfig, config_file(tmp_path, pretrain_config),
                                  train_batch_size=2, num_workers=0)
        cfg.model.obj_feat_size, cfg.model.obj_prob_size, cfg.shapes.max_objects = 6, 5, 3
        cfg.tasks, cfg.mix_ratio = ("mlm", "mrc", "sap", "og", "masksem"), (1, 1, 1, 1, 1)
        graphs, cands, annos, obj_data, _ = object_world(pkg, tmp_path, 6, 5)
        dicts = feature_dicts(graphs, feat=cfg.model.image_feat_size,
                              grid=cfg.model.bev_grid_feat_size, hw=cfg.shapes.grid_hw,
                              views=cfg.shapes.num_views)
        db = pathdata.TextPathData(
            annos, graphs, cands,
            **dbs_of(pkg, dicts, ("view_db", "grid_db", "depth_db", "sem_db")),
            obj_db=obj_env.ObjectDB(obj_data), image_feat_size=cfg.model.image_feat_size,
            obj_feat_size=6, obj_prob_size=5, max_objects=3,
            max_txt_len=cfg.shapes.max_txt_len, bev_dim=cfg.model.bev_dim,
            bev_res=cfg.model.bev_res, num_views=cfg.shapes.num_views, dataset="reverie")
        pl = loader.PretrainLoader(db, cfg, seed=11)
        batches[pkg] = [pl.build_batch(step, task=t) for step, t in enumerate(cfg.tasks)]
    for _, batch in batches["vln_bevbert_tpu"]:
        assert batch["traj_obj_fts"].shape[2:] == (3, 6)
    assert batches["vln_bevbert_tpu"][1][1]["obj_mrc_masks"].any()
    assert_same(batches["vln_bevbert_tpu"], batches["vln_bevbert_tpu_torch"], "batches")


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


def ce_pair(name):
    return pair(f"ce.{name}")


def check_ce_geometry_and_graph(tmp_path):
    jgeo, pgeo = ce_pair("geometry_ce")
    rng = np.random.default_rng(4)
    for _ in range(5):
        h = float(rng.uniform(0, 7))
        q = jgeo.quaternion_from_heading(h)
        assert_same(q, pgeo.quaternion_from_heading(h))
        assert jgeo.heading_from_quaternion(q) == pgeo.heading_from_quaternion(q)
        pos, ang, dis = rng.normal(size=3), rng.uniform(0, 6, 4), rng.uniform(0.25, 3, 4)
        assert_same(jgeo.estimate_cand_pos(pos, q, ang, dis), pgeo.estimate_cand_pos(pos, q, ang, dis))
        for clock in (False, True):
            a, b = rng.normal(size=3), rng.normal(size=3)
            assert jgeo.rel_pos_features_ce(a, b, h, 0.1, clock, clock) == \
                pgeo.rel_pos_features_ce(a, b, h, 0.1, clock, clock)
    maps = []
    for pkg_map in ce_pair("graph_map"):
        m = pkg_map.CEGraphMap(loc_noise=0.5, ghost_aug=0.3, rng=np.random.default_rng(9))
        draw = np.random.default_rng(8)
        prev, pos = None, np.zeros(3)
        for step in range(5):
            ori = jgeo.quaternion_from_heading(float(draw.uniform(0, 6)))
            cur, cvp, cpos = m.identify_node(pos, ori, draw.uniform(0, 6, 4), draw.uniform(0.5, 2, 4))
            m.update_graph(prev, step + 1, cur, pos, None, cvp, cpos,
                           [draw.normal(size=3) for _ in cvp])
            m.set_node_pc(cur, step)
            if m.ghost_mean_pos:
                ghost = sorted(m.ghost_mean_pos)[0]
                pos = m.ghost_mean_pos[ghost].copy()
                m.delete_ghost(ghost)
            prev = cur
        vps = [None] + list(m.node_pos) + list(m.ghost_aug_pos)
        maps.append({
            "nodes": m.node_pos, "ghosts": m.ghost_mean_pos, "aug": m.ghost_aug_pos,
            "fronts": m.ghost_fronts, "embeds": {v: m.get_node_embeds(v) for v in vps[2:]},
            "pos_fts": m.get_pos_fts(cur, pos, ori, vps), "neighbors": m.get_neighbors(cur, pos, ori),
            "front_dist": [m.front_to_ghost_dist(g) for g in m.ghost_aug_pos],
            "pc_steps": [m.gather_pc_steps(cur, k) for k in (0, 1, 2)],
            "dist": [m.graph.distance(a, b) for a in m.node_pos for b in m.node_pos],
        })
    assert maps[0]["ghosts"] and maps[0]["fronts"]
    assert_same(maps[0], maps[1], "ce graph map")


def check_ce_env_and_control(tmp_path):
    envs, runs = {}, {}
    for pkg in ("vln_bevbert_tpu", "vln_bevbert_tpu_torch"):
        env_mod = importlib.import_module(f"{pkg}.ce.env")
        ctrl_mod = importlib.import_module(f"{pkg}.ce.control")
        eps = env_mod.make_synthetic_ce_episodes(np.random.default_rng(2), n=5)
        env = envs[pkg] = env_mod.SyntheticContinuousEnv(
            eps, batch_size=2, grid_hw=3, grid_feat_size=8, view_feat_size=6,
            depth_feat_shape=(2, 2, 2), obstacles=[(1.0, 1.0, 0.6), (4.0, 3.0, 1.0)])
        out = {"episodes": [vars(e) for e in eps], "reset": env.reset()}
        ctrl = ctrl_mod.LowLevelController(env, np.random.default_rng(6))
        visited = []
        for slot in range(2):
            start = env.positions[slot].copy()
            goal = env.batch[slot].goal
            visited.append(ctrl.execute(slot, {
                "act": 4, "back_path": [("0", start), ("1", start + [0.5, 0, 0.5])],
                "front_pos": start, "ghost_pos": goal, "tryout": True}))
            visited.append(ctrl.execute(slot, {"act": 0, "back_path": None,
                                               "stop_pos": start, "tryout": False}))
        out.update(visited=visited, positions=env.get_positions(), headings=env.get_headings(),
                   collided=[env.previous_step_collided(s) for s in range(2)],
                   obs=env.observations(), ctrl_draw=ctrl.rng.random(),
                   metrics=[env.eval_episode(s, [env.batch[s].start_pos, *visited[2 * s]])
                            for s in range(2)],
                   dists=env.dists_to_goal(0, [np.zeros(3), np.ones(3)]),
                   shared=env_mod.compute_ce_episode_metrics(
                       np.stack(visited[0]), env.batch[0].gt_positions,
                       lambda p: float(np.linalg.norm(p))))
        runs[pkg] = out
    assert any(runs["vln_bevbert_tpu"]["collided"]) or len(runs["vln_bevbert_tpu"]["visited"][0]) > 4
    assert_same(runs["vln_bevbert_tpu"], runs["vln_bevbert_tpu_torch"], "ce env")
    jctl, pctl = ce_pair("control")
    for ang in (0.1, 3.0, -2.0):
        pos, tgt = np.zeros(3), np.array([1.0, 0.0, -2.0])
        assert jctl.rel_angle_dist(pos, tgt, ang) == pctl.rel_angle_dist(pos, tgt, ang)


def check_ce_dataset(tmp_path):
    import gzip

    episodes = [{
        "episode_id": i, "trajectory_id": i, "scene_id": f"mp3d/S{i % 2}/S{i % 2}.glb",
        "start_position": [float(i), 0.1, -1.0], "start_rotation": [0.0, 0.3 * i, 0.0, 1.0],
        "goals": [{"position": [2.0 + i, 0.1, -3.0], "radius": 3.0}] if i else [],
        "reference_path": [[float(i), 0.1, -1.0], [1.0, 0.1, -2.0], [2.0 + i, 0.1, -3.0]],
        "instruction": {"instruction_text": "walk on", "instruction_tokens": [5, 6, 7 + i],
                        "language": "en-US" if i else "hi-IN"},
    } for i in range(3)]
    path = tmp_path / "val_seen_guide.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"episodes": episodes}, f)
    gt = tmp_path / "val_seen_guide_gt.json.gz"
    with gzip.open(gt, "wt") as f:
        json.dump({"1": {"locations": [[1.0, 0.1, -1.0], [2.0, 0.1, -2.0], [3.0, 0.1, -3.0]]}}, f)
    out = []
    for mod in ce_pair("dataset"):
        loads = [mod.load_vlnce_episodes(str(path)),
                 mod.load_vlnce_episodes(str(path), tokenizer=lambda s: [len(s)], scenes=["S1"]),
                 mod.load_rxr_episodes(str(tmp_path / "val_seen_{role}.json.gz"),
                                       languages=["en-US"])]
        gt_map = mod.load_gt_paths(str(tmp_path / "val_seen_{role}_gt.json.gz"))
        loads.append(mod.apply_gt_paths(loads[0], gt_map))
        out.append([[vars(e) for e in eps] for eps in loads] + [gt_map])
    assert len(out[0][2]) == 2 and len(out[0][3][1]["gt_positions"]) == 3
    assert_same(out[0], out[1], "ce episodes")


def check_ce_waypoint_nms(tmp_path):
    jwp, pwp = ce_pair("waypoint_predictor")
    rng = np.random.default_rng(0)
    heat = rng.normal(0, 3, (3, jwp.NUM_ANGLES, jwp.NUM_CLASSES)).astype(np.float32)
    assert_same(jwp.ring_neighbor_bias(), pwp.ring_neighbor_bias())
    for sigma in ((7.0, 5.0), (2.0, 1.0)):
        assert_same(jwp.nms_peaks(np.exp(heat), 4, sigma), pwp.nms_peaks(np.exp(heat), 4, sigma))
    peaks = jwp.heatmap_to_peaks(heat)
    assert_same(peaks, pwp.heatmap_to_peaks(heat))
    assert_same(jwp.sample_waypoints(heat, peaks, np.random.default_rng(1)),
                pwp.sample_waypoints(heat, peaks, np.random.default_rng(1)), "samples")
    for in_train in (False, True):
        assert_same(
            jwp.extract_waypoints(heat, 5, 4, in_train, np.random.default_rng(3)),
            pwp.extract_waypoints(heat, 5, 4, in_train, np.random.default_rng(3)), "waypoints")


def check_mlabel(tmp_path):
    jml, pml = pair("utils.mlabel")
    rng = np.random.default_rng(0)
    labels = rng.uniform(size=(80, 6)) < 0.25
    labels[:, 4] = True  # one label value only: no AUC
    scores = np.round(rng.uniform(size=(80, 6)) + 0.3 * labels, 2)
    assert_same(pml.multilabel_report(scores, labels, 0.4, pml.MP3D_CATEGORIES[:6]),
                jml.multilabel_report(scores, labels, 0.4, jml.MP3D_CATEGORIES[:6]))
    for k in range(6):
        assert_same(pml.binary_auc(scores[:, k], labels[:, k]),
                    jml.binary_auc(scores[:, k], labels[:, k]))


def check_npz_store(tmp_path):
    """Append with FIFO eviction, reopen (resuming from the highest id),
    import a foreign file under a fresh id, in both packages: the same file
    names and the same items."""
    rng = np.random.default_rng(0)
    items = [{"a": rng.normal(size=(3, 4)).astype(np.float16),
              "b": np.arange(i + 2, dtype=np.int32), "m": rng.uniform(size=5) < 0.5}
             for i in range(5)]
    foreign = str(tmp_path / "foreign.npz")
    np.savez_compressed(foreign, **items[0])
    seen = {}
    for pkg in ("vln_bevbert_tpu", "vln_bevbert_tpu_torch"):
        store_mod = importlib.import_module(f"{pkg}.utils.npz_store")
        d = str(tmp_path / pkg)
        store = store_mod.NpzShardStore(d, capacity=3)
        names = [store.append(item) for item in items[:4]]
        store = store_mod.NpzShardStore(d, capacity=3)
        names += [store.append(items[4]), store.import_file(foreign)]
        seen[pkg] = (names, sorted(os.listdir(d)), [store.get(i) for i in range(len(store))])
    assert_same(seen["vln_bevbert_tpu_torch"], seen["vln_bevbert_tpu"], "npz store")
    assert os.path.exists(foreign) and len(seen["vln_bevbert_tpu"][1]) == 3


def check_surgery(tmp_path):
    from test_surgery import _small_cfg, synthetic_reference_sd

    jsg, psg = pair("models.surgery")
    ref = synthetic_reference_sd(_small_cfg(), np.random.default_rng(0))
    lx = {"module." + k.replace("bert.lang_encoder.layer.", "bert.encoder.layer."): v
          for k, v in ref.items()}
    for sd in (ref, lx):
        assert_same(psg.reference_ckpt_to_tree(psg.lxmert_surgery(sd), 24),
                    jsg.reference_ckpt_to_tree(jsg.lxmert_surgery(sd), 24))
    hf = {k.replace("bert.lang_encoder.layer.", "encoder.layer.").removeprefix("bert."): v
          for k, v in ref.items() if k.startswith(("bert.embeddings.", "bert.lang_encoder."))}
    assert_same(psg.roberta_surgery(hf), jsg.roberta_surgery(hf))
    for prefix in ("bert.", "roberta."):
        sd = {prefix + k: v for k, v in hf.items()}
        assert_same(psg.hf_bert_to_tree(sd, 2), jsg.hf_bert_to_tree(sd, 2))


def check_obs_transforms(tmp_path):
    jot, pot = ce_pair("obs_transforms")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (2, 30, 26, 3), dtype=np.uint8)
    depth = rng.uniform(0, 1, (2, 30, 26, 1)).astype(np.float32)
    for size in (16, (20, 24), (34, 30)):
        assert_same(pot.center_crop(img, size), jot.center_crop(img, size))
        assert_same(pot.resize(depth, size), jot.resize(depth, size))
    faces = {f"rgb_{i}": rng.integers(0, 256, (8, 8, 3), dtype=np.uint8) for i in range(6)}
    faces.update({f"depth_{i}": rng.uniform(0, 1, (8, 8, 1)).astype(np.float32) for i in range(6)})
    outs = []
    for mod in (jot, pot):
        transforms = [
            mod.CubeMap2Equirect([f"rgb_{i}" for i in range(6)] + [f"depth_{i}" for i in range(6)],
                                 (12, 24), target_uuids=["rgb", "depth"]),
            mod.ResizerPerSensor([("rgb", 10), ("depth", (6, 12))]),
            mod.CenterCropperPerSensor([("rgb", 8)]),
        ]
        outs.append(mod.apply_obs_transforms(transforms, [dict(faces), dict(faces)]))
        outs[-1].append(mod.cube_face_directions("left", (4, 5)))
    assert outs[0][0]["rgb"].shape == (8, 8, 3) and outs[0][0]["depth"].shape == (6, 12, 1)
    assert_same(outs[0], outs[1], "obs transforms")


def check_sensors(tmp_path):
    runs = []
    for pkg in ("vln_bevbert_tpu", "vln_bevbert_tpu_torch"):
        sensors = importlib.import_module(f"{pkg}.ce.sensors")
        env_mod = importlib.import_module(f"{pkg}.ce.env")
        env = env_mod.SyntheticContinuousEnv(
            env_mod.make_synthetic_ce_episodes(np.random.default_rng(2), n=3), batch_size=2,
            grid_hw=2, grid_feat_size=4, view_feat_size=4, depth_feat_shape=(2, 1, 1))
        obs = env.reset()
        env.teleport(1, env.batch[1].gt_positions[1] + 0.1)
        obs = sensors.attach_sensors(env, env.observations())
        ep = env.batch[0]
        runs.append([
            [{k: ob[k] for k in ("globalgps", "heading_sensor", "shortest_path_sensor",
                                 "progress")} for ob in obs],
            sensors.global_gps(obs[0]["position"], 2), sensors.rxr_instruction(ep),
            sensors.render_top_down_map(ep.gt_positions[:3], ep.gt_positions, ep.goal,
                                        resolution=48)])
    assert_same(runs[0], runs[1], "sensors")


def check_habitat_binding(tmp_path):
    """Reset, observation assembly, the ring render's pose restore, control
    with a collision, teleport, the oracle and episode metrics over the JAX
    tests' fake habitat, without towers. The port's binding also has the
    depth contract (``test_torch_habitat.py`` holds it with towers)."""
    import sys
    import types

    from test_binding_mocks import _episode, _FakeHabitatEnv

    runs = []
    fake = types.ModuleType("habitat")
    fake.Env = _FakeHabitatEnv
    saved = sys.modules.get("habitat")
    sys.modules["habitat"] = fake
    try:
        for pkg in ("vln_bevbert_tpu", "vln_bevbert_tpu_torch"):
            hb = importlib.import_module(f"{pkg}.ce.habitat_binding")
            env = hb.HabitatContinuousEnv(None, [_episode(0), _episode(1, start=(1.0, 0.0, 0.5))],
                                          batch_size=2, num_views=4, grid_hw=2)
            out = {"reset": env.reset(), "pose": (env.positions, env.headings)}
            env.rotate(0, env.turn_unit)
            out["free"] = env.forward_step(0)
            env.envs[1].sim.wall_z = 0.4
            out["wall"] = [env.forward_step(1), env.previous_step_collided(1)]
            env.teleport(0, [1.0, 0.0, -1.0], heading=1.0)
            out.update(obs=env.observations(), pose_after=(env.get_positions(),
                                                           env.get_headings()),
                       oracle=[env.dist_to_goal(1), env.dists_to_goal(0, [[2, 0, -2], [0, 0, 0]])],
                       metrics=env.eval_episode(0, np.asarray(env.batch[0].reference_path)),
                       size=env.size())
            runs.append(out)
            if pkg.endswith("torch"):
                assert env.depth_feat_shape == (2, 2) and env.view_feat_size is None
    finally:
        if saved is None:
            del sys.modules["habitat"]
        else:
            sys.modules["habitat"] = saved
    assert runs[0]["wall"] == [True, True]
    assert_same(runs[0], runs[1], "habitat binding")


def check_mattersim_binding(tmp_path):
    import sys
    import types

    from test_binding_mocks import _FakeMatterSim

    fake = types.ModuleType("MatterSim")
    fake.Simulator = _FakeMatterSim
    saved = sys.modules.get("MatterSim")
    sys.modules["MatterSim"] = fake
    runs = []
    try:
        for mod in pair("nav.mattersim_binding"):
            sim = mod.MatterSimSimulator("/conn", scan_data_dir="/scans")
            sim.new_episode("scanA", "vp1", 1.25)
            state = sim.get_state()
            runs.append([sim.sim.calls, (state.scan, state.viewpoint, state.heading,
                                         state.elevation),
                         [v.viewpointId for v in sim.navigable_locations()]])
    finally:
        if saved is None:
            del sys.modules["MatterSim"]
        else:
            sys.modules["MatterSim"] = saved
    assert runs[0] == runs[1]


def check_precompute_host(tmp_path):
    jpl, ppl = pair("precompute.pipeline")
    vps = {"s1": ["a", "b"], "s2": ["c"]}
    frames = [list(mod.SyntheticImageSource(vps, image_hw=32, grid_hw=2, seed=4))
              for mod in (jpl, ppl)]
    assert_same(frames[0], frames[1], "synthetic frames")
    encoded = []
    for mod, pkg_frames in zip((jpl, ppl), frames):
        enc = mod.RandomProjectionEncoder(grid_hw=2, seed=1)
        encoded.append([(enc.encode_views(f["views36"]), enc.encode_grids(f["ring12"]))
                        for _, _, f in pkg_frames])
    assert_same(encoded[0], encoded[1], "projection encoder")


CHECKS = {"configs": check_configs, "synthetic_world": check_synthetic_world,
          "nav_env": check_nav_env, "pretrain_loader": check_pretrain_loader,
          "dtw_and_floyd": check_dtw_and_floyd, "obj_env": check_obj_env,
          "obj_pretrain_loader": check_obj_pretrain_loader,
          "ce_geometry_and_graph": check_ce_geometry_and_graph,
          "ce_env_and_control": check_ce_env_and_control, "ce_dataset": check_ce_dataset,
          "ce_waypoint_nms": check_ce_waypoint_nms, "mlabel": check_mlabel,
          "surgery": check_surgery, "npz_store": check_npz_store,
          "obs_transforms": check_obs_transforms, "sensors": check_sensors,
          "habitat_binding": check_habitat_binding, "mattersim_binding": check_mattersim_binding,
          "precompute_host": check_precompute_host}


@pytest.mark.parametrize("name", list(CHECKS))
def test_host_module_matches_its_jax_original(name, tmp_path):
    CHECKS[name](tmp_path)


def test_big_row_store_drops_a_stale_pack(tmp_path):
    """A store packed with small rows, then rewritten with rows too big to
    pack: the port's ``build_pack`` removes the old sidecar, so the store
    serves the new rows. The JAX original returns None with the sidecar left
    in place, and the process that packed it goes on serving the old rows."""
    import h5py

    served = {}
    for pkg in ("vln_bevbert_tpu", "vln_bevbert_tpu_torch"):
        fdb = importlib.import_module(f"{pkg}.data.feature_db")
        path = str(tmp_path / f"{pkg}.hdf5")
        with h5py.File(path, "w") as f:
            for key in ("s_a", "s_b"):
                f[key] = np.ones(4, np.float32)
        db = fdb.H5FeatureDB(path)
        assert db.build_pack() is not None
        np.testing.assert_array_equal(db.get("s", "a"), np.ones(4))  # from the pack
        db.close()
        big = np.full(fdb.H5FeatureDB.PACK_MAX_ROW_BYTES // 4 + 1, 2.0, np.float32)
        with h5py.File(path, "w") as f:
            for key in ("s_a", "s_b"):
                f[key] = big
        assert db.build_pack() is None
        served[pkg] = (db.get("s", "b"), [os.path.exists(p) for p in db.pack_paths])
        db.close()
    row, left = served["vln_bevbert_tpu_torch"]
    np.testing.assert_array_equal(row, big)
    assert left == [False, False]
    row, left = served["vln_bevbert_tpu"]
    assert row.shape == (4,) and left == [True, True]


@pytest.mark.parametrize("name", COPIED)
def test_copied_module_keeps_the_originals_public_names(name):
    jax_mod, port_mod = pair(name)
    public = {k for k in vars(jax_mod) if not k.startswith("_")
              and getattr(vars(jax_mod)[k], "__module__", jax_mod.__name__) == jax_mod.__name__}
    missing = public - set(vars(port_mod)) - LEFT_OUT.get(name, set())
    assert not missing, f"{name}: {sorted(missing)}"


def test_port_loads_nothing_of_the_jax_package(tmp_path):
    """Every module of the port and chip_smoke import, then the CPU CLI paths
    run (eval, pretraining, pretraining over ``--data_root`` with validation
    and ``ralamb+lookahead`` under gradient accumulation, fine-tuning,
    REVERIE fine-tuning with its object slots, CE training with its
    evaluation, CE DAgger with the PREVALENT policy through a 2-worker
    env pool, and one ``--habitat_config`` CE iteration over chip_smoke's
    stand-in ``habitat`` with small CLIP and DDPPO checkpoints) at a tiny
    configuration, in one process that loads no JAX module and no module of
    the JAX package."""
    from test_torch_ce_cli import ce_configs
    from test_torch_finetune_cli import finetune_config
    from test_torch_pretrain_cli import write_data_root

    (tmp_path / "ce").mkdir()
    pt = config_file(tmp_path, pretrain_config)
    real_cfg = json.loads(open(pt).read())
    real_cfg["optim"].update(optim="ralamb+lookahead", gradient_accumulation_steps=2)
    real_cfg["valid_steps"] = 2
    (tmp_path / "real.json").write_text(json.dumps(real_cfg))
    write_data_root(tmp_path / "data", pt)
    ce_cfg = ce_configs(tmp_path / "ce")[1]
    hab_cfg = json.loads(open(ce_cfg).read())
    hab_cfg["model"]["bev_grid_feat_size"] = 64  # the small CLIP tower's width
    (tmp_path / "hab.json").write_text(json.dumps(hab_cfg))

    code = (
        "import importlib, json, pkgutil, sys\n"
        "import vln_bevbert_tpu_torch as port\n"
        "names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "from vln_bevbert_tpu_torch.cli import finetune, pretrain\n"
        "out, tiny, ft, pt, ce_cfg, real_cfg, hab_cfg = sys.argv[1:8]\n"
        "ev = finetune.main(['--synthetic', '--test', '--device', 'cpu', '--config', tiny,\n"
        "                    '--output_dir', out + '/eval'])\n"
        "pre = pretrain.main(['--synthetic', '--device', 'cpu', '--num_steps', '2',\n"
        "                     '--batch_size', '2', '--config', pt, '--output_dir', out + '/pt'])\n"
        "real = pretrain.main(['--data_root', out + '/data', '--device', 'cpu', '--num_steps',\n"
        "                      '2', '--batch_size', '2', '--tasks', 'sap.1', '--config',\n"
        "                      real_cfg, '--output_dir', out + '/real'])\n"
        "logged = [json.loads(line) for line in open(out + '/real/metrics.jsonl')]\n"
        "val = [r['val_unseen/sap/loss'] for r in logged if 'val_unseen/sap/loss' in r]\n"
        "ckpt = __import__('torch').load(out + '/real/ckpt_2', weights_only=True)\n"
        "tr = finetune.main(['--synthetic', '--device', 'cpu', '--iters', '1', '--config', ft,\n"
        "                    '--output_dir', out + '/ft'])\n"
        "rv_cfg = json.load(open(ft))\n"
        "rv_cfg['shapes']['max_objects'] = 3\n"
        "json.dump(rv_cfg, open(out + '/rv.json', 'w'))\n"
        "rv = finetune.main(['--synthetic', '--dataset', 'reverie', '--device', 'cpu',\n"
        "                    '--iters', '1', '--config', out + '/rv.json',\n"
        "                    '--output_dir', out + '/rv'])\n"
        "dump = json.load(open(out + '/rv/preds_val_unseen_1.json'))\n"
        "from vln_bevbert_tpu_torch.cli import ce_train\n"
        "ce = ce_train.main(['--device', 'cpu', '--config', ce_cfg, '--allow_random_frozen',\n"
        "                    '--iters', '1', '--log_every', '1', '--n_episodes', '2',\n"
        "                    '--output_dir', out + '/ce'])\n"
        "dg = ce_train.main(['--device', 'cpu', '--config', ce_cfg, '--allow_random_frozen',\n"
        "                    '--trainer', 'dagger', '--policy', 'prevalent', '--dagger_iters',\n"
        "                    '1', '--update_size', '2', '--dagger_epochs', '1', '--n_episodes',\n"
        "                    '2', '--num_env_workers', '2', '--output_dir', out + '/dagger'])\n"
        "import torch\n"
        "sys.modules['habitat'] = chip_smoke.habitat_stand_in()\n"
        "hab_yaml = chip_smoke.write_habitat_config(out + '/hab.yaml', rgb_hw=64, depth_hw=256,\n"
        "                                           episodes=2)\n"
        "torch.save(chip_smoke.hf_clip_state_dict(64, 128, 2, 16, 64), out + '/clip.pt')\n"
        "torch.save(chip_smoke.ddppo_checkpoint(8, (1, 1, 1, 1), 32), out + '/ddppo.pth')\n"
        "hab = ce_train.main(['--device', 'cpu', '--config', hab_cfg, '--allow_random_frozen',\n"
        "                     '--habitat_config', hab_yaml, '--clip_ckpt', out + '/clip.pt',\n"
        "                     '--ddppo_ckpt', out + '/ddppo.pth', '--iters', '1',\n"
        "                     '--log_every', '1', '--output_dir', out + '/hab'])\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps({'bad': bad, 'names': names, 'sr': [ev['val_unseen']['sr'],\n"
        "                  tr['val_unseen']['sr'], rv['val_unseen']['sr'],\n"
        "                  rv['val_unseen']['rgs'], rv['val_unseen']['rgspl'],\n"
        "                  100 * ce['success'], 100 * hab['success']],\n"
        "                  'loss': list(pre), 'pred_obj': all('predObjId' in p for p in dump),\n"
        "                  'real': list(real), 'val': val, 'count': ckpt['opt_state']['count'],\n"
        "                  'slow': 'lookahead_0' in ckpt['opt_state'],\n"
        "                  'dagger': dg['collected']}))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path), config_file(tmp_path, _tiny_config),
         config_file(tmp_path, finetune_config), pt, ce_cfg, str(tmp_path / "real.json"),
         str(tmp_path / "hab.json")],
        capture_output=True, text=True, timeout=400, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert {"vln_bevbert_tpu_torch._build", "vln_bevbert_tpu_torch.data.feature_db",
            "vln_bevbert_tpu_torch.ce.agent", "vln_bevbert_tpu_torch.cli.ce_train",
            "vln_bevbert_tpu_torch.native", "vln_bevbert_tpu_torch.nav.env",
            "vln_bevbert_tpu_torch.nav.obj_env", "vln_bevbert_tpu_torch.ce.dagger",
            "vln_bevbert_tpu_torch.ce.env_pool", "vln_bevbert_tpu_torch.nav.recollection",
            "vln_bevbert_tpu_torch.models.legacy",
            "vln_bevbert_tpu_torch.utils.npz_store", "vln_bevbert_tpu_torch.models.clip",
            "vln_bevbert_tpu_torch.models.depth_encoder",
            "vln_bevbert_tpu_torch.ce.habitat_binding",
            "vln_bevbert_tpu_torch.precompute.pipeline"} <= set(out["names"])
    assert all(0.0 <= sr <= 100.0 for sr in out["sr"]) and out["loss"] and out["pred_obj"]
    assert out["real"] and len(out["val"]) == 1 and np.isfinite(out["val"][0])
    assert out["count"] == 1 and out["slow"]  # 2 steps of accumulation: one update
    assert out["dagger"] == [2]
