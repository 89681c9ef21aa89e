"""Discrete-environment evaluation CLI (port of the ``--test`` path of
``vln_bevbert_tpu/cli/finetune.py``).

    python -m vln_bevbert_tpu_torch.cli.finetune --synthetic --test
    python -m vln_bevbert_tpu_torch.cli.finetune --data_root datasets/R2R --test

Arguments are the JAX CLI's (``parse_args`` is reused) plus ``--device``
(default ``cuda``; there is no CPU fallback: a CUDA device that is missing
raises). ``--synthetic`` builds the JAX CLI's synthetic world in memory, with
``DictFeatureDB`` stores and no HDF5. Parameters are random, from a seeded
generator. Training, object-grounding datasets (reverie, soon) and
checkpoint loading are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Dict

import numpy as np
import torch

from vln_bevbert_tpu.cli import finetune as jax_cli
from vln_bevbert_tpu.configs import FinetuneConfig, load_config
from vln_bevbert_tpu.data.feature_db import DictFeatureDB, H5FeatureDB
from vln_bevbert_tpu.data.loader import make_synthetic_annotations
from vln_bevbert_tpu.data.nav_graph import (
    build_scanvp_cands,
    load_nav_graphs,
    write_synthetic_connectivity,
)
from vln_bevbert_tpu.nav.env import R2RNavBatch
from vln_bevbert_tpu.utils.logging import MetricLogger

from ..nav.agent import GMapNavAgent


def parse_args(argv=None):
    own = argparse.ArgumentParser(add_help=False)
    own.add_argument("--device", default="cuda",
                     help="torch device for the model and the kernels")
    ours, rest = own.parse_known_args(argv)
    args = jax_cli.parse_args(rest)
    args.device = ours.device
    return args


def synthetic_feature_dbs(rng: np.random.Generator, scan_viewpoints,
                          image_feat_size: int, grid_feat_size: int,
                          grid_hw: int, num_views: int, num_sem: int = 40):
    """In-memory twin of ``data/feature_db.py:write_synthetic_features``:
    the same draws in the same order, stored as the HDF5 readers return them
    (views and depth float32, grids float16, semantic labels uint8)."""
    views, grids, depths, sems = {}, {}, {}, {}
    for scan, vps in scan_viewpoints.items():
        for vp in vps:
            key = f"{scan}_{vp}"
            views[key] = rng.normal(size=(36, image_feat_size)).astype(np.float32)
            grids[key] = rng.normal(
                size=(num_views, grid_hw * grid_hw, grid_feat_size)
            ).astype(np.float16)
            depths[key] = rng.uniform(
                0.02, 0.9, (num_views, grid_hw, grid_hw)
            ).astype(np.float16).astype(np.float32)
            sems[key] = rng.integers(
                0, num_sem, (num_views, grid_hw, grid_hw)
            ).astype(np.uint8)
    return dict(view_db=DictFeatureDB(views), grid_db=DictFeatureDB(grids),
                depth_db=DictFeatureDB(depths), sem_db=DictFeatureDB(sems))


def build_synthetic_envs(cfg: FinetuneConfig, args) -> Dict[str, R2RNavBatch]:
    """The JAX CLI's synthetic world (3 scans x 16 nodes, 16 items per eval
    split), with the features in memory."""
    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory() as conn:
        write_synthetic_connectivity(conn, rng, n_scans=3, n_nodes=16)
        graphs = load_nav_graphs(conn)
    cands = build_scanvp_cands(graphs)
    dbs = synthetic_feature_dbs(
        rng, {s: g.node_ids for s, g in graphs.items()},
        image_feat_size=cfg.model.image_feat_size,
        grid_feat_size=cfg.model.bev_grid_feat_size,
        grid_hw=cfg.shapes.grid_hw, num_views=cfg.shapes.num_views,
    )
    del dbs["sem_db"]  # navigation reads no semantics
    make_synthetic_annotations(graphs, rng, n_items=64)  # the train split's draws
    splits = args.val_splits.split(",") if args.val_splits else ["val_unseen"]
    val_annos = {s: make_synthetic_annotations(graphs, rng, n_items=16) for s in splits}
    return {
        name: R2RNavBatch(annos, graphs, cands, batch_size=cfg.batch_size,
                          image_feat_size=cfg.model.image_feat_size,
                          seed=args.seed + 1 + i, name=name, **dbs)
        for i, (name, annos) in enumerate(val_annos.items())
    }


class NumpyCastFeatureDB:
    """An HDF5 feature store whose rows are cast by numpy.

    ``H5FeatureDB`` casts float16 rows to float32 through JAX, so the reader
    wrapped here keeps the stored dtype and ``get`` casts to ``db.dtype``."""

    def __init__(self, db: H5FeatureDB):
        import h5py

        with h5py.File(db.path, "r") as f:
            stored = f[next(iter(f.keys()))].dtype
        self.dtype = np.dtype(db.dtype)
        self.db = H5FeatureDB(db.path, dtype=stored, max_cache=db.max_cache)

    def get(self, scan: str, viewpoint: str) -> np.ndarray:
        return self.db.get(scan, viewpoint).astype(self.dtype, copy=False)

    def __contains__(self, key: str) -> bool:
        return key in self.db


def build_envs(cfg: FinetuneConfig, args) -> Dict[str, R2RNavBatch]:
    """The JAX CLI's eval envs for ``--data_root``, reading through
    ``NumpyCastFeatureDB``; the envs of a split share their stores."""
    _, val_envs, _ = jax_cli.build_envs(cfg, args)
    readers: Dict[int, NumpyCastFeatureDB] = {}
    for env in val_envs.values():
        for name in ("view_db", "grid_db", "depth_db"):
            db = getattr(env.env, name)
            if db is not None:
                if id(db) not in readers:
                    readers[id(db)] = NumpyCastFeatureDB(db)
                setattr(env.env, name, readers[id(db)])
    return val_envs


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available")
    return device


def build(args):
    """The config, the eval envs by split, and an agent with random
    parameters on ``args.device``."""
    if not args.test:
        raise NotImplementedError("training is not ported yet: pass --test")
    if args.dataset in ("reverie", "soon"):
        raise NotImplementedError("object-grounding datasets are not ported yet")
    if args.pretrain_ckpt:
        raise NotImplementedError("checkpoint loading is not ported yet")
    device = resolve_device(args.device)
    # bf16 GEMMs accumulate in float32 end to end, as the JAX einsums do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    overrides = {"dataset": args.dataset, "seed": args.seed,
                 "output_dir": args.output_dir}
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    cfg = load_config(FinetuneConfig, args.config, **overrides)
    if args.dataset == "rxr":
        cfg.model.lang_bert_name = "xlm-roberta-base"
        cfg.model.vocab_size = 250002
        cfg.expert_policy = "ndtw"
    if args.expert_policy:
        cfg.expert_policy = args.expert_policy
    if args.act_visited_nodes:
        cfg.act_visited_nodes = True

    if args.synthetic or not args.data_root:
        val_envs = build_synthetic_envs(cfg, args)
    else:
        val_envs = build_envs(cfg, args)
    agent = GMapNavAgent(cfg, next(iter(val_envs.values())), seed=cfg.seed,
                         device=device)
    agent.init_params()
    return cfg, val_envs, agent


def main(argv=None):
    """Evaluate every split; returns {split: metrics}."""
    cfg, val_envs, agent = build(parse_args(argv))
    os.makedirs(cfg.output_dir, exist_ok=True)
    logger = MetricLogger(cfg.output_dir)
    results = {}
    for tag, env in val_envs.items():
        agent.env = env
        preds = agent.test()
        avg = env.eval_metrics(preds)[0] if env.gt_trajs else {}
        logger.log(0, {f"{tag}/{k}": v for k, v in avg.items()})
        with open(os.path.join(cfg.output_dir, f"preds_{tag}_0.json"), "w") as f:
            json.dump([
                {"instr_id": p["instr_id"],
                 "trajectory": [[vp, 0.0, 0.0] for vp in sum(p["trajectory"], [])]}
                for p in preds
            ], f)
        results[tag] = avg
    return results


if __name__ == "__main__":
    print(json.dumps(main()))
