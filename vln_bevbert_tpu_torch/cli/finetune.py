"""Discrete-environment fine-tuning CLI (port of
``vln_bevbert_tpu/cli/finetune.py``): DAgger training with evaluation every
``log_every`` iterations, best-checkpoint selection on sr+spl of
``val_unseen``, and submission-format prediction dumps.

    python -m vln_bevbert_tpu_torch.cli.finetune --synthetic --iters 3 --log_every 3
    python -m vln_bevbert_tpu_torch.cli.finetune --synthetic --pretrain_ckpt runs/pretrain/ckpt_24
    python -m vln_bevbert_tpu_torch.cli.finetune --synthetic --test --pretrain_ckpt runs/finetune/ckpt_best
    python -m vln_bevbert_tpu_torch.cli.finetune --data_root datasets/R2R --test

Arguments are the JAX CLI's (``parse_args`` is reused) plus ``--device``
(default ``cuda``; there is no CPU fallback: a CUDA device that is missing
raises). ``--synthetic`` builds the JAX CLI's synthetic world in memory, with
``DictFeatureDB`` stores and no HDF5; ``--data_root`` reads HDF5 stores
through ``NumpyCastFeatureDB``. Parameters are random, from a seeded
generator, or transferred from ``--pretrain_ckpt``: a torch checkpoint of
the port's pretraining (``ckpt_<step>``) or fine-tuning (``ckpt_best``,
``ckpt_latest``). Object-grounding datasets (reverie, soon) are not ported
yet.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

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
from ..parallel.train_step import load_checkpoint

Envs = Tuple[R2RNavBatch, Dict[str, R2RNavBatch], Optional[R2RNavBatch]]


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


def build_synthetic_envs(cfg: FinetuneConfig, args) -> Envs:
    """The JAX CLI's synthetic world (3 scans x 16 nodes, 64 train items, 16
    items per eval split, 64 aug items with ``--aug_path``), with the
    features in memory. Returns (train env, eval envs by split, aug env or
    None)."""
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
    train_annos = make_synthetic_annotations(graphs, rng, n_items=64)
    splits = args.val_splits.split(",") if args.val_splits else ["val_unseen"]
    val_annos = {s: make_synthetic_annotations(graphs, rng, n_items=16) for s in splits}

    def make(annos, name, seed):
        return R2RNavBatch(annos, graphs, cands, batch_size=cfg.batch_size,
                           image_feat_size=cfg.model.image_feat_size, seed=seed,
                           name=name, **dbs)

    aug_env = None
    if args.aug_path:
        aug_annos = make_synthetic_annotations(
            graphs, np.random.default_rng(args.seed + 41), n_items=64)
        aug_env = make(aug_annos, "aug", args.seed + 2)
    val_envs = {name: make(annos, name, args.seed + 1 + i)
                for i, (name, annos) in enumerate(val_annos.items())}
    return make(train_annos, "train", args.seed), val_envs, aug_env


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


def build_envs(cfg: FinetuneConfig, args) -> Envs:
    """The JAX CLI's envs for ``--data_root``, reading through
    ``NumpyCastFeatureDB``; envs that shared a store share its reader."""
    train_env, val_envs, aug_env = jax_cli.build_envs(cfg, args)
    readers: Dict[int, NumpyCastFeatureDB] = {}
    for env in (train_env, aug_env, *val_envs.values()):
        if env is None:
            continue
        for name in ("view_db", "grid_db", "depth_db"):
            db = getattr(env.env, name)
            if db is not None:
                if id(db) not in readers:
                    readers[id(db)] = NumpyCastFeatureDB(db)
                setattr(env.env, name, readers[id(db)])
    return train_env, val_envs, aug_env


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available")
    return device


def make_config(args) -> FinetuneConfig:
    """The JAX CLI's config: file, then overrides, then the dataset's
    settings (``vln_bevbert_tpu/cli/finetune.py:258-275``)."""
    overrides = {"dataset": args.dataset, "seed": args.seed, "output_dir": args.output_dir}
    if args.iters:
        overrides["iters"] = args.iters
    if args.log_every:
        overrides["log_every"] = args.log_every
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    cfg = load_config(FinetuneConfig, args.config, **overrides)
    if args.dataset == "rxr":
        cfg.model.lang_bert_name = "xlm-roberta-base"
        cfg.model.vocab_size = 250002
        cfg.expert_policy = "ndtw"
        cfg.ml_weight = 0.8
    if args.expert_policy:
        cfg.expert_policy = args.expert_policy
    if args.act_visited_nodes:
        cfg.act_visited_nodes = True
    return cfg


def build(args):
    """(config, training envs, eval envs by split, agent on ``args.device``).

    The training envs are [train] or, with ``--aug_path``, [train, aug],
    taken in turn by iteration parity. The agent acts in the train env; its
    parameters are random from the seed or, with ``--pretrain_ckpt``,
    transferred from that checkpoint (``agent.transferred`` counts the
    entries taken)."""
    if args.dataset in ("reverie", "soon"):
        raise NotImplementedError("object-grounding datasets are not ported yet")
    device = resolve_device(args.device)
    # bf16 GEMMs accumulate in float32 end to end, as the JAX einsums do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = make_config(args)
    if args.synthetic or not args.data_root:
        train_env, val_envs, aug_env = build_synthetic_envs(cfg, args)
    else:
        train_env, val_envs, aug_env = build_envs(cfg, args)
    agent = GMapNavAgent(cfg, train_env, seed=cfg.seed, device=device)
    pretrained = None
    if args.pretrain_ckpt:
        pretrained = load_checkpoint(args.pretrain_ckpt, device)["params"]
    agent.init_params(pretrained=pretrained)
    train_envs = [train_env] if aug_env is None else [train_env, aug_env]
    return cfg, train_envs, val_envs, agent


def write_predictions(path: str, preds: List[dict]) -> None:
    """R2R leaderboard format: (viewpoint, heading, elevation) triples."""
    with open(path, "w") as f:
        json.dump([
            {"instr_id": p["instr_id"],
             "trajectory": [[vp, 0.0, 0.0] for vp in sum(p["trajectory"], [])]}
            for p in preds
        ], f)


def main(argv=None):
    """Evaluate (``--test``) or train with evaluation every ``log_every``
    iterations; returns {split: metrics} of the last evaluation."""
    args = parse_args(argv)
    cfg, train_envs, val_envs, agent = build(args)
    os.makedirs(cfg.output_dir, exist_ok=True)
    logger = MetricLogger(cfg.output_dir)
    if agent.transferred is not None:
        logger.log(0, {"pretrain/transferred": agent.transferred,
                       "pretrain/params": len(agent.model.state_dict())})

    def evaluate_all(step: int) -> Dict[str, dict]:
        results = {}
        for tag, env in val_envs.items():
            agent.env = env
            preds = agent.test()
            avg = env.eval_metrics(preds)[0] if env.gt_trajs else {}
            if avg:
                logger.log(step, {f"{tag}/{k}": v for k, v in avg.items()})
            write_predictions(os.path.join(cfg.output_dir, f"preds_{tag}_{step}.json"), preds)
            results[tag] = avg
        agent.env = train_envs[0]
        return results

    if args.test:
        return evaluate_all(0)

    # best-checkpoint selection stays on val_unseen
    best_split = "val_unseen" if "val_unseen" in val_envs else next(iter(val_envs))
    best = {"score": -1.0}
    results = evaluate_all(0) if args.eval_first else {}
    done = 0
    while done < cfg.iters:
        n = min(cfg.log_every, cfg.iters - done)
        losses = []
        for i in range(n):
            # gt/aug alternate by the global iteration's parity
            agent.env = train_envs[(done + i) % len(train_envs)]
            losses += agent.train_iters(1, feedback=args.feedback)
        agent.env = train_envs[0]
        done += n
        logger.log(done, {"train/IL_loss": float(sum(losses) / max(len(losses), 1))})
        results = evaluate_all(done)
        avg = results[best_split]
        score = avg.get("sr", 0.0) + avg.get("spl", 0.0)
        if score > best["score"]:
            best = {"score": score, "step": done, **avg}
            agent.save_ckpt(os.path.join(cfg.output_dir, "ckpt_best"))
    agent.save_ckpt(os.path.join(cfg.output_dir, "ckpt_latest"))
    logger.log(done, {f"best/{k}": v for k, v in best.items() if k != "step"})
    return results


if __name__ == "__main__":
    print(json.dumps(main()))
