"""Discrete-environment fine-tuning CLI (port of
``vln_bevbert_tpu/cli/finetune.py``): DAgger training with evaluation every
``log_every`` iterations, best-checkpoint selection on sr+spl of
``val_unseen``, and submission-format prediction dumps.

    python -m vln_bevbert_tpu_torch.cli.finetune --synthetic --iters 3 --log_every 3
    python -m vln_bevbert_tpu_torch.cli.finetune --synthetic --pretrain_ckpt runs/pretrain/ckpt_24
    python -m vln_bevbert_tpu_torch.cli.finetune --synthetic --test --pretrain_ckpt runs/finetune/ckpt_best
    python -m vln_bevbert_tpu_torch.cli.finetune --data_root datasets/R2R --test
    python -m vln_bevbert_tpu_torch.cli.finetune --synthetic --dataset reverie

Arguments are the JAX CLI's plus ``--device`` (default ``cuda``; there is no
CPU fallback: a CUDA device that is missing raises). ``--synthetic`` builds
the JAX CLI's synthetic world in memory, with ``DictFeatureDB`` stores and no
HDF5; ``--data_root`` reads HDF5 stores through ``H5FeatureDB``, whose
float16 rows numpy casts. Parameters are random, from a seeded generator, or
transferred from ``--pretrain_ckpt``: a torch checkpoint of the port's
pretraining (``ckpt_<step>``) or fine-tuning (``ckpt_best``,
``ckpt_latest``). The object-grounding datasets (reverie, soon) add object
slots to the model (``obj_feat_size`` 768 unless the config sets it) and
object stores to the envs: synthetic ones in memory, or ``BBoxes.json`` and
``obj2vps.json`` under ``--data_root``; their evaluations add RGS and RGSPL
and their prediction dumps ``predObjId``.

Under ``torchrun`` (``python -m torch.distributed.run --nproc_per_node N -m
vln_bevbert_tpu_torch.cli.finetune ...``) every process is one
data-parallel rank on ``cuda:LOCAL_RANK`` (NCCL; gloo with ``--device
cpu``). ``batch_size`` is per rank, as in the JAX CLI: each rank's envs hold
its rows of the global envs of N times as many rows, the replay update sums
the ranks' gradients (``nav/agent.py``), evaluations merge every rank's
predictions before scoring them, and only rank 0 writes checkpoints,
prediction dumps and metrics.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs import FinetuneConfig, load_config
from ..data.annotations import construct_instrs
from ..data.feature_db import DictFeatureDB, H5FeatureDB
from ..data.loader import make_synthetic_annotations
from ..data.nav_graph import (
    build_scanvp_cands,
    load_nav_graphs,
    write_synthetic_connectivity,
)
from ..nav.agent import GMapNavAgent
from ..nav.env import R2RNavBatch
from ..nav.obj_env import ObjectDB, ReverieObjectNavBatch, SoonObjectNavBatch
from ..parallel import distributed
from ..parallel.train_step import load_checkpoint
from ..utils.device import resolve_device
from ..utils.logging import make_logger

Envs = Tuple[R2RNavBatch, Dict[str, R2RNavBatch], Optional[R2RNavBatch]]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="torch device for the model and the kernels")
    p.add_argument("--config", default=None)
    p.add_argument("--data_root", default=None)
    p.add_argument("--dataset", default="r2r",
                   choices=["r2r", "r4r", "rxr", "reverie", "soon"])
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--output_dir", default="runs/finetune")
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--log_every", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--act_visited_nodes", action="store_true",
                   help="only the current node counts visited "
                        "(ref parser.py --act_visited_nodes)")
    p.add_argument("--eval_first", action="store_true",
                   help="evaluate before training (ref parser.py --eval_first)")
    p.add_argument("--expert_policy", default=None, choices=["spl", "ndtw"],
                   help="teacher policy (ref ft_r2r.bash:30 spl, ft_rxr.bash:30 ndtw)")
    p.add_argument("--feedback", default="dagger",
                   choices=["dagger", "teacher", "sample", "expl_sample"])
    p.add_argument("--pretrain_ckpt", default=None,
                   help="torch checkpoint of the port's pretraining or fine-tuning")
    p.add_argument("--test", action="store_true", help="evaluate only")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--aug_path", default=None,
                   help="augmented-instruction annotations (jsonl; synthetic "
                        "mode synthesises a set when 'synth' is passed) — "
                        "training alternates gt/aug envs 1:1 per iteration "
                        "(ref main_nav.py:160-174 prevalent_aug schedule)")
    p.add_argument("--val_splits", default=None,
                   help="comma-separated eval splits; defaults to the "
                        "reference's val_train_seen,val_seen,val_unseen for "
                        "real data (main_nav.py:71-75) and val_unseen for "
                        "synthetic runs. Missing split files are skipped with "
                        "a warning. Best-ckpt selection stays on val_unseen.")
    p.add_argument("--submit", action="store_true",
                   help="also build the leaderboard test split(s) as eval "
                        "envs and dump predictions for them "
                        "(ref main_nav.py:77-81)")
    p.add_argument("--tokenizer", default="bert", choices=["bert", "xlm"],
                   help="annotation tokenizer variant (selects REVERIE "
                        "_enc vs _enc_xlmr files, ref reverie/data_utils.py:57-63)")
    return p.parse_args(argv)


def _dp() -> dict:
    """An env's data-parallel share: this process's rank and the world size."""
    return {"rank": distributed.rank(), "world": distributed.world_size()}


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
    if args.dataset in ("reverie", "soon"):
        train_env, val_envs = _make_obj_envs(cfg, args, graphs, cands, dbs, train_annos,
                                             val_annos)
        return train_env, val_envs, None  # object datasets train on gt episodes only

    def make(annos, name, seed):
        return R2RNavBatch(annos, graphs, cands, batch_size=cfg.batch_size,
                           image_feat_size=cfg.model.image_feat_size, seed=seed,
                           name=name, **dbs, **_dp())

    aug_env = None
    if args.aug_path:
        aug_annos = make_synthetic_annotations(
            graphs, np.random.default_rng(args.seed + 41), n_items=64)
        aug_env = make(aug_annos, "aug", args.seed + 2)
    val_envs = {name: make(annos, name, args.seed + 1 + i)
                for i, (name, annos) in enumerate(val_annos.items())}
    return make(train_annos, "train", args.seed), val_envs, aug_env


def build_envs(cfg: FinetuneConfig, args) -> Envs:
    """The JAX CLI's envs for ``--data_root`` (R2R-style datasets): the
    connectivity graphs, annotations in the native or the published formats
    (``data/annotations.py``), and HDF5 feature stores that every env
    shares. Returns (train env, eval envs by split, aug env or None)."""
    graphs = load_nav_graphs(os.path.join(args.data_root, "connectivity"))
    cands_file = os.path.join(args.data_root, "scanvp_candview_relangles.json")
    if os.path.exists(cands_file):
        with open(cands_file) as f:
            cands = json.load(f)
    else:
        cands = build_scanvp_cands(graphs)

    def load_annos(split):
        return construct_instrs(
            args.data_root, args.dataset, [split], tokenizer=args.tokenizer,
            is_test=args.test, rng=np.random.default_rng(args.seed),
        )

    train_annos = load_annos("train")
    val_splits = (args.val_splits.split(",") if args.val_splits
                  else ["val_train_seen", "val_seen", "val_unseen"])
    if args.submit:
        # leaderboard splits (ref main_nav.py:77-81)
        val_splits += (["test_challenge_public", "test_standard_public"]
                       if args.dataset == "rxr" else ["test"])
    val_annos = {}
    for s in val_splits:
        try:
            annos = load_annos(s)
            if args.dataset == "rxr" and not args.test:
                # rxr val is large; the reference evaluates every 8th item
                # during training (main_nav.py:86-89)
                annos = annos[::8]
            if annos:
                val_annos[s] = annos
            else:
                print(f"[finetune] skipping empty eval split {s}")
        except FileNotFoundError as e:
            print(f"[finetune] skipping eval split {s}: {e}")
    if not val_annos:
        raise FileNotFoundError(
            f"none of the eval splits {val_splits} found under {args.data_root}")
    aug_annos = None
    if args.aug_path:
        # explicit path: construct_instrs sniffs reference vs native shape
        aug_annos = construct_instrs(args.data_root, args.dataset, [args.aug_path],
                                     tokenizer=args.tokenizer, is_test=args.test)
    dbs = dict(
        view_db=H5FeatureDB(os.path.join(args.data_root, "view_fts.hdf5")),
        grid_db=H5FeatureDB(os.path.join(args.data_root, "grid_fts.hdf5"),
                            dtype=np.float16),
        depth_db=H5FeatureDB(os.path.join(args.data_root, "depth.hdf5")),
    )
    if args.dataset in ("reverie", "soon"):
        train_env, val_envs = _make_obj_envs(cfg, args, graphs, cands, dbs, train_annos,
                                             val_annos)
        return train_env, val_envs, None

    def make(annos, name, seed):
        return R2RNavBatch(annos, graphs, cands, batch_size=cfg.batch_size,
                           image_feat_size=cfg.model.image_feat_size, seed=seed,
                           name=name, **dbs, **_dp())

    aug_env = make(aug_annos, "aug", args.seed + 2) if aug_annos else None
    val_envs = {name: make(annos, name, args.seed + 1 + i)
                for i, (name, annos) in enumerate(val_annos.items())}
    return make(train_annos, "train", args.seed), val_envs, aug_env


def _make_obj_envs(cfg: FinetuneConfig, args, graphs, cands, dbs, train_annos, val_annos):
    """REVERIE/SOON envs: (train env, eval envs by split). Synthetic runs
    draw two objects per viewpoint from ``seed + 17`` and make each item's
    goal the first object of its last viewpoint (``objId``, ``end_vps``, in
    place); ``--data_root`` reads ``BBoxes.json`` and ``obj2vps.json``. The
    train env resamples episode goals among the target's viewpoints."""
    m = cfg.model
    if args.synthetic or not args.data_root:
        rng = np.random.default_rng(args.seed + 17)
        obj_data, obj2vps = {}, {}
        oid = 0
        for scan, g in graphs.items():
            for vp in g.node_ids:
                ids = [str(oid), str(oid + 1)]
                oid += 2
                obj_data[f"{scan}_{vp}"] = {
                    "fts": rng.normal(size=(2, m.obj_feat_size + m.obj_prob_size)
                                      ).astype(np.float32),
                    "directions": rng.uniform(-1, 1, (2, 2)).astype(np.float32),
                    "sizes": rng.uniform(20, 100, (2, 2)).astype(np.float32),
                    "obj_ids": ids,
                }
                for i in ids:
                    obj2vps[f"{scan}_{i}"] = [vp]
        for annos in (train_annos, *val_annos.values()):
            for a in annos:
                scan, goal = a["scan"], a["path"][-1]
                a["objId"] = obj_data[f"{scan}_{goal}"]["obj_ids"][0]
                a["end_vps"] = [goal]
    else:
        with open(os.path.join(args.data_root, "BBoxes.json")) as f:
            raw = json.load(f)
        obj_data = raw["objects"] if "objects" in raw else raw
        with open(os.path.join(args.data_root, "obj2vps.json")) as f:
            obj2vps = json.load(f)
    env_cls = SoonObjectNavBatch if args.dataset == "soon" else ReverieObjectNavBatch

    def make(annos, name, seed):
        return env_cls(annos, graphs, cands, batch_size=cfg.batch_size,
                       image_feat_size=m.image_feat_size, seed=seed, name=name,
                       obj_db=ObjectDB(obj_data), obj2vps=obj2vps,
                       max_objects=cfg.shapes.max_objects,
                       multi_endpoints=(name == "train"), **dbs, **_dp())

    val_envs = {name: make(annos, name, args.seed + 1 + i)
                for i, (name, annos) in enumerate(val_annos.items())}
    return make(train_annos, "train", args.seed), val_envs


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
    if args.dataset in ("reverie", "soon"):
        # object tokens and the OG head (the reference's obj_ft_dim 768)
        cfg.model.obj_feat_size = cfg.model.obj_feat_size or 768
    return cfg


def build(args):
    """(config, training envs, eval envs by split, agent on ``args.device``).

    The training envs are [train] or, with ``--aug_path``, [train, aug],
    taken in turn by iteration parity. The agent acts in the train env; its
    parameters are random from the seed or, with ``--pretrain_ckpt``,
    transferred from that checkpoint (``agent.transferred`` counts the
    entries taken). Under a launcher it joins the process group first and
    ``cfg.batch_size`` becomes the global batch, per rank times the world
    size (JAX ``cli/finetune.py:282-293``)."""
    device = distributed.initialize(resolve_device(args.device))
    # bf16 GEMMs accumulate in float32 end to end, as the JAX einsums do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = make_config(args)
    cfg.batch_size *= distributed.world_size()
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
    """R2R leaderboard format: (viewpoint, heading, elevation) triples;
    REVERIE/SOON add the grounded object as ``predObjId``."""

    def entry(p):
        e = {"instr_id": p["instr_id"],
             "trajectory": [[vp, 0.0, 0.0] for vp in sum(p["trajectory"], [])]}
        if p.get("pred_objid") is not None:
            e["predObjId"] = p["pred_objid"]
        return e

    with open(path, "w") as f:
        json.dump([entry(p) for p in preds], f)


def main(argv=None):
    """Evaluate (``--test``) or train with evaluation every ``log_every``
    iterations; returns {split: metrics} of the last evaluation, over every
    rank's predictions."""
    args = parse_args(argv)
    cfg, train_envs, val_envs, agent = build(args)
    primary = distributed.is_primary()
    logger = make_logger(cfg.output_dir, primary)

    def save(name: str) -> None:
        if primary:
            agent.save_ckpt(os.path.join(cfg.output_dir, name))
        distributed.barrier()

    if agent.transferred is not None:
        logger.log(0, {"pretrain/transferred": agent.transferred,
                       "pretrain/params": len(agent.model.state_dict())})

    def evaluate_all(step: int) -> Dict[str, dict]:
        results = {}
        for tag, env in val_envs.items():
            agent.env = env
            # the dedupe on instr_id drops the rows that pad a split's end
            preds = distributed.merge_results(distributed.all_gather_objects(agent.test()))
            avg = env.eval_metrics(preds)[0] if env.gt_trajs else {}
            if avg:
                logger.log(step, {f"{tag}/{k}": v for k, v in avg.items()})
            if primary:
                write_predictions(os.path.join(cfg.output_dir, f"preds_{tag}_{step}.json"),
                                  preds)
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
            save("ckpt_best")
    save("ckpt_latest")
    logger.log(done, {f"best/{k}": v for k, v in best.items() if k != "step"})
    return results


if __name__ == "__main__":
    print(json.dumps(main()))
    distributed.shutdown()
