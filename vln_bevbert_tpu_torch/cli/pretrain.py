"""Pretraining CLI (port of the synthetic path of
``vln_bevbert_tpu/cli/pretrain.py``).

    python -m vln_bevbert_tpu_torch.cli.pretrain --synthetic --device cuda \\
        --num_steps 24 --batch_size 16 --tasks mlm.5.sap.5.masksem.1 --seed 0

Arguments are the JAX CLI's plus ``--device`` (default ``cuda``; a CUDA
device that is missing raises, there is no CPU fallback). ``--synthetic``
(the default without ``--data_root``, as in the JAX CLI) builds the JAX
CLI's synthetic world (4 scans x 20 nodes, 256 items) in memory, with
``DictFeatureDB`` stores and no HDF5.
Parameters are random, from ``--seed``, or restored with ``--resume <ckpt>``
(training then runs on to ``--num_steps``). The run ends by saving
``<output_dir>/ckpt_<step>``. Real data (``--data_root``), object datasets
and ``--init_bert`` are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np
import torch

from ..configs import PretrainConfig, load_config
from ..data.loader import PretrainLoader, make_synthetic_annotations
from ..data.nav_graph import (
    build_scanvp_cands,
    load_nav_graphs,
    write_synthetic_connectivity,
)
from ..data.pathdata import TextPathData
from ..pretrain.trainer import PretrainTrainer
from .finetune import resolve_device, synthetic_feature_dbs


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="torch device for the model and the kernels")
    p.add_argument("--config", default=None, help="JSON config overrides")
    p.add_argument("--data_root", default=None)
    p.add_argument("--dataset", default="r2r", choices=["r2r", "r4r", "reverie", "soon"])
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--output_dir", default="runs/pretrain")
    p.add_argument("--num_steps", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--tasks", default=None, help="e.g. mlm.5.sap.5.masksem.1")
    p.add_argument("--train_files", default=None,
                   help="comma-separated trajectory annotation files "
                        "(jsonl/json), overriding the data_root layout — "
                        "the reference's train_traj_files lists "
                        "(config/*_pretrain.json)")
    p.add_argument("--val_files", default=None,
                   help="like --train_files for the validation split")
    p.add_argument("--resume", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=None,
                   help="forked batch-builder processes (default: config)")
    p.add_argument("--init_bert", action="store_true",
                   help="initialise the language stack from HF bert-base")
    return p.parse_args(argv)


def parse_task_ratio(spec: str):
    """'mlm.5.sap.5.masksem.1' -> (('mlm','sap','masksem'), (5.,5.,1.))
    (ref task-ratio DSL, pretrain_src/utils/misc.py:27-37)."""
    parts = spec.split(".")
    tasks, ratios = [], []
    for i in range(0, len(parts), 2):
        tasks.append(parts[i])
        ratios.append(float(parts[i + 1]))
    return tuple(tasks), tuple(ratios)


def build_synthetic_db(cfg: PretrainConfig, seed: int = 0) -> TextPathData:
    """The JAX CLI's synthetic pretraining world, with the features in memory."""
    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory() as conn:
        write_synthetic_connectivity(conn, rng, n_scans=4, n_nodes=20)
        graphs = load_nav_graphs(conn)
    dbs = synthetic_feature_dbs(
        rng, {s: g.node_ids for s, g in graphs.items()},
        image_feat_size=cfg.model.image_feat_size,
        grid_feat_size=cfg.model.bev_grid_feat_size,
        grid_hw=cfg.shapes.grid_hw, num_views=cfg.shapes.num_views,
        num_sem=cfg.model.num_sem_classes,
    )
    annos = make_synthetic_annotations(graphs, rng, n_items=256)
    return TextPathData(
        annos, graphs, build_scanvp_cands(graphs), **dbs,
        image_feat_size=cfg.model.image_feat_size, max_txt_len=cfg.shapes.max_txt_len,
        bev_dim=cfg.model.bev_dim, bev_res=cfg.model.bev_res,
        num_views=cfg.shapes.num_views,
    )


def build(args) -> PretrainTrainer:
    """A trainer on ``args.device`` over the synthetic world's loader, with
    random parameters or those of ``--resume``."""
    if args.data_root and not args.synthetic:
        raise NotImplementedError("--data_root is not ported yet: pass --synthetic")
    if args.dataset not in ("r2r", "r4r") or args.init_bert:
        raise NotImplementedError("object datasets and --init_bert are not ported yet")
    device = resolve_device(args.device)
    # bf16 GEMMs accumulate in float32 end to end, as the JAX einsums do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    overrides = {"seed": args.seed, "output_dir": args.output_dir}
    if args.num_workers is not None:
        overrides["num_workers"] = args.num_workers
    if args.batch_size:
        overrides["train_batch_size"] = args.batch_size
    if args.num_steps:
        overrides["optim.num_train_steps"] = args.num_steps
    cfg = load_config(PretrainConfig, args.config, **overrides)
    if args.tasks:
        cfg.tasks, cfg.mix_ratio = parse_task_ratio(args.tasks)
    loader = PretrainLoader(build_synthetic_db(cfg, args.seed), cfg, seed=cfg.seed,
                            num_workers=cfg.num_workers)
    trainer = PretrainTrainer(cfg, loader, device)
    if args.resume:
        trainer.restore(args.resume)
    return trainer


def main(argv=None):
    """Train up to ``--num_steps`` steps and save the checkpoint; returns the
    meters by "<task>/<metric>"."""
    trainer = build(parse_args(argv))
    meters = trainer.train()
    trainer.save(trainer.state.step)
    return meters


if __name__ == "__main__":
    print(json.dumps(main()))
