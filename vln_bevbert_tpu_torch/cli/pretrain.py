"""Pretraining CLI (port of the synthetic path of
``vln_bevbert_tpu/cli/pretrain.py``).

    python -m vln_bevbert_tpu_torch.cli.pretrain --synthetic --device cuda \\
        --num_steps 24 --batch_size 16 --tasks mlm.5.sap.5.masksem.1 --seed 0

Arguments are the JAX CLI's (``parse_args`` is reused) plus ``--device``
(default ``cuda``; a CUDA device that is missing raises, there is no CPU
fallback). ``--synthetic`` (the default without ``--data_root``, as in the
JAX CLI) builds the JAX CLI's synthetic world (4 scans x 20 nodes, 256 items)
in memory, with ``DictFeatureDB`` stores and no HDF5.
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

from vln_bevbert_tpu.cli import pretrain as jax_cli
from vln_bevbert_tpu.configs import PretrainConfig, load_config
from vln_bevbert_tpu.data.loader import PretrainLoader, make_synthetic_annotations
from vln_bevbert_tpu.data.nav_graph import (
    build_scanvp_cands,
    load_nav_graphs,
    write_synthetic_connectivity,
)
from vln_bevbert_tpu.data.pathdata import TextPathData

from ..pretrain.trainer import PretrainTrainer
from .finetune import resolve_device, synthetic_feature_dbs


def parse_args(argv=None):
    own = argparse.ArgumentParser(add_help=False)
    own.add_argument("--device", default="cuda",
                     help="torch device for the model and the kernels")
    ours, rest = own.parse_known_args(argv)
    args = jax_cli.parse_args(rest)
    args.device = ours.device
    return args


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
        cfg.tasks, cfg.mix_ratio = jax_cli.parse_task_ratio(args.tasks)
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
