"""Pretraining CLI (port of ``vln_bevbert_tpu/cli/pretrain.py``).

    python -m vln_bevbert_tpu_torch.cli.pretrain --synthetic --device cuda \\
        --num_steps 24 --batch_size 16 --tasks mlm.5.sap.5.masksem.1 --seed 0
    python -m vln_bevbert_tpu_torch.cli.pretrain --data_root <dir> --init_bert

Arguments are the JAX CLI's plus ``--device`` (default ``cuda``; a CUDA
device that is missing raises, there is no CPU fallback). ``--synthetic``
(the default without ``--data_root``, as in the JAX CLI) builds the JAX
CLI's synthetic world (4 scans x 20 nodes, 256 items) in memory, with
``DictFeatureDB`` stores and no HDF5; validation then reads the same world.
``--data_root`` reads the reference layout (``build_real_db``):
``connectivity/``, ``scanvp_candview_relangles.json`` if present, the
annotations ``{dataset}_{split}_enc.jsonl`` (or ``--train_files`` /
``--val_files``) and the HDF5 stores ``view_fts``, ``grid_fts``, ``depth``
and ``sem``; validation reads the val_unseen split. Every ``valid_steps``
steps the trainer validates val_unseen, then saves ``ckpt_<step>``.
Parameters are random, from ``--seed``; ``--init_bert`` then replaces the
``bert`` entries that HF ``cfg.model.lang_bert_name`` has (embeddings and the
language layers; it needs ``transformers`` and the weights in its local
cache), and ``--resume <ckpt>`` restores a checkpoint (training then runs on
to ``--num_steps``). The run ends by saving ``<output_dir>/ckpt_<step>``.
Under ``torchrun`` (``python -m torch.distributed.run --nproc_per_node N
-m vln_bevbert_tpu_torch.cli.pretrain ...``) every process is one
data-parallel rank on ``cuda:LOCAL_RANK`` (NCCL; gloo with ``--device cpu``),
``train_batch_size`` is per rank, as in the JAX CLI and the reference's
per-GPU batch, and the ranks' rows make up one process's global batch of N
times as many rows (``pretrain/trainer.py``).
``--dataset reverie|soon`` gives the model object slots (``obj_feat_size``
768, ``obj_prob_size`` 1000 unless the config sets them), as the JAX CLI
does; neither its synthetic world nor ``build_real_db`` has an object
store, as the JAX CLI's have none, so object pretraining (mrc, og) runs
through the library: ``PretrainTrainer`` over a ``TextPathData`` with
``obj_db=ObjectDB(...)`` (``data.loader.make_synthetic_object_world``).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from ..configs import PretrainConfig, load_config
from ..data.annotations import read_annotation_file
from ..data.feature_db import H5FeatureDB
from ..data.loader import PretrainLoader, make_synthetic_annotations
from ..data.nav_graph import (
    build_scanvp_cands,
    load_nav_graphs,
    write_synthetic_connectivity,
)
from ..data.pathdata import TextPathData
from ..models import surgery
from ..parallel import distributed
from ..pretrain.trainer import PretrainTrainer
from ..utils.device import resolve_device
from .finetune import synthetic_feature_dbs


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


def _split_files(spec):
    return [s for s in spec.split(",") if s.strip()] if spec else None


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


def build_real_db(cfg: PretrainConfig, data_root: str, dataset: str, split: str = "train",
                  traj_files=None) -> TextPathData:
    """The reference layout under ``data_root`` (the JAX CLI's
    ``build_real_db``): graphs from ``connectivity/``, candidates from
    ``scanvp_candview_relangles.json`` or built from the graphs, the
    annotations of ``traj_files`` (the reference's ``*_traj_files`` lists)
    or ``{dataset}_{split}_enc.jsonl``, and the four HDF5 stores."""
    graphs = load_nav_graphs(os.path.join(data_root, "connectivity"))
    cands_file = os.path.join(data_root, "scanvp_candview_relangles.json")
    if os.path.exists(cands_file):
        with open(cands_file) as f:
            cands = json.load(f)
    else:
        cands = build_scanvp_cands(graphs)
    if traj_files:
        annos = [item for path in traj_files for item in read_annotation_file(path)]
    else:
        annos = read_annotation_file(os.path.join(data_root, f"{dataset}_{split}_enc.jsonl"))
    return TextPathData(
        annos, graphs, cands,
        view_db=H5FeatureDB(os.path.join(data_root, "view_fts.hdf5")),
        grid_db=H5FeatureDB(os.path.join(data_root, "grid_fts.hdf5"), dtype=np.float16),
        depth_db=H5FeatureDB(os.path.join(data_root, "depth.hdf5")),
        sem_db=H5FeatureDB(os.path.join(data_root, "sem.hdf5"), dtype=np.uint8),
        image_feat_size=cfg.model.image_feat_size, obj_feat_size=cfg.model.obj_feat_size,
        obj_prob_size=cfg.model.obj_prob_size, max_txt_len=cfg.shapes.max_txt_len,
        bev_dim=cfg.model.bev_dim, bev_res=cfg.model.bev_res,
        num_views=cfg.shapes.num_views,
        dataset="r2r" if dataset in ("r2r", "r4r") else dataset,
    )


def init_bert(trainer: PretrainTrainer) -> int:
    """Replace the ``bert`` entries that the HF checkpoint
    ``cfg.model.lang_bert_name`` maps (``surgery.load_hf_bert``); returns
    how many were transferred."""
    m = trainer.cfg.model
    src = surgery.hf_state_dict(surgery.load_hf_bert(m.lang_bert_name, m.num_l_layers))
    own = trainer.model.state_dict()
    bert = {k: v for k, v in own.items() if k.startswith("bert.")}
    trainer.model.load_state_dict(surgery.transfer_pretrained(src, own))
    n = surgery.count_transferred(src, bert)
    print(f"--init_bert: {n} of {len(bert)} bert entries from {m.lang_bert_name}", flush=True)
    return n


def build(args) -> PretrainTrainer:
    """A trainer on ``args.device`` over the synthetic world's or
    ``--data_root``'s loaders (train, and val_unseen for validation), with
    random parameters, then ``--init_bert``'s, then those of ``--resume``.
    Under a launcher it joins the process group first; the loaders then
    hand this rank its rows of the global batch, ``train_batch_size`` times
    the world size (val_unseen's from ``seed + 1``)."""
    device = distributed.initialize(resolve_device(args.device))
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
    if args.dataset in ("reverie", "soon") and cfg.model.obj_feat_size == 0:
        cfg.model.obj_feat_size = 768
        cfg.model.obj_prob_size = 1000
    if args.synthetic or not args.data_root:
        nav_db = val_db = build_synthetic_db(cfg, args.seed)
    else:
        nav_db = build_real_db(cfg, args.data_root, args.dataset, "train",
                               _split_files(args.train_files))
        val_db = build_real_db(cfg, args.data_root, args.dataset, "val_unseen",
                               _split_files(args.val_files))
    # train_batch_size is per rank; the loaders draw the global batch
    dp = dict(n_devices=distributed.world_size(),
              dp_rank=distributed.rank() if distributed.active() else None)
    loader = PretrainLoader(nav_db, cfg, seed=cfg.seed, num_workers=cfg.num_workers, **dp)
    val_loader = PretrainLoader(val_db, cfg, seed=cfg.seed + 1, prefetch=0, **dp)
    trainer = PretrainTrainer(cfg, loader, device, val_loaders={"val_unseen": val_loader})
    if args.init_bert:
        init_bert(trainer)
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
    distributed.shutdown()
