"""Continuous-environment (R2R-CE) training CLI (port of
``vln_bevbert_tpu/cli/ce_train.py``): scheduled-sampling SS-BEV or SS-ETP
training with the sample-ratio decay, evaluation and a ``ckpt_<done>``
checkpoint every ``log_every`` iterations; evaluation of a checkpoint
directory; leaderboard inference.

    python -m vln_bevbert_tpu_torch.cli.ce_train --allow_random_frozen --batch_size 8 \\
        --pretrain_ckpt runs/ce_pretrain/ckpt_16 --iters 4 --log_every 2
    python -m vln_bevbert_tpu_torch.cli.ce_train --allow_random_frozen --trainer ss-etp
    python -m vln_bevbert_tpu_torch.cli.ce_train --allow_random_frozen --run_type eval \\
        --ckpt_path_dir runs/ce
    python -m vln_bevbert_tpu_torch.cli.ce_train --allow_random_frozen --run_type inference \\
        --ckpt_path_dir runs/ce/ckpt_4

Arguments are the JAX CLI's plus ``--device`` (default ``cuda``; a CUDA
device that is missing raises, there is no CPU fallback). The world is the
synthetic continuous environment, or real VLN-CE / RxR episodes with
``--data_path`` (and ``--gt_path``) over its synthetic sensors. Checkpoints
are single torch files. ``--pretrain_ckpt`` takes a torch checkpoint of the
port's pretraining (``cli/pretrain.py --config configs/ce_pretrain.json``)
or of this CLI. ``--waypoint_ckpt`` reads the frozen waypoint predictor
(``ce/frozen.py``); without it the predictor is random and the run needs
``--allow_random_frozen``. Not ported yet, and refused: ``--trainer dagger``
(the CE DAgger trainer with its recollection store), ``--habitat_config``,
``--clip_ckpt``/``--ddppo_ckpt`` (the Habitat sensor stack) and
``--num_env_workers`` > 0 (the subprocess env pool).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..ce.agent import CEAgent
from ..ce.env import SyntheticContinuousEnv, make_synthetic_ce_episodes
from ..configs import FinetuneConfig, load_config
from ..parallel.train_step import load_checkpoint
from ..utils.logging import MetricLogger
from .finetune import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="torch device for the model and the kernels")
    p.add_argument("--config", default=None)
    p.add_argument("--output_dir", default="runs/ce")
    p.add_argument("--iters", type=int, default=10000)
    p.add_argument("--log_every", type=int, default=500)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--sample_ratio", type=float, default=0.75)
    p.add_argument("--decay_interval", type=int, default=2000)
    p.add_argument("--n_episodes", type=int, default=64)
    p.add_argument("--pretrain_ckpt", default=None,
                   help="torch checkpoint of the port's pretraining or of this CLI")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--test", action="store_true")
    p.add_argument("--trainer", default="ss-bev", choices=["ss-bev", "ss-etp", "dagger"],
                   help="ss-etp = topo-only ETP architecture; dagger (not ported yet) = "
                        "recollection-store DAgger training (ref run.py TRAINER_NAME "
                        "registry: SS-BEV / SS-ETP / dagger)")
    p.add_argument("--policy", default="bev", choices=["bev", "etp", "prevalent"],
                   help="dagger's policy (dagger is not ported yet)")
    p.add_argument("--dagger_iters", type=int, default=3)
    p.add_argument("--update_size", type=int, default=32)
    p.add_argument("--dagger_p", type=float, default=0.75)
    p.add_argument("--dagger_epochs", type=int, default=2)
    p.add_argument("--store_dir", default=None)
    p.add_argument("--store_capacity", type=int, default=None)
    p.add_argument("--num_env_workers", type=int, default=0,
                   help=">0: subprocess env pool (not ported yet)")
    p.add_argument("--run_type", default="train", choices=["train", "eval", "inference"],
                   help="ref run.py --run-type: train loop, checkpoint(-dir) "
                        "evaluation, or leaderboard inference")
    p.add_argument("--ckpt_path_dir", default=None,
                   help="eval: directory of checkpoint files to evaluate in step "
                        "order; inference: the checkpoint file to load")
    p.add_argument("--predictions_file", default="preds.json",
                   help="inference output (ref INFERENCE.PREDICTIONS_FILE)")
    p.add_argument("--task_type", default="r2r", choices=["r2r", "rxr"],
                   help="episode format and inference format: R2R-CE json / RxR jsonl")
    p.add_argument("--back_algo", default=None, choices=["control", "teleport"],
                   help="eval-mode backtrack execution (ref IL.back_algo)")
    p.add_argument("--eval_batches", type=int, default=4)
    p.add_argument("--loc_noise", type=float, default=0.5,
                   help="candidate merge radius in metres (ref IL.loc_noise)")
    p.add_argument("--ghost_aug", type=float, default=0.0,
                   help="train-time ghost position noise (ref IL.ghost_aug)")
    p.add_argument("--ml_weight", type=float, default=None,
                   help="imitation loss weight (ref IL.ml_weight)")
    p.add_argument("--no_waypoint_aug", action="store_true",
                   help="disable train-time waypoint sampling augmentation "
                        "(ref IL.waypoint_aug)")
    p.add_argument("--data_path", default=None,
                   help="VLN-CE episode file ({split}.json.gz; RxR: template "
                        "with {role}) (ref TASK_CONFIG.DATASET.DATA_PATH)")
    p.add_argument("--gt_path", default=None,
                   help="{split}_gt.json.gz dense gt locations for nDTW "
                        "(ref TASK.NDTW.GT_PATH)")
    p.add_argument("--waypoint_ckpt", default=None,
                   help="frozen waypoint-predictor checkpoint: a torch file in the "
                        "published ['predictor']['state_dict'] format, a bare state "
                        "dict, or an .npz flax tree")
    p.add_argument("--ddppo_ckpt", default=None, help="not ported yet (Habitat sensor stack)")
    p.add_argument("--clip_ckpt", default=None, help="not ported yet (Habitat sensor stack)")
    p.add_argument("--habitat_config", default=None,
                   help="not ported yet (Habitat sensor stack)")
    p.add_argument("--habitat_split", default="train")
    p.add_argument("--allow_random_frozen", action="store_true",
                   help="explicitly allow a RANDOM-initialised frozen waypoint "
                        "predictor (synthetic runs only)")
    return p.parse_args(argv)


def refuse_later_slices(args) -> None:
    """The JAX CLI's paths that this port does not have yet."""
    if args.trainer == "dagger":
        raise SystemExit("--trainer dagger is not ported yet: the CE DAgger trainer comes "
                         "with the recollection store in a later slice")
    if args.habitat_config or args.clip_ckpt or args.ddppo_ckpt:
        raise SystemExit("--habitat_config, --clip_ckpt and --ddppo_ckpt are not ported yet: "
                         "they come with the Habitat sensor stack in a later slice")
    if args.num_env_workers > 0:
        raise SystemExit("--num_env_workers > 0 is not ported yet: the subprocess env pool "
                         "comes with the Habitat sensor stack in a later slice")


def build_frozen(args):
    """``--waypoint_ckpt`` -> a ``WaypointPredictor`` state dict, or None
    (random) under ``--allow_random_frozen``; without either, refuse: a
    random frozen predictor is useless for a real run (the reference loads
    the published checkpoint unconditionally, ss_trainer_BEV.py:236-243)."""
    if args.waypoint_ckpt:
        from ..ce.frozen import load_waypoint_params

        return load_waypoint_params(args.waypoint_ckpt)
    if not args.allow_random_frozen:
        raise SystemExit(
            "no --waypoint_ckpt: the frozen waypoint predictor would be "
            "RANDOM-initialised. Pass the published checkpoint "
            "(data/wp_pred/check_cwp_bestdist_hfov90) or opt in explicitly "
            "with --allow_random_frozen (synthetic runs only)."
        )
    return None


def make_config(args) -> FinetuneConfig:
    """The JAX CLI's config: file, overrides, the CE BEV (11x11 at 1 m, ref
    ss_trainer_BEV.py:204-218), the topo-only ETP model for ss-etp."""
    overrides = {"seed": args.seed, "output_dir": args.output_dir}
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    cfg = load_config(FinetuneConfig, args.config, **overrides)
    if cfg.model.bev_dim == 21:
        cfg.model.bev_dim = 11
        cfg.model.bev_res = 1.0
    if args.trainer == "ss-etp":
        # topo-only: no local BEV branch at all (ref ss_trainer_ETP.py)
        cfg.model.use_bev = False
        cfg.fusion = "global"
    if args.back_algo:
        cfg.ce_back_algo = args.back_algo
    if args.ml_weight is not None:
        cfg.ml_weight = args.ml_weight
    return cfg


def build_env(cfg: FinetuneConfig, args) -> SyntheticContinuousEnv:
    """The synthetic continuous environment over synthetic episodes, or over
    the episodes of ``--data_path`` (with ``--gt_path``'s dense paths)."""
    if args.data_path:
        from ..ce.dataset import (apply_gt_paths, load_gt_paths, load_rxr_episodes,
                                  load_vlnce_episodes)

        if args.task_type == "rxr":
            episodes = load_rxr_episodes(args.data_path)
        else:
            episodes = load_vlnce_episodes(args.data_path)
        if args.gt_path:
            apply_gt_paths(episodes, load_gt_paths(args.gt_path))
    else:
        episodes = make_synthetic_ce_episodes(np.random.default_rng(cfg.seed), n=args.n_episodes)
    return SyntheticContinuousEnv(
        episodes, batch_size=cfg.batch_size, seed=cfg.seed, grid_hw=cfg.shapes.grid_hw,
        grid_feat_size=cfg.model.bev_grid_feat_size, view_feat_size=cfg.model.image_feat_size,
    )


def build(args):
    """(config, agent on ``args.device`` in its env). The agent's parameters
    are random from the seed or, with ``--pretrain_ckpt``, transferred from
    that checkpoint (``agent.transferred`` counts the entries taken)."""
    refuse_later_slices(args)
    device = resolve_device(args.device)
    # bf16 GEMMs accumulate in float32 end to end, as the JAX einsums do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = make_config(args)
    wp_params = build_frozen(args)
    agent = CEAgent(cfg, build_env(cfg, args), seed=cfg.seed, sample_ratio=args.sample_ratio,
                    loc_noise=args.loc_noise, ghost_aug=args.ghost_aug,
                    waypoint_aug=not args.no_waypoint_aug, device=device)
    pretrained = None
    if args.pretrain_ckpt:
        pretrained = load_checkpoint(args.pretrain_ckpt, device)["params"]
    agent.init_params(pretrained=pretrained, wp_params=wp_params)
    return cfg, agent


def main(argv=None):
    """Train (evaluating and saving ``ckpt_<done>`` every ``log_every``
    iterations), evaluate (``--run_type eval`` / ``--test``) or write
    predictions (``--run_type inference``). Returns the last metrics by name,
    {checkpoint: metrics} for a checkpoint directory, or the predictions."""
    args = parse_args(argv)
    cfg, agent = build(args)
    os.makedirs(cfg.output_dir, exist_ok=True)
    logger = MetricLogger(cfg.output_dir)
    if agent.transferred is not None:
        logger.log(0, {"pretrain/transferred": agent.transferred,
                       "pretrain/params": len(agent.model.state_dict())})

    if args.run_type == "eval" or args.test:
        from ..ce.inference import evaluate_checkpoint_dir

        if args.ckpt_path_dir and os.path.isdir(args.ckpt_path_dir):
            results = evaluate_checkpoint_dir(agent, args.ckpt_path_dir, cfg.output_dir,
                                              num_batches=args.eval_batches)
            for i, (name, metrics) in enumerate(sorted(results.items())):
                logger.log(i, {f"eval/{name}/{k}": v for k, v in metrics.items()})
            return results
        metrics = agent.evaluate(num_batches=args.eval_batches)
        logger.log(0, {f"eval/{k}": v for k, v in metrics.items()})
        return metrics
    if args.run_type == "inference":
        from ..ce.inference import run_inference

        if args.ckpt_path_dir:
            agent.restore_ckpt(args.ckpt_path_dir, with_opt=False)
        out = os.path.join(cfg.output_dir, args.predictions_file)
        path_eps = run_inference(agent, out, task_type=args.task_type)
        print(f"wrote {out}", flush=True)
        return path_eps

    ratio = args.sample_ratio
    done = 0
    metrics = {}
    while done < args.iters:
        n = min(args.log_every, args.iters - done)
        losses = []
        for _ in range(n):
            _, loss = agent.rollout(feedback="sample", train=True, sample_ratio=ratio)
            if loss is not None:
                losses.append(loss)
        done += n
        # scheduled-sampling ratio decay (ref ss_trainer_BEV.py:659-674)
        if args.decay_interval and done % args.decay_interval == 0:
            ratio /= 2.0
        metrics = agent.evaluate(num_batches=2)
        logger.log(done, {
            "train/loss": float(np.mean(losses)) if losses else float("nan"),
            "train/sample_ratio": ratio,
            **{f"eval/{k}": v for k, v in metrics.items()},
        })
        agent.save_ckpt(os.path.join(cfg.output_dir, f"ckpt_{done}"))
    return metrics


if __name__ == "__main__":
    main()
