"""Continuous-environment (R2R-CE) training CLI (port of
``vln_bevbert_tpu/cli/ce_train.py``): scheduled-sampling SS-BEV or SS-ETP
training with the sample-ratio decay, evaluation and a ``ckpt_<done>``
checkpoint every ``log_every`` iterations; evaluation of a checkpoint
directory; leaderboard inference; DAgger with a recollection store.

    python -m vln_bevbert_tpu_torch.cli.ce_train --allow_random_frozen --batch_size 8 \\
        --pretrain_ckpt runs/ce_pretrain/ckpt_16 --iters 4 --log_every 2
    python -m vln_bevbert_tpu_torch.cli.ce_train --allow_random_frozen --trainer ss-etp
    python -m vln_bevbert_tpu_torch.cli.ce_train --allow_random_frozen --run_type eval \\
        --ckpt_path_dir runs/ce
    python -m vln_bevbert_tpu_torch.cli.ce_train --allow_random_frozen --run_type inference \\
        --ckpt_path_dir runs/ce/ckpt_4
    python -m vln_bevbert_tpu_torch.cli.ce_train --allow_random_frozen --trainer dagger \\
        --policy prevalent --dagger_iters 2 --update_size 16 --num_env_workers 2
    python -m vln_bevbert_tpu_torch.cli.ce_train --habitat_config r2r_ce.yaml \\
        --clip_ckpt clip-vit-base-patch16.pt --ddppo_ckpt gibson-2plus-resnet50.pth \\
        --waypoint_ckpt check_cwp_bestdist_hfov90

Arguments are the JAX CLI's plus ``--device`` (default ``cuda``; a CUDA
device that is missing raises, there is no CPU fallback). The world is the
synthetic continuous environment, or real VLN-CE / RxR episodes with
``--data_path`` (and ``--gt_path``) over its synthetic sensors. Checkpoints
are single torch files. ``--pretrain_ckpt`` takes a torch checkpoint of the
port's pretraining (``cli/pretrain.py --config configs/ce_pretrain.json``)
or of this CLI. ``--waypoint_ckpt`` reads the frozen waypoint predictor
(``ce/frozen.py``); without it the predictor is random and the run needs
``--allow_random_frozen``.

``--trainer dagger`` runs ``ce/dagger.py:run_dagger``: per iteration
``--update_size`` episodes collected at beta = ``--dagger_p`` ** iteration
into a store under ``--store_dir`` (default ``<output_dir>/store``, FIFO
over ``--store_capacity`` episodes), then ``--dagger_epochs`` epochs over
it; ``dagger/{beta,collected,loss,store_size}`` go to ``metrics.jsonl`` and
``ckpt_dagger`` is written at the end. ``--policy prevalent`` trains the
Recurrent VLN-BERT policy by BPTT from a ``DaggerEpisodeStore``; ``bev`` and
``etp`` (the topo-only model) train the glocal ``CEAgent`` from a
``TeacherRecollectionStore``. ``--num_env_workers N`` runs the synthetic env
in N spawned worker processes (``ce/env_pool.py``; the batch must divide
by N).

``--habitat_config`` builds the env from a habitat config YAML
(``ce/habitat_binding.py:make_habitat_env``; needs ``habitat``, real MP3D
scenes and episodes): every step renders each env's 12-view ring and
encodes it with the frozen towers on ``--device``, CLIP ViT-B/16
(``--clip_ckpt``: ``pooled`` -> view features, ``grid`` -> the BEV's grid
features) and the DDPPO ResNet-50 (``--ddppo_ckpt``: raw 256x256 depth ->
the waypoint predictor's (128, 4, 4) maps). Their widths are read off the
checkpoints. Both towers run in strict float32, as the JAX towers do: the
CLI turns TF32 off for cuDNN convolutions (PyTorch's default is on) and for
matmuls. ``--clip_ckpt``/``--ddppo_ckpt`` without ``--habitat_config``, and
``--habitat_config`` with ``--num_env_workers``, are refused as the JAX CLI
refuses them.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..ce.agent import CEAgent
from ..ce.dagger import PrevalentDaggerAgent, run_dagger
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
                   help="ss-etp = topo-only ETP architecture; dagger = "
                        "recollection-store DAgger training (ref run.py TRAINER_NAME "
                        "registry: SS-BEV / SS-ETP / dagger)")
    p.add_argument("--policy", default="bev", choices=["bev", "etp", "prevalent"],
                   help="dagger: policy to train — glocal BEV / topo-only ETP via the "
                        "replay-bundle store, or the legacy Recurrent VLN-BERT "
                        "(PREVALENT) via the episode store (ref MODEL.policy_name)")
    p.add_argument("--dagger_iters", type=int, default=3,
                   help="dagger iterations (ref IL.DAGGER.iterations)")
    p.add_argument("--update_size", type=int, default=32,
                   help="episodes collected per dagger iteration (ref IL.DAGGER.update_size)")
    p.add_argument("--dagger_p", type=float, default=0.75,
                   help="teacher-mix decay base: beta = p**iter (ref IL.DAGGER.p)")
    p.add_argument("--dagger_epochs", type=int, default=2,
                   help="training epochs over the store per iteration (ref IL.epochs)")
    p.add_argument("--store_dir", default=None,
                   help="disk directory of the recollection store (ref "
                        "IL.DAGGER.lmdb_features_dir; default <output_dir>/store)")
    p.add_argument("--store_capacity", type=int, default=None,
                   help="max episodes kept (FIFO eviction); None = unbounded")
    p.add_argument("--num_env_workers", type=int, default=0,
                   help=">0: subprocess env pool with this many workers "
                        "(ref env_utils.py NUM_ENVIRONMENTS)")
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
    p.add_argument("--ddppo_ckpt", default=None,
                   help="frozen DDPPO point-nav depth ResNet50 checkpoint (torch "
                        "gibson-2plus-resnet50.pth layout, .npz flax tree or the port's "
                        "state dict); requires --habitat_config")
    p.add_argument("--clip_ckpt", default=None,
                   help="frozen CLIP-B/16 vision tower: HF model dir/name (local cache), "
                        "torch state dict, .npz flax tree; requires --habitat_config")
    p.add_argument("--habitat_config", default=None,
                   help="habitat config YAML: the real HabitatContinuousEnv instead of "
                        "the synthetic world (ref run.py --exp-config; requires habitat)")
    p.add_argument("--habitat_split", default="train",
                   help="dataset split for --habitat_config episode loading")
    p.add_argument("--allow_random_frozen", action="store_true",
                   help="explicitly allow a RANDOM-initialised frozen waypoint "
                        "predictor (synthetic runs only)")
    return p.parse_args(argv)


def build_frozen(args, device):
    """(waypoint state dict, CLIP encoder, DDPPO encoder) from the
    ``--waypoint_ckpt``/``--clip_ckpt``/``--ddppo_ckpt`` flags, the towers
    on ``device``. Without ``--waypoint_ckpt`` the predictor is random
    (None) under ``--allow_random_frozen`` and refused otherwise: a random
    frozen predictor is useless for a real run (the reference loads the
    published checkpoint unconditionally, ss_trainer_BEV.py:236-243)."""
    wp_params = clip_encoder = depth_encoder = None
    if args.waypoint_ckpt:
        from ..ce.frozen import load_waypoint_params

        wp_params = load_waypoint_params(args.waypoint_ckpt)
    elif not args.allow_random_frozen:
        raise SystemExit(
            "no --waypoint_ckpt: the frozen waypoint predictor would be "
            "RANDOM-initialised. Pass the published checkpoint "
            "(data/wp_pred/check_cwp_bestdist_hfov90) or opt in explicitly "
            "with --allow_random_frozen (synthetic runs only)."
        )
    if args.clip_ckpt or args.ddppo_ckpt:
        if not args.habitat_config:
            raise SystemExit(
                "--clip_ckpt/--ddppo_ckpt configure the habitat sensor "
                "stack and require --habitat_config (the synthetic env "
                "synthesises features directly)"
            )
        if args.clip_ckpt:
            from ..ce.frozen import load_clip_params
            from ..precompute.pipeline import DeviceClipEncoder

            clip_encoder = DeviceClipEncoder(load_clip_params(args.clip_ckpt), device=device)
        if args.ddppo_ckpt:
            from ..ce.frozen import DeviceDepthEncoder, load_depth_params

            depth_encoder = DeviceDepthEncoder(load_depth_params(args.ddppo_ckpt), device=device)
    return wp_params, clip_encoder, depth_encoder


def make_config(args) -> FinetuneConfig:
    """The JAX CLI's config: file, overrides, the CE BEV (11x11 at 1 m, ref
    ss_trainer_BEV.py:204-218), the topo-only ETP model for ss-etp and for
    dagger's etp policy."""
    overrides = {"seed": args.seed, "output_dir": args.output_dir}
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    cfg = load_config(FinetuneConfig, args.config, **overrides)
    if cfg.model.bev_dim == 21:
        cfg.model.bev_dim = 11
        cfg.model.bev_res = 1.0
    if args.trainer == "ss-etp" or (args.trainer == "dagger" and args.policy == "etp"):
        # topo-only: no local BEV branch at all (ref ss_trainer_ETP.py)
        cfg.model.use_bev = False
        cfg.fusion = "global"
    if args.back_algo:
        cfg.ce_back_algo = args.back_algo
    if args.ml_weight is not None:
        cfg.ml_weight = args.ml_weight
    return cfg


def build_env(cfg: FinetuneConfig, args, clip_encoder=None, depth_encoder=None):
    """With ``--habitat_config`` the habitat binding over habitat's dataset
    (``--data_path``/``--habitat_split`` override its path and split) with
    the frozen towers; else the synthetic continuous environment over
    synthetic episodes, or over the episodes of ``--data_path`` (with
    ``--gt_path``'s dense paths); with ``--num_env_workers N`` a pool of N
    spawned workers, each with ``batch_size / N`` slots over every N-th
    episode."""
    if args.habitat_config:
        if args.num_env_workers > 0:
            raise SystemExit(
                "--habitat_config with --num_env_workers is not supported "
                "yet: habitat env factories are not spawn-picklable here"
            )
        from ..ce.habitat_binding import make_habitat_env

        return make_habitat_env(
            args.habitat_config, batch_size=cfg.batch_size, data_path=args.data_path,
            split=args.habitat_split, clip_encoder=clip_encoder, depth_encoder=depth_encoder,
            grid_hw=cfg.shapes.grid_hw)
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
    env_kwargs = dict(grid_hw=cfg.shapes.grid_hw, grid_feat_size=cfg.model.bev_grid_feat_size,
                      view_feat_size=cfg.model.image_feat_size)
    if args.num_env_workers > 0:
        from ..ce.env_pool import make_synthetic_pool

        if cfg.batch_size % args.num_env_workers:
            raise SystemExit(f"--num_env_workers {args.num_env_workers} must divide the batch "
                             f"size {cfg.batch_size}")
        return make_synthetic_pool(
            episodes, num_workers=args.num_env_workers,
            slots_per_worker=cfg.batch_size // args.num_env_workers, seed=cfg.seed, **env_kwargs)
    return SyntheticContinuousEnv(episodes, batch_size=cfg.batch_size, seed=cfg.seed,
                                  **env_kwargs)


def build(args):
    """(config, agent on ``args.device`` in its env): a ``CEAgent``, or a
    ``PrevalentDaggerAgent`` for ``--trainer dagger --policy prevalent``.
    The glocal agent's parameters are random from the seed or, with
    ``--pretrain_ckpt``, transferred from that checkpoint
    (``agent.transferred`` counts the entries taken). A pool's workers are
    stopped if the agent cannot be built."""
    device = resolve_device(args.device)
    # bf16 GEMMs accumulate in float32 end to end, as the JAX einsums do, and
    # float32 convolutions and GEMMs (the frozen towers) stay strict float32:
    # cuDNN's default is TF32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prevalent = args.trainer == "dagger" and args.policy == "prevalent"
    if prevalent and args.pretrain_ckpt:
        # PREVALENT loads torch-layout state dicts (vlnbert_init.py), not
        # the glocal pretraining checkpoint
        raise SystemExit("--pretrain_ckpt is the glocal pretrain tree; the prevalent policy "
                         "loads torch weights via models.legacy.prevalent_to_tree instead")
    cfg = make_config(args)
    wp_params, clip_encoder, depth_encoder = build_frozen(args, device)
    env = build_env(cfg, args, clip_encoder, depth_encoder)
    try:
        if prevalent:
            agent = PrevalentDaggerAgent(cfg, env, seed=cfg.seed, device=device)
            agent.init_params(wp_params=wp_params)
            return cfg, agent
        agent = CEAgent(cfg, env, seed=cfg.seed, sample_ratio=args.sample_ratio,
                        loc_noise=args.loc_noise, ghost_aug=args.ghost_aug,
                        waypoint_aug=not args.no_waypoint_aug, device=device)
        pretrained = None
        if args.pretrain_ckpt:
            pretrained = load_checkpoint(args.pretrain_ckpt, device)["params"]
        agent.init_params(pretrained=pretrained, wp_params=wp_params)
        return cfg, agent
    except BaseException:
        close_env(env)
        raise


def close_env(env) -> None:
    """Stop a pool's worker processes; an in-process env has nothing to stop."""
    if hasattr(env, "close"):
        env.close()


def main(argv=None):
    """Train (evaluating and saving ``ckpt_<done>`` every ``log_every``
    iterations), run DAgger (``--trainer dagger``), evaluate (``--run_type
    eval`` / ``--test``) or write predictions (``--run_type inference``).
    Returns the last metrics by name, DAgger's history, {checkpoint: metrics}
    for a checkpoint directory, or the predictions. A pool's workers are
    stopped on every way out."""
    args = parse_args(argv)
    cfg, agent = build(args)
    try:
        return run(args, cfg, agent)
    finally:
        close_env(agent.env)


def run(args, cfg: FinetuneConfig, agent):
    os.makedirs(cfg.output_dir, exist_ok=True)
    logger = MetricLogger(cfg.output_dir)
    if getattr(agent, "transferred", None) is not None:
        logger.log(0, {"pretrain/transferred": agent.transferred,
                       "pretrain/params": len(agent.model.state_dict())})

    if args.trainer == "dagger":
        history = run_dagger(
            agent, args.store_dir or os.path.join(cfg.output_dir, "store"), policy=args.policy,
            dagger_iters=args.dagger_iters, update_size=args.update_size, p=args.dagger_p,
            epochs=args.dagger_epochs, capacity=args.store_capacity, log_fn=logger.log)
        agent.save_ckpt(os.path.join(cfg.output_dir, "ckpt_dagger"))
        return history

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
