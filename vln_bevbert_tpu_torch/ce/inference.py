"""CE inference and checkpoint-directory evaluation (port of
``vln_bevbert_tpu/ce/inference.py``).

Re-designs the reference's leaderboard writers and multi-checkpoint eval:
- ``run_inference``: argmax rollouts over the whole split, collecting the
  per-step (position, heading) stream, then writes R2R-CE json
  ({episode_id: [{"position", "heading"}...]}) or RxR jsonl
  ({"instruction_id", "path"} with consecutive-duplicate positions dropped)
  — bevbert_ce/vlnce_baselines/ss_trainer_BEV.py:837-950.
- ``evaluate_checkpoint_dir``: evaluates every checkpoint in a directory in
  step order, skipping checkpoints whose stats file already exists
  (the reference's resume-friendly eval loop,
  common/base_il_trainer.py:774-890, ss_trainer_BEV.py:752-759). The port's
  checkpoints are single torch files (``ckpt_<step>``), where the JAX
  package's are orbax directories, so it lists the ``ckpt*`` files.

Under data parallelism every rank rolls out its rows; the episodes of every
rank are merged before anything is scored or written, the loop ends on all
ranks after the same batch, and only rank 0 writes files.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

import numpy as np

from ..parallel import distributed


def collect_predictions(agent, max_batches: Optional[int] = None) -> Dict[str, List[dict]]:
    """Argmax rollouts until every episode in the env's split is covered
    (episode-dedup as in ss_trainer_BEV.py:975-979 pause-envs), over every
    rank's rows: each batch's episodes are gathered from all ranks, in rank
    order, so every rank holds the one process's ``path_eps``."""
    env = agent.env
    env.reset_epoch()
    path_eps: Dict[str, List[dict]] = {}
    n_target = env.size()
    n_batches = 0
    while len(path_eps) < n_target:
        trajs, _ = agent.rollout(feedback="argmax", train=False)
        mine = [(tr["instr_id"], [
            {"position": np.asarray(p, np.float64).tolist(), "heading": float(h)}
            for p, h in zip(tr["positions"], tr["headings"])
        ]) for tr in trajs]
        for rank_eps in distributed.all_gather_objects(mine):
            for instr_id, path in rank_eps:
                path_eps.setdefault(instr_id, path)
        n_batches += 1
        if max_batches and n_batches >= max_batches:
            break
    return path_eps


def write_r2rce_predictions(path_eps: Dict[str, List[dict]], file: str):
    """R2R-CE leaderboard json (ref ss_trainer_BEV.py:936-938)."""
    with open(file, "w") as f:
        json.dump(path_eps, f, indent=2)


def write_rxr_predictions(
    path_eps: Dict[str, List[dict]], inst_ids: Dict[str, int], file: str
):
    """RxR-habitat leaderboard jsonl: consecutive duplicate positions dropped,
    sorted by instruction id (ref ss_trainer_BEV.py:939-949)."""
    preds = []
    for k, v in path_eps.items():
        path = [v[0]["position"]]
        for p in v[1:]:
            if p["position"] != path[-1]:
                path.append(p["position"])
        preds.append({"instruction_id": inst_ids[k], "path": path})
    preds.sort(key=lambda x: x["instruction_id"])
    with open(file, "w") as f:
        for p in preds:
            f.write(json.dumps(p) + "\n")


def run_inference(
    agent,
    predictions_file: str,
    task_type: str = "r2r",
    inst_ids: Optional[Dict[str, int]] = None,
    max_batches: Optional[int] = None,
) -> Dict[str, List[dict]]:
    """Write the split's predictions (rank 0 only); every rank returns them."""
    path_eps = collect_predictions(agent, max_batches=max_batches)
    if not distributed.is_primary():
        return path_eps
    if task_type == "r2r":
        write_r2rce_predictions(path_eps, predictions_file)
    else:
        if inst_ids is None:
            # RxR instruction ids are ints; synthesise stable ones if absent
            inst_ids = {k: i for i, k in enumerate(sorted(path_eps))}
        write_rxr_predictions(path_eps, inst_ids, predictions_file)
    return path_eps


def _ckpt_step(name: str) -> int:
    m = re.search(r"(\d+)$", name)
    return int(m.group(1)) if m else -1


def evaluate_checkpoint_dir(
    agent,
    ckpt_dir: str,
    out_dir: str,
    split: str = "val_unseen",
    num_batches: int = 2,
) -> Dict[str, Dict[str, float]]:
    """Evaluate every checkpoint under ``ckpt_dir`` in step order; skip ones
    whose stats json already exists. Returns {ckpt_name: metrics}. Rank 0
    reads and writes the stats files, and every rank takes its stats."""
    primary = distributed.is_primary()
    if primary:
        os.makedirs(out_dir, exist_ok=True)
    ckpts = sorted(
        (
            f for f in os.listdir(ckpt_dir)
            if os.path.isfile(os.path.join(ckpt_dir, f)) and f.startswith("ckpt")
        ),
        key=_ckpt_step,
    )
    results = {}
    for name in ckpts:
        stats_file = os.path.join(out_dir, f"stats_{name}_{split}.json")
        cached = None
        if primary and os.path.exists(stats_file):
            with open(stats_file) as f:
                cached = json.load(f)
        cached = distributed.all_gather_objects(cached)[0]  # rank 0's decides
        if cached is not None:
            results[name] = cached
            continue
        agent.restore_ckpt(os.path.join(ckpt_dir, name), with_opt=False)
        metrics = agent.evaluate(num_batches=num_batches)
        if primary:
            with open(stats_file, "w") as f:
                json.dump(metrics, f, indent=2)
        results[name] = metrics
    return results
