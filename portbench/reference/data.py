"""The reference's pretraining batches, worked out again from the raw world:
the task schedule (one seeded draw per block of steps), the per-step
example draws, the static-shape batch and the zero-padding of a block to its
largest shape. A frozen copy of ``vln_bevbert_tpu_torch/data/loader.py``
(``MetaLoader``, ``PretrainLoader.build_batch``) and of
``pretrain/trainer.py:pad_block``; the examples and batches come from the
copies in ``pathdata.py`` and ``batching.py``."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .batching import make_pretrain_batch
from .navgraph import NavGraph, build_scanvp_cands
from .pathdata import TextPathData

END_VP_POLICY = {"mlm": (0.75, 1.0), "sap": (0.2, 0.6), "sem": (0.2, 1.0),
                 "masksem": (0.2, 1.0)}


class Store:
    def __init__(self, data: Dict[str, np.ndarray]):
        self.data = data

    def get(self, scan: str, vp: str) -> np.ndarray:
        return self.data[f"{scan}_{vp}"]


def text_path_data(world, model, shapes) -> TextPathData:
    graphs = {scan: NavGraph(*g) for scan, g in world.scans.items()}
    return TextPathData(
        world.annotations, graphs, build_scanvp_cands(graphs),
        view_db=Store(world.views), grid_db=Store(world.grids),
        depth_db=Store(world.depths), sem_db=Store(world.sems),
        image_feat_size=model.image_feat_size, max_txt_len=shapes.max_txt_len,
        bev_dim=model.bev_dim, bev_res=model.bev_res, num_views=shapes.num_views)


def task_for_step(run, seed: int, step: int) -> str:
    p = np.asarray(run["mix_ratio"], np.float64)
    rng = np.random.default_rng((seed, step // max(int(run["task_block_size"]), 1)))
    return run["tasks"][int(rng.choice(len(p), p=p / p.sum()))]


def end_vp_type(task: str, rng: np.random.Generator) -> str:
    pos, mid = END_VP_POLICY[task]
    r = rng.uniform()
    return "pos" if r < pos else "neg_in_gt_path" if r < mid else "neg_others"


def build_batch(db: TextPathData, run, model, shapes, seed: int, step: int, task=None):
    """(task, host batch) of ``step`` (of its scheduled task, or ``task``),
    as the program's loader draws it."""
    task = task or task_for_step(run, seed, step)
    rng = np.random.default_rng((seed, 0, 17, step))
    idxs = rng.integers(0, len(db), run["train_batch_size"])
    examples = [db.get_input(int(i), end_vp_type(task, rng), rng,
                             return_act_label=task in ("sap", "sem", "masksem"))
                for i in idxs]
    return task, make_pretrain_batch(examples, task, shapes, model, rng,
                                     mlm_prob=run["mlm_prob"],
                                     bev_mrc_mask_prob=run["bev_mrc_mask_prob"])


def pad_block(block: List[Dict[str, np.ndarray]]) -> List[Dict[str, np.ndarray]]:
    """Each key zero-padded at the end of every axis to the block's largest shape."""
    out = [dict(b) for b in block]
    for key in block[0]:
        arrs = [np.asarray(b[key]) for b in block]
        shape = tuple(max(a.shape[d] for a in arrs) for d in range(arrs[0].ndim))
        for b, a in zip(out, arrs):
            if a.shape != shape:
                b[key] = np.pad(a, [(0, t - n) for n, t in zip(a.shape, shape)])
    return out
