"""Multilabel semantic metrics + the MP3D 40-category table (the port's copy
of ``vln_bevbert_tpu/utils/mlabel.py``).

Role of the reference's pretrain_src/utils/mlabel_utils.py: per-class and
macro ROC-AUC / F1 for the SEM / MaskSem proxy-task validators
(train_r2r.py:430-510). sklearn's roc_auc_score is replaced by a direct
numpy rank-statistic AUC (ties handled by midranks). A class whose labels
are all one value has no AUC (nan) and drops out of the macro mean.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

# Matterport3D 40-category nomenclature (standard mpcat40 ordering; the ids
# are the dataset's public label set, ref mlabel_utils.py ID2LABEL)
MP3D_CATEGORIES = [
    "void/misc", "wall", "floor", "chair", "door", "table", "picture",
    "cabinet", "cushion", "window", "sofa", "bed", "curtain",
    "chest_of_drawers", "plant", "sink", "stairs", "ceiling", "toilet",
    "stool", "towel", "mirror", "tv_monitor", "shower", "column", "bathtub",
    "counter", "fireplace", "lighting", "beam", "railing", "shelving",
    "blinds", "gym_equipment", "seating", "board_panel", "furniture",
    "appliances", "clothes", "objects",
]


def binary_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """ROC-AUC via the rank-sum statistic (equivalent to sklearn's
    roc_auc_score for binary labels); nan when one class is absent."""
    labels = np.asarray(labels).astype(bool)
    n_pos = int(labels.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), np.float64)
    sorted_scores = np.asarray(scores)[order]
    # midranks for ties
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    rank_sum = ranks[labels].sum()
    return float((rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def multilabel_report(
    scores: np.ndarray,
    labels: np.ndarray,
    threshold: float = 0.5,
    class_names: Optional[list] = None,
) -> Dict[str, float]:
    """scores/labels: (N, C). Returns macro AUC/F1 + per-class AUC entries
    (ref MultiLabelReport / AUC / F1Score, mlabel_utils.py)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels) > 0.5
    n, c = scores.shape
    names = class_names or [str(i) for i in range(c)]
    out: Dict[str, float] = {}
    aucs, f1s = [], []
    preds = scores >= threshold
    for k in range(c):
        auc = binary_auc(scores[:, k], labels[:, k])
        out[f"auc/{names[k]}"] = auc
        if not np.isnan(auc):
            aucs.append(auc)
        tp = int((preds[:, k] & labels[:, k]).sum())
        fp = int((preds[:, k] & ~labels[:, k]).sum())
        fn = int((~preds[:, k] & labels[:, k]).sum())
        if tp + fp + fn:
            f1s.append(2 * tp / max(2 * tp + fp + fn, 1))
    out["auc_macro"] = float(np.mean(aucs)) if aucs else float("nan")
    out["f1_macro"] = float(np.mean(f1s)) if f1s else float("nan")
    out["accuracy_thresh"] = float((preds == labels).mean())
    return out
