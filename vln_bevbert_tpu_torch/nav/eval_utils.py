"""Navigation-metric math: DTW family and CLS.

Parity with reference map_nav_src/r2r/eval_utils.py:6-40. ``dist`` is a
callable (u, v) -> geodesic distance (NavGraph.distance)."""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np


def compute_dtw_metrics(
    dist: Callable[[str, str], float],
    prediction: List[str],
    reference: List[str],
    success: float | None = None,
    threshold: float = 3.0,
) -> Dict[str, float]:
    n, m = len(prediction), len(reference)
    # ground costs are graph geodesics (host dict lookups); the DP runs in
    # C++ when available (native.dtw_costmatrix), else numpy
    costs = np.empty((n, m))
    for i in range(n):
        for j in range(m):
            costs[i, j] = dist(prediction[i], reference[j])
    from ..native import dtw_costmatrix

    dtw = dtw_costmatrix(costs)
    if dtw is None:
        acc = np.full((n + 1, m + 1), np.inf)
        acc[0, 0] = 0.0
        for i in range(1, n + 1):
            for j in range(1, m + 1):
                acc[i, j] = costs[i - 1, j - 1] + min(
                    acc[i - 1, j], acc[i, j - 1], acc[i - 1, j - 1]
                )
        dtw = acc[n, m]
    ndtw = float(np.exp(-dtw / (threshold * m)))
    if success is None:
        success = float(dist(prediction[-1], reference[-1]) < threshold)
    return {"DTW": float(dtw), "nDTW": ndtw, "SDTW": success * ndtw}


def compute_cls(
    dist: Callable[[str, str], float],
    prediction: List[str],
    reference: List[str],
    threshold: float = 3.0,
) -> float:
    def path_length(nodes):
        return float(
            np.sum([dist(a, b) for a, b in zip(nodes[:-1], nodes[1:])])
        )

    coverage = float(
        np.mean(
            [
                np.exp(-min(dist(u, v) for v in prediction) / threshold)
                for u in reference
            ]
        )
    )
    expected = coverage * path_length(reference)
    pred_len = path_length(prediction)
    score = expected / (expected + abs(expected - pred_len))
    return coverage * score
