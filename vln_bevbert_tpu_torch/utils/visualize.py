"""BEV / trajectory debug visualisation (host copy of
``vln_bevbert_tpu/utils/visualize.py``).

Role of the reference's bev_visualize modules
(map_nav_src/models/bev_visualize.py,
pretrain_src/model/bev_visualize.py — debug-only, guarded by viz flags at the
call sites): renders BEV occupancy, candidate cells and top-down trajectories
to images. cv2 optional; arrays returned either way.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def render_bev_mask(
    occupancy: np.ndarray,
    cand_cells: Optional[np.ndarray] = None,
    scale: int = 12,
) -> np.ndarray:
    """(cells,) or (dim, dim) occupancy -> (H, W, 3) uint8 image; occupied
    cells white, candidate cells green (ref lift_splat viz block,
    pretrain_cmt.py:139-150)."""
    occ = np.asarray(occupancy)
    if occ.ndim == 1:
        dim = int(round(len(occ) ** 0.5))
        occ = occ.reshape(dim, dim)
    dim = occ.shape[0]
    img = np.zeros((dim, dim, 3), np.uint8)
    img[occ.astype(bool)] = (255, 255, 255)
    if cand_cells is not None:
        for cell in np.asarray(cand_cells).reshape(-1):
            img[int(cell) // dim, int(cell) % dim] = (0, 255, 0)
    return np.kron(img, np.ones((scale, scale, 1), np.uint8))


def render_topdown_traj(
    positions: Sequence[Sequence[float]],
    gt_positions: Optional[Sequence[Sequence[float]]] = None,
    size: int = 320,
    margin: float = 1.0,
) -> np.ndarray:
    """Top-down polyline render of a walked path (blue) vs the reference
    path (green); start marked red."""
    img = np.zeros((size, size, 3), np.uint8)
    pts = [np.asarray(positions, np.float64)]
    if gt_positions is not None:
        pts.append(np.asarray(gt_positions, np.float64))
    allp = np.concatenate(pts, 0)
    lo = allp[:, [0, 2]].min(0) - margin
    hi = allp[:, [0, 2]].max(0) + margin
    span = np.maximum(hi - lo, 1e-6)

    def to_px(p):
        xy = (np.asarray(p)[[0, 2]] - lo) / span
        return int(xy[0] * (size - 1)), int(xy[1] * (size - 1))

    def draw_line(a, b, color):
        ax, ay = to_px(a)
        bx, by = to_px(b)
        n = max(abs(bx - ax), abs(by - ay), 1)
        for s in range(n + 1):
            x = ax + (bx - ax) * s // n
            y = ay + (by - ay) * s // n
            img[max(0, y - 1) : y + 2, max(0, x - 1) : x + 2] = color

    if gt_positions is not None:
        for a, b in zip(gt_positions[:-1], gt_positions[1:]):
            draw_line(a, b, (0, 255, 0))
    for a, b in zip(positions[:-1], positions[1:]):
        draw_line(a, b, (255, 128, 0))
    sx, sy = to_px(positions[0])
    img[max(0, sy - 3) : sy + 4, max(0, sx - 3) : sx + 4] = (0, 0, 255)
    return img


def save_image(path: str, img: np.ndarray):
    try:
        import cv2

        cv2.imwrite(path, img[..., ::-1])  # RGB -> BGR
    except ImportError:  # pragma: no cover
        from PIL import Image

        Image.fromarray(img).save(path)
