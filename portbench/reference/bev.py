"""The BEV lift and egocentric scatter-mean as plain tensor operations (a
frozen copy of ``vln_bevbert_tpu_torch/ops/bev.py`` with the splat written
as a float32 ``index_add_``: no kernel, no bf16 rounding of the features).

Pixels are lifted along per-pixel rays to world points, moved into the
egocentric frame of the map centre, binned into ``map_dim`` x ``map_dim``
cells of ``map_res`` metres (points above ``z_clip`` or outside the grid, and
pixels without depth, are dropped), and each cell takes the mean of its
points' features, the presence of each semantic label and its point count.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .geometry import pixel_ray_scales


class Projector:
    def __init__(self, grid_hw: int, num_views: int, map_dim: int, map_res: float,
                 num_sem: int = 40, z_clip: float = 0.5, vfov: float = math.radians(90.0),
                 device=None):
        self.grid_hw, self.num_views = grid_hw, num_views
        self.map_dim, self.map_res, self.z_clip = map_dim, map_res, z_clip
        self.num_sem = num_sem
        self.num_cells = map_dim * map_dim
        xs, ys = pixel_ray_scales(grid_hw, grid_hw, vfov)
        self.ray = torch.from_numpy(np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
                                    ).to(device)

    def lift(self, depths: torch.Tensor, T_c2w: torch.Tensor):
        """depths (B, V, H, W) metres, T_c2w (B, V, 4, 4) -> (points (B, V*H*W, 3),
        no_depth (B, V*H*W))."""
        b, v, h, w = depths.shape
        d = depths.reshape(b, v, h * w).float()
        ray = self.ray.to(d.device)
        cam = torch.stack([d * ray[:, 0], d * ray[:, 1], d, torch.ones_like(d)], -1)
        world = torch.einsum("bvij,bvpj->bvpi", T_c2w.float(), cam)
        return world[..., :3].reshape(b, v * h * w, 3), (d == 0).reshape(b, v * h * w)

    def cells(self, points: torch.Tensor, T_w2c: torch.Tensor, S_w2c: torch.Tensor):
        """(cell (B, N) long, valid (B, N) bool) in the egocentric grid."""
        ego = torch.einsum("bij,bpj->bpi", T_w2c[:, :3, :3].float(),
                           points - S_w2c.float()[:, None, :])
        half = (self.map_dim - 1) // 2
        gx = torch.round(ego[..., 0] / self.map_res) + half
        gz = torch.round(ego[..., 2] / self.map_res) + half
        valid = ((gx >= 0) & (gx < self.map_dim) & (gz >= 0) & (gz < self.map_dim)
                 & (ego[..., 1] <= self.z_clip))
        cell = (gz * self.map_dim + gx).long().clamp(0, self.num_cells - 1)
        return cell, valid

    def scatter_sums(self, cell, valid, feats, sem_labels=None):
        """(B, cells, F [+ num_sem] + 1) float32 sums of ``[feats | one_hot |
        1]`` over the valid points of each cell."""
        b, n = cell.shape
        cols = [feats.float()]
        if sem_labels is not None:
            cols.append(F.one_hot(sem_labels.long(), self.num_sem).float())
        cols.append(torch.ones(b, n, 1, device=feats.device))
        payload = torch.cat(cols, -1) * valid[..., None].float()
        rows = (torch.arange(b, device=cell.device)[:, None] * self.num_cells + cell).reshape(-1)
        out = torch.zeros(b * self.num_cells, payload.shape[-1], device=feats.device)
        out.index_add_(0, rows, payload.reshape(b * n, -1))
        return out.reshape(b, self.num_cells, -1)

    def splat(self, cell, valid, feats, sem_labels=None):
        """(mean features (B, cells, F), sem presence or None, sem mask or None)."""
        c = feats.shape[-1]
        sums = self.scatter_sums(cell, valid, feats, sem_labels)
        bev = sums[..., :c] / sums[..., -1:].clamp_min(1.0)
        if sem_labels is None:
            return bev, None, None
        sem = sums[..., c:c + self.num_sem] > 0
        return bev, sem.float(), sem.any(-1)

    def lift_splat(self, depths, T_c2w, T_w2c, S_w2c, feats, sem_labels=None):
        points, no_depth = self.lift(depths, T_c2w)
        cell, valid = self.cells(points, T_w2c, S_w2c)
        return self.splat(cell, valid & ~no_depth, feats, sem_labels)

    def valid_points(self, depths, T_c2w, T_w2c, S_w2c) -> torch.Tensor:
        """(B,) number of points that land in a cell."""
        points, no_depth = self.lift(depths, T_c2w)
        _, valid = self.cells(points, T_w2c, S_w2c)
        return (valid & ~no_depth).sum(-1)
