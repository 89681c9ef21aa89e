"""BEV projector: depth lift + egocentric scatter-mean splat.

Port of ``vln_bevbert_tpu/ops/bev.py``. The lift (pixel -> camera ray ->
world point) is an einsum over precomputed per-pixel ray scales; the splat
hands the cells, the feature rows where they lie and the semantic labels to
``ops/splat.py:splat_sums`` (the CUDA kernel on the card), which sums the
``[features | semantic one-hot | ones]`` payload of the JAX package's
one-hot contraction / Pallas kernel without building it.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..geometry import pixel_ray_scales
from .splat import splat_sums


class BevProjector:
    """Static-shape BEV lift-splat.

    vfov in radians, the feature-grid height/width, map_dim cells of map_res
    metres, and the above-camera clip threshold (points with ego y > z_clip
    are dropped). ``device`` holds the per-pixel ray scales: lifting depths
    that lie there uploads nothing."""

    def __init__(
        self,
        vfov: float = math.radians(90.0),
        grid_hw: int = 14,
        num_views: int = 12,
        map_dim: int = 21,
        map_res: float = 0.5,
        z_clip: float = 0.5,
        num_sem: int = 40,
        device=None,
    ):
        self.vfov = vfov
        self.grid_hw = grid_hw
        self.num_views = num_views
        self.map_dim = map_dim
        self.map_res = map_res
        self.z_clip = z_clip
        self.num_sem = num_sem
        self.num_cells = map_dim * map_dim
        self.num_points = num_views * grid_hw * grid_hw
        x_scale, y_scale = pixel_ray_scales(grid_hw, grid_hw, vfov)
        # (H*W, 2): per-pixel ray direction scales, shared by every camera
        self._ray_xy = torch.from_numpy(
            np.stack([x_scale.ravel(), y_scale.ravel()], axis=-1).astype(np.float32)
        ).to(device)

    # ------------------------------------------------------------------ lift
    def lift(self, depths: torch.Tensor, T_c2w: torch.Tensor):
        """depths (B, V, H, W) metres; T_c2w (B, V, 4, 4) camera-to-world.

        Returns (points (B, V*H*W, 3) world xyz, no_depth (B, V*H*W) bool)."""
        b, v, h, w = depths.shape
        d = depths.reshape(b, v, h * w).float()
        ray = self._ray_xy.to(d.device)
        cam = torch.stack(
            [d * ray[None, None, :, 0], d * ray[None, None, :, 1], d,
             torch.ones_like(d)],
            dim=-1,
        )  # (B, V, HW, 4)
        world = torch.einsum("bvij,bvpj->bvpi", T_c2w.float(), cam)
        pts = world[..., :3].reshape(b, v * h * w, 3)
        no_depth = (d == 0).reshape(b, v * h * w)
        return pts, no_depth

    # ----------------------------------------------------------------- cells
    def ego_cells(self, points: torch.Tensor, T_w2c: torch.Tensor, S_w2c: torch.Tensor):
        """points (B, N, 3); T_w2c (B, 4, 4) ego rotation; S_w2c (B, 3) map
        centre. Returns (cell (B, N) int32, valid (B, N) bool)."""
        shifted = points - S_w2c.float()[:, None, :]
        ego = torch.einsum("bij,bpj->bpi", T_w2c[:, :3, :3].float(), shifted)
        half = (self.map_dim - 1) // 2
        # torch.round rounds half to even, as jnp.round does
        gx = torch.round(ego[:, :, 0] / self.map_res) + half
        gz = torch.round(ego[:, :, 2] / self.map_res) + half
        inside = (gx >= 0) & (gx < self.map_dim) & (gz >= 0) & (gz < self.map_dim)
        below_ceiling = ego[:, :, 1] <= self.z_clip
        # clipped after the in-grid test: out-of-grid points are masked anyway
        cell = (gz * self.map_dim + gx).to(torch.int32).clamp(0, self.num_cells - 1)
        return cell, inside & below_ceiling

    # ----------------------------------------------------------------- splat
    def splat(
        self,
        cell: torch.Tensor,
        valid: torch.Tensor,
        feats: torch.Tensor,
        sem_labels: Optional[torch.Tensor] = None,
        step_sel: Optional[torch.Tensor] = None,
    ):
        """Masked scatter-mean of point features into grid cells.

        cell (B, N) int32; valid (B, N) bool; feats (B, N, C), or (B, T, P, C)
        read through ``step_sel`` (B, S) with N = S * P (``splat_sums``);
        sem_labels optional (B, N) int. Returns (bev (B, cells, C) f32,
        occupancy (B, cells) bool, sem (B, cells, num_sem) presence in {0, 1}
        or None, sem_mask (B, cells) or None)."""
        c = feats.shape[-1]
        # poisoned cell: invalid points get -1 and land in no cell
        cell_eff = torch.where(valid, cell, torch.full_like(cell, -1)).to(torch.int32)
        sums = splat_sums(cell_eff.contiguous(), feats, self.num_cells, step_sel=step_sel,
                          sem_labels=sem_labels, num_sem=self.num_sem)
        counts = sums[:, :, -1]
        bev = sums[:, :, :c] / counts.clamp_min(1.0)[:, :, None]
        occupancy = counts > 0
        if sem_labels is None:
            return bev, occupancy, None, None
        sem_sum = sums[:, :, c : c + self.num_sem]
        return bev, occupancy, (sem_sum > 0).float(), (sem_sum > 0).any(dim=-1)

    # ------------------------------------------------------------- end-to-end
    def lift_splat(self, depths, T_c2w, T_w2c, S_w2c, feats, sem_labels=None):
        """depths (B, V, H, W) metres; T_c2w (B, V, 4, 4); T_w2c (B, 4, 4);
        S_w2c (B, 3); feats (B, V*H*W, C); sem_labels optional (B, V*H*W)."""
        points, no_depth = self.lift(depths, T_c2w)
        cell, geo_valid = self.ego_cells(points, T_w2c, S_w2c)
        return self.splat(cell, geo_valid & ~no_depth, feats, sem_labels)
