"""Continuous-environment interface + synthetic simulator.

The reference runs habitat-sim in subprocess VectorEnvs with oracle RPC calls
(bevbert_ce/vlnce_baselines/common/environments.py:44-520,
common/env_utils.py:35-126). Habitat is a host-side C++ dependency that is
not part of the TPU compute path; this module defines the narrow surface the
trainer needs (``ContinuousEnvBatch``) and a synthetic open-plane
implementation of it, so the full CE pipeline is runnable and testable here.
A real habitat binding implements the same surface: reset/observations,
teleport-style stepping, and the oracle queries (distance-to-goal from
arbitrary positions) used by the scheduled-sampling teacher
(ss_trainer_BEV.py:317-345).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from .geometry_ce import heading_from_quaternion, quaternion_from_heading

SUCCESS_DISTANCE = 3.0


@dataclass
class CEEpisode:
    episode_id: str
    instr_encoding: np.ndarray
    start_pos: np.ndarray            # (3,)
    start_heading: float
    gt_positions: np.ndarray         # (T, 3) reference path positions
    goal: np.ndarray                 # (3,)


class SyntheticContinuousEnv:
    """Open-plane world: geodesic == euclidean; per-pose sensor features are
    deterministic functions of (episode, position) so rollouts are
    reproducible. One instance manages B episode slots (the reference's
    VectorEnv role).

    Under data parallelism rank ``rank`` of ``world`` holds b = B / world
    slots: ``reset`` cycles the global batch of ``batch_size`` episodes and
    keeps its rows ``[rank * b, (rank + 1) * b)`` (``nav/env.py``'s
    ``R2RNavBatch`` does the same). The sensors key on the episode and the
    position, not the slot, so a row draws what it draws in the global env."""

    def __init__(
        self,
        episodes: Sequence[CEEpisode],
        batch_size: int = 2,
        num_views: int = 12,
        grid_hw: int = 14,
        grid_feat_size: int = 768,
        view_feat_size: int = 512,
        depth_feat_shape=(128, 4, 4),
        seed: int = 0,
        obstacles: Optional[Sequence] = None,
        rank: int = 0,
        world: int = 1,
    ):
        if batch_size % world or not 0 <= rank < world:
            raise ValueError(f"rank {rank} of {world} cannot hold a share of batch {batch_size}")
        self.episodes = list(episodes)
        self.batch_size = batch_size
        self.rank, self.world = rank, world
        slots = batch_size // world
        self.num_views = num_views
        self.grid_hw = grid_hw
        self.grid_feat_size = grid_feat_size
        self.view_feat_size = view_feat_size
        self.depth_feat_shape = depth_feat_shape
        self.rng = np.random.default_rng(seed)
        self.ix = 0
        self.batch: List[CEEpisode] = []
        self.positions = np.zeros((slots, 3))
        self.headings = np.zeros(slots)
        self.active = np.zeros(slots, bool)
        # low-level control surface (habitat defaults: TURN 30deg, FWD 0.25m)
        self.turn_unit = math.radians(30.0)
        self.forward_unit = 0.25
        # circular obstacles in the xz plane: (cx, cz, radius) rows
        self.obstacles = (
            np.asarray(obstacles, np.float64).reshape(-1, 3)
            if obstacles is not None else np.zeros((0, 3))
        )
        self._collided = np.zeros(slots, bool)

    def size(self) -> int:
        return len(self.episodes)

    # accessors for the subprocess pool (ce/env_pool.py gathers these)
    def get_headings(self) -> np.ndarray:
        return self.headings.copy()

    def get_positions(self) -> np.ndarray:
        return self.positions.copy()

    def get_batch(self):
        return list(self.batch)

    def reset_epoch(self):
        self.ix = 0

    def reset(self) -> List[dict]:
        batch = self.episodes[self.ix : self.ix + self.batch_size]
        if len(batch) < self.batch_size:
            self.ix = self.batch_size - len(batch)
            batch = batch + self.episodes[: self.ix]
        else:
            self.ix += self.batch_size
        b = self.batch_size // self.world
        self.batch = batch = batch[self.rank * b:(self.rank + 1) * b]
        for i, ep in enumerate(batch):
            self.positions[i] = ep.start_pos
            self.headings[i] = ep.start_heading
            self.active[i] = True
        return self.observations()

    # ----------------------------------------------------------- observations
    def _pose_rng(self, slot: int, salt: int = 0) -> np.random.Generator:
        # stable across processes AND runs — python's hash() of strings is
        # salted per interpreter (spawn-mode env workers would disagree with
        # the parent)
        import zlib

        ep = self.batch[slot]
        tag = (
            f"{ep.episode_id}|{round(float(self.positions[slot][0]), 1)}"
            f"|{round(float(self.positions[slot][2]), 1)}|{salt}"
        )
        return np.random.default_rng(zlib.crc32(tag.encode()))

    def observations(self) -> List[dict]:
        out = []
        for i, ep in enumerate(self.batch):
            r = self._pose_rng(i)
            hw = self.grid_hw
            obs = {
                "episode_id": ep.episode_id,
                "instr_id": ep.episode_id,
                "instr_encoding": ep.instr_encoding,
                "position": self.positions[i].copy(),
                "heading": float(self.headings[i]),
                "orientation": quaternion_from_heading(float(self.headings[i])),
                "view_fts": r.normal(
                    size=(self.num_views, self.view_feat_size)
                ).astype(np.float32),
                "rgb": r.normal(
                    size=(self.num_views, hw * hw, self.grid_feat_size)
                ).astype(np.float32),
                "depth": r.uniform(
                    0.05, 0.9, (self.num_views, hw, hw)
                ).astype(np.float32),
                "depth_features": r.normal(
                    size=(self.num_views, *self.depth_feat_shape)
                ).astype(np.float32),
                "gt_path": ep.gt_positions,
                "goal": ep.goal,
            }
            out.append(obs)
        return out

    # ----------------------------------------------------------------- action
    def teleport(self, slot: int, position, heading: Optional[float] = None):
        self.positions[slot] = np.asarray(position, np.float64)
        if heading is not None:
            self.headings[slot] = heading % (2 * math.pi)

    def stop(self, slot: int):
        self.active[slot] = False

    # -------------------------------------------------- low-level primitives
    # (the surface the reference's HIGHTOLOW control drives on habitat:
    # TURN_LEFT/TURN_RIGHT/MOVE_FORWARD with previous_step_collided —
    # habitat_extensions/nav.py:38-56, environments.py:340-358)
    def rotate(self, slot: int, angle: float):
        """Rotate by a signed angle (already discretized by the controller;
        turns never collide)."""
        self.headings[slot] = (self.headings[slot] + angle) % (2 * math.pi)

    def forward_step(self, slot: int) -> bool:
        """One MOVE_FORWARD unit; returns True if the step collided (the
        agent then does not move, matching habitat's slide-less default)."""
        h = self.headings[slot]
        new = self.positions[slot] + self.forward_unit * np.array(
            [-math.sin(h), 0.0, -math.cos(h)]
        )
        if self._blocked(new):
            self._collided[slot] = True
            return True
        self.positions[slot] = new
        self._collided[slot] = False
        return False

    def previous_step_collided(self, slot: int) -> bool:
        return bool(self._collided[slot])

    def _blocked(self, pos) -> bool:
        if not len(self.obstacles):
            return False
        d = np.hypot(
            self.obstacles[:, 0] - pos[0], self.obstacles[:, 1] - pos[2]
        )
        return bool((d < self.obstacles[:, 2]).any())

    # ----------------------------------------------------------------- oracle
    def geodesic(self, slot: int, a, b) -> float:
        """Open plane: geodesic == euclidean. A habitat binding forwards to
        sim.geodesic_distance (ref environments.py:108-121)."""
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        return float(np.linalg.norm(a - b))

    def dist_to_goal(self, slot: int, position=None) -> float:
        pos = self.positions[slot] if position is None else position
        return self.geodesic(slot, pos, self.batch[slot].goal)

    def dists_to_goal(self, slot: int, positions) -> np.ndarray:
        """Batched oracle: distance-to-goal for many query positions in ONE
        call, so teachers pay one RPC per step under the subprocess pool
        (one geodesic solve per candidate in a habitat binding)."""
        return np.asarray(
            [self.dist_to_goal(slot, p) for p in positions], np.float64
        )

    # ------------------------------------------------------------------- eval
    def eval_episode(self, slot: int, walked: np.ndarray) -> Dict[str, float]:
        """Positions-based CE metrics (ref ss_trainer_BEV.py:1184-1209 and
        habitat_extensions/measures.py NDTW exp(-dtw/(len*3)))."""
        return compute_ce_episode_metrics(
            walked, self.batch[slot].gt_positions,
            lambda p: self.dist_to_goal(slot, p),
        )


def compute_ce_episode_metrics(walked, gt, dist_to_goal) -> Dict[str, float]:
    """Shared CE metric math (synthetic env and the habitat binding):
    SR/OS/SPL/nDTW/SDTW/PL/steps from a walked position sequence.
    ``dist_to_goal(p)`` supplies the sim's geodesic to the episode goal."""
    walked = np.asarray(walked, np.float64)
    gt = np.asarray(gt, np.float64)
    d2g = dist_to_goal(walked[-1])
    path_len = float(
        np.sum(np.linalg.norm(np.diff(walked, axis=0), axis=1))
    ) if len(walked) > 1 else 0.0
    gt_len = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    success = float(d2g < SUCCESS_DISTANCE)
    oracle = float(min(dist_to_goal(p) for p in walked) < SUCCESS_DISTANCE)
    # DTW over positions: C++ kernel when the toolchain is present (role of
    # the reference's fastdtw dep, measures.py:266-336 — exact here), else
    # the numpy DP
    from ..native import dtw_positions

    m = len(gt)
    dtw = dtw_positions(walked, gt)
    if dtw is None:
        n = len(walked)
        acc = np.full((n + 1, m + 1), np.inf)
        acc[0, 0] = 0
        for a in range(1, n + 1):
            for b in range(1, m + 1):
                cost = float(np.linalg.norm(walked[a - 1] - gt[b - 1]))
                acc[a, b] = cost + min(acc[a - 1, b], acc[a, b - 1],
                                       acc[a - 1, b - 1])
        dtw = acc[n, m]
    ndtw = math.exp(-dtw / (m * SUCCESS_DISTANCE))
    return {
        "distance_to_goal": d2g,
        "success": success,
        "oracle_success": oracle,
        "path_length": path_len,
        "spl": success * gt_len / max(path_len, gt_len, 0.01),
        "ndtw": ndtw,
        "sdtw": success * ndtw,
        "steps_taken": float(len(walked) - 1),
    }


def make_synthetic_ce_episodes(
    rng: np.random.Generator, n: int = 8, extent: float = 10.0,
    txt_len=(10, 30), vocab_range=(1996, 29611),
) -> List[CEEpisode]:
    out = []
    for i in range(n):
        n_wp = int(rng.integers(3, 6))
        pts = np.zeros((n_wp, 3))
        pts[0, [0, 2]] = rng.uniform(0, extent, 2)
        for k in range(1, n_wp):
            step = rng.uniform(1.5, 3.0)
            ang = rng.uniform(0, 2 * math.pi)
            pts[k] = pts[k - 1] + np.array(
                [step * math.sin(ang), 0.0, step * math.cos(ang)]
            )
        enc = [101] + list(
            rng.integers(vocab_range[0], vocab_range[1], int(rng.integers(*txt_len)))
        ) + [102]
        out.append(
            CEEpisode(
                episode_id=f"ce_{i}",
                instr_encoding=np.asarray(enc),
                start_pos=pts[0].copy(),
                start_heading=float(rng.uniform(0, 2 * math.pi)),
                gt_positions=pts,
                goal=pts[-1].copy(),
            )
        )
    return out
