"""Discrete navigation environments.

The reference binds the MatterSim C++ simulator with rendering disabled and
uses it purely as a navigation-graph state machine
(reference map_nav_src/r2r/env.py:28-92, setRenderingEnabled(False)).
``GraphSimulator`` reimplements exactly that state machine over the
connectivity graphs, making the whole fine-tuning pipeline testable and
runnable without C++ sims; a real-MatterSim binding can drop in behind the
same ``new_episode/get_state`` surface. A C++ engine for the heavy host-side
graph math lives in native/ (optional, same semantics).

``R2RNavBatch`` provides minibatch cycling, candidate construction, agent
observations (with the rgb/depth camera-ring roll to agent-relative order,
ref env.py:246-262) and the navigation metrics (env.py:308-377). Its
``reset``, ``get_obs`` and ``teleport`` are the spans ``env.reset``,
``env.get_obs`` and ``env.teleport`` (``utils/profiling.py``). As
data-parallel rank ``rank`` of ``world`` it cycles the global batch of
``batch_size`` episodes, with every draw over its rows, and simulates rows
``[rank * b, (rank + 1) * b)`` of it, b = ``batch_size / world``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..geometry import (
    angle_features,
    nearest_anchor,
    normalize_angle,
    rel_pos_features,
    view_rel_angles,
)
from ..data.nav_graph import NavGraph
from ..utils import profiling
from .eval_utils import compute_cls, compute_dtw_metrics

ERROR_MARGIN = 3.0
ANCHOR_E = np.radians([-30.0, 0.0, 30.0])


@dataclass
class SimState:
    scan: str = ""
    viewpoint: str = ""
    heading: float = 0.0
    elevation: float = 0.0

    @property
    def view_index(self) -> int:
        ring = nearest_anchor(self.elevation, ANCHOR_E)
        return ring * 12 + nearest_anchor(self.heading)


class GraphSimulator:
    """MatterSim-equivalent state machine for one episode slot."""

    def __init__(self, graphs: Dict[str, NavGraph]):
        self.graphs = graphs
        self.state = SimState()

    def new_episode(self, scan: str, viewpoint: str, heading: float,
                    elevation: float = 0.0):
        assert viewpoint in self.graphs[scan].index, (scan, viewpoint)
        self.state = SimState(scan, viewpoint, heading, elevation)

    def get_state(self) -> SimState:
        return self.state


class EnvBatch:
    """N simulator slots + feature stores (ref EnvBatch, env.py:28-92)."""

    def __init__(self, graphs, view_db, grid_db=None, depth_db=None,
                 batch_size: int = 4):
        self.graphs = graphs
        self.view_db = view_db
        self.grid_db = grid_db
        self.depth_db = depth_db
        self.sims = [GraphSimulator(graphs) for _ in range(batch_size)]

    def new_episodes(self, scans, viewpoints, headings):
        for sim, scan, vp, h in zip(self.sims, scans, viewpoints, headings):
            sim.new_episode(scan, vp, h)

    def get_states(self):
        out = []
        for sim in self.sims:
            s = sim.get_state()
            view_fts = self.view_db.get(s.scan, s.viewpoint)
            grid = (
                self.grid_db.get(s.scan, s.viewpoint)
                if self.grid_db is not None else None
            )
            depth = (
                self.depth_db.get(s.scan, s.viewpoint)
                if self.depth_db is not None else None
            )
            out.append((view_fts, grid, depth, s))
        return out


class R2RNavBatch:
    def __init__(
        self,
        instr_data: Sequence[dict],
        graphs: Dict[str, NavGraph],
        scanvp_cands: Dict[str, Dict[str, list]],
        view_db,
        grid_db=None,
        depth_db=None,
        batch_size: int = 4,
        angle_feat_size: int = 4,
        image_feat_size: int = 512,
        seed: int = 0,
        name: str = "train",
        rank: int = 0,
        world: int = 1,
    ):
        if batch_size % world or not 0 <= rank < world:
            raise ValueError(f"rank {rank} of {world} cannot hold a share of batch {batch_size}")
        self.data = list(instr_data)
        self.graphs = graphs
        self.scanvp_cands = scanvp_cands
        self.rank, self.world = rank, world
        self.env = EnvBatch(graphs, view_db, grid_db, depth_db, batch_size // world)
        self.batch_size = batch_size
        self.angle_feat_size = angle_feat_size
        self.image_feat_size = image_feat_size
        self.name = name
        self.gt_trajs = {
            x["instr_id"]: (x["scan"], x["path"])
            for x in self.data if len(x["path"]) > 1
        }
        self.rng = np.random.default_rng(seed)
        self.rng.shuffle(self.data)
        self.ix = 0
        self.batch: List[dict] = []
        # (36, A) angle features per base view
        self._view_angle_fts = [
            angle_features(a[:, 0], a[:, 1], angle_feat_size)
            for a in (view_rel_angles(i) for i in range(36))
        ]

    def size(self) -> int:
        return len(self.data)

    # ------------------------------------------------------------- minibatch
    def next_minibatch(self):
        if not self.data:
            raise ValueError(
                f"{type(self).__name__} has no episodes to batch "
                "(empty annotation split?)"
            )
        batch = self.data[self.ix : self.ix + self.batch_size]
        if len(batch) < self.batch_size:
            # wrap; loops as often as needed so datasets smaller than the
            # global batch (tiny val splits x dp devices) still fill every
            # simulator slot
            self.rng.shuffle(self.data)
            self.ix = 0
            while len(batch) < self.batch_size:
                take = min(self.batch_size - len(batch), len(self.data))
                batch = batch + self.data[self.ix : self.ix + take]
                self.ix = (self.ix + take) % max(len(self.data), 1)
                if take == len(self.data):
                    self.ix = 0
        else:
            self.ix += self.batch_size
        self.batch = batch

    def reset_epoch(self, shuffle: bool = False):
        if shuffle:
            self.rng.shuffle(self.data)
        self.ix = 0

    # ------------------------------------------------------------ candidates
    def make_candidates(self, scan: str, viewpoint: str, base_heading: float,
                        view_fts: np.ndarray) -> List[dict]:
        g = self.graphs[scan]
        cands = []
        for i, nb in enumerate(g.neighbors(viewpoint)):
            h_abs, e_abs, _ = rel_pos_features(
                g.position(viewpoint), g.position(nb)
            )
            point_id = (
                nearest_anchor(e_abs, ANCHOR_E) * 12 + nearest_anchor(h_abs)
            )
            rel_h = float(normalize_angle(h_abs - base_heading))
            ang = angle_features([rel_h], [e_abs], self.angle_feat_size)[0]
            cands.append(
                {
                    "viewpointId": nb,
                    "pointId": int(point_id),
                    "idx": i + 1,
                    "heading": rel_h,
                    "elevation": float(e_abs),
                    "position": tuple(g.position(nb)),
                    "feature": np.concatenate(
                        [view_fts[point_id][: self.image_feat_size], ang]
                    ).astype(np.float32),
                }
            )
        return cands

    # ----------------------------------------------------------- observations
    def get_obs(self) -> List[dict]:
        with profiling.span("env.get_obs"):
            return self._observations()

    def _observations(self) -> List[dict]:
        obs = []
        for i, (view_fts, grid, depth, state) in enumerate(self.env.get_states()):
            item = self.batch[i]
            base_view = state.view_index
            # roll the camera ring so slot 0 faces the agent's heading
            # (ref env.py:250-256; generalised to V cameras)
            n_cam = grid.shape[0] if grid is not None else 12
            cam_anchors = np.arange(n_cam) * (2 * math.pi / n_cam)
            front = nearest_anchor(state.heading, cam_anchors)
            roll = np.roll(np.arange(n_cam), -front)
            ob = {
                "instr_id": item["instr_id"],
                "scan": state.scan,
                "viewpoint": state.viewpoint,
                "viewIndex": base_view,
                "position": tuple(
                    self.graphs[state.scan].position(state.viewpoint)
                ),
                "heading": state.heading,
                "elevation": state.elevation,
                "feature": np.concatenate(
                    [
                        view_fts[:, : self.image_feat_size],
                        self._view_angle_fts[base_view],
                    ],
                    axis=-1,
                ).astype(np.float32),
                "candidate": self.make_candidates(
                    state.scan, state.viewpoint, state.heading, view_fts
                ),
                "instr_encoding": item["instr_encoding"],
                "gt_path": item["path"],
            }
            if grid is not None:
                ob["rgb"] = grid[roll]          # (12, H*W, C) agent-relative
            if depth is not None:
                ob["depth"] = depth[roll]       # (12, H, W), metres/10
            obs.append(ob)
        return obs

    def reset(self) -> List[dict]:
        with profiling.span("env.reset"):
            self.next_minibatch()
            b = self.batch_size // self.world
            self.batch = self.batch[self.rank * b:(self.rank + 1) * b]
            self.env.new_episodes(
                [b["scan"] for b in self.batch],
                [b["path"][0] for b in self.batch],
                [b.get("heading", 0.0) for b in self.batch],
            )
            return self._observations()

    def teleport(self, slot: int, viewpoint: str, heading: float):
        with profiling.span("env.teleport"):
            sim = self.env.sims[slot]
            sim.new_episode(sim.state.scan, viewpoint, heading)

    # ------------------------------------------------------------------ eval
    def shortest_distance(self, scan: str, a: str, b: str) -> float:
        return self.graphs[scan].distance(a, b)

    def eval_item(self, scan: str, pred_path: List[List[str]],
                  gt_path: List[str]) -> Dict[str, float]:
        g = self.graphs[scan]
        dist = g.distance
        path = sum(pred_path, [])
        assert path[0] == gt_path[0], "trajectory must include the start"
        nearest = min(path, key=lambda vp: dist(vp, gt_path[-1]))
        scores = {
            "nav_error": dist(path[-1], gt_path[-1]),
            "oracle_error": dist(nearest, gt_path[-1]),
            "action_steps": len(pred_path) - 1,
            "trajectory_steps": len(path) - 1,
            "trajectory_lengths": float(
                np.sum([dist(a, b) for a, b in zip(path[:-1], path[1:])])
            ),
        }
        gt_length = float(
            np.sum([dist(a, b) for a, b in zip(gt_path[:-1], gt_path[1:])])
        )
        scores["success"] = float(scores["nav_error"] < ERROR_MARGIN)
        scores["spl"] = (
            scores["success"] * gt_length
            / max(scores["trajectory_lengths"], gt_length, 0.01)
        )
        scores["oracle_success"] = float(scores["oracle_error"] < ERROR_MARGIN)
        scores.update(
            compute_dtw_metrics(dist, path, gt_path, scores["success"], ERROR_MARGIN)
        )
        scores["CLS"] = compute_cls(dist, path, gt_path, ERROR_MARGIN)
        return scores

    def eval_metrics(self, preds: Sequence[dict]):
        from collections import defaultdict

        metrics = defaultdict(list)
        for item in preds:
            scan, gt = self.gt_trajs[item["instr_id"]]
            for k, v in self.eval_item(scan, item["trajectory"], gt).items():
                metrics[k].append(v)
        avg = {
            "action_steps": float(np.mean(metrics["action_steps"])),
            "steps": float(np.mean(metrics["trajectory_steps"])),
            "lengths": float(np.mean(metrics["trajectory_lengths"])),
            "nav_error": float(np.mean(metrics["nav_error"])),
            "oracle_error": float(np.mean(metrics["oracle_error"])),
            "sr": float(np.mean(metrics["success"]) * 100),
            "oracle_sr": float(np.mean(metrics["oracle_success"]) * 100),
            "spl": float(np.mean(metrics["spl"]) * 100),
            "nDTW": float(np.mean(metrics["nDTW"]) * 100),
            "SDTW": float(np.mean(metrics["SDTW"]) * 100),
            "CLS": float(np.mean(metrics["CLS"]) * 100),
        }
        return avg, dict(metrics)
