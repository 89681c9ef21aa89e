"""Ghost-node topological map for continuous environments (host side).

Re-design of bevbert_ce/vlnce_baselines/models/graph_utils.py:
140-372: real nodes are visited positions; *ghost* nodes ('g'-prefixed) are
predicted-waypoint positions not yet visited, merged within ``loc_noise``
metres, with running-mean positions/embeddings and front-node lists. The
reference recomputes networkx all-pairs Dijkstra after every step
(graph_utils.py:261-262); here the incremental Floyd relaxation through the
newly-added node is exact (all new edges touch the new node) and runs in the
native C++ engine when available.
"""

from __future__ import annotations

import math
from copy import deepcopy
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..geometry import angle_features
from .geometry_ce import (
    estimate_cand_pos,
    heading_from_quaternion,
    rel_pos_features_ce,
)

MAX_DIST = 30.0
MAX_STEP = 10.0


def _dist(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64)))


class CEGraphMap:
    def __init__(self, has_real_pos: bool = False, loc_noise: float = 0.5,
                 merge_ghost: bool = True, ghost_aug: float = 0.0,
                 rng: Optional[np.random.Generator] = None,
                 use_native: Optional[bool] = None):
        from ..nav.graph_map import make_floyd_graph

        self.graph = make_floyd_graph(use_native)
        self.node_pos: Dict[str, np.ndarray] = {}
        self.node_embeds: Dict[str, np.ndarray] = {}
        self.node_step_ids: Dict[str, int] = {}
        self.ghost_cnt = 0
        self.ghost_pos: Dict[str, List[np.ndarray]] = {}
        self.ghost_mean_pos: Dict[str, np.ndarray] = {}
        self.ghost_aug_pos: Dict[str, np.ndarray] = {}
        self.ghost_embeds: Dict[str, List] = {}   # [sum, count]
        self.ghost_fronts: Dict[str, List[str]] = {}
        self.ghost_real_pos: Dict[str, List[np.ndarray]] = {}
        self.has_real_pos = has_real_pos
        self.merge_ghost = merge_ghost
        self.ghost_aug = ghost_aug
        self.loc_noise = loc_noise
        self.rng = rng or np.random.default_rng(0)
        self.node_pc_step: Dict[str, int] = {}
        self.node_stop_scores: Dict[str, float] = {}

    # ------------------------------------------------------------- localise
    def _localize(self, qpos, kpos_dict, ignore_height: bool = False):
        """Nearest key within loc_noise metres (ref graph_utils.py:166-180)."""
        best_vp, best = None, math.inf
        q = np.asarray(qpos, np.float64)
        for kvp, kpos in kpos_dict.items():
            k = np.asarray(kpos, np.float64)
            d = (
                math.hypot(q[0] - k[0], q[2] - k[2])
                if ignore_height else _dist(q, k)
            )
            if d < best:
                best, best_vp = d, kvp
        return best_vp if best <= self.loc_noise else None

    def identify_node(self, cur_pos, cur_ori, cand_ang, cand_dis):
        """Fresh node + candidate ids/positions (ref graph_utils.py:179-185)."""
        cur_vp = str(len(self.node_pos))
        cand_vp = [f"{cur_vp}_{i}" for i in range(len(cand_ang))]
        cand_pos = estimate_cand_pos(cur_pos, cur_ori, cand_ang, cand_dis)
        return cur_vp, cand_vp, cand_pos

    def delete_ghost(self, vp: str):
        self.ghost_pos.pop(vp)
        self.ghost_mean_pos.pop(vp)
        self.ghost_aug_pos.pop(vp, None)
        self.ghost_embeds.pop(vp)
        self.ghost_fronts.pop(vp)
        if self.has_real_pos:
            self.ghost_real_pos.pop(vp, None)

    # --------------------------------------------------------------- update
    def update_graph(self, prev_vp, step_id, cur_vp, cur_pos, cur_embeds,
                     cand_vp, cand_pos, cand_embeds, cand_real_pos=None,
                     augment: bool = True):
        """(ref graph_utils.py:198-262). ``augment`` False leaves the ghosts
        unnoised: the caller then calls ``augment_ghosts`` with the draws."""
        cur_pos = np.asarray(cur_pos, np.float64)
        if prev_vp is not None:
            self.graph.add_edge(prev_vp, cur_vp, _dist(self.node_pos[prev_vp], cur_pos))
        self.node_pos[cur_vp] = cur_pos
        self.node_embeds[cur_vp] = cur_embeds
        self.node_step_ids[cur_vp] = step_id

        assignments: List[str] = []
        for i, (cpos, cemb) in enumerate(zip(cand_pos, cand_embeds)):
            near_node = self._localize(cpos, self.node_pos)
            if near_node is not None:
                self.graph.add_edge(cur_vp, near_node, _dist(cur_pos, self.node_pos[near_node]))
                assignments.append(near_node)
                continue
            gvp = (
                self._localize(cpos, self.ghost_mean_pos)
                if self.merge_ghost else None
            )
            if gvp is None:
                gvp = f"g{self.ghost_cnt}"
                self.ghost_cnt += 1
                self.ghost_pos[gvp] = [np.asarray(cpos)]
                self.ghost_mean_pos[gvp] = np.asarray(cpos)
                self.ghost_embeds[gvp] = [np.asarray(cemb, np.float32), 1]
                self.ghost_fronts[gvp] = [cur_vp]
                if self.has_real_pos and cand_real_pos is not None:
                    self.ghost_real_pos[gvp] = [np.asarray(cand_real_pos[i])]
            else:
                self.ghost_pos[gvp].append(np.asarray(cpos))
                self.ghost_mean_pos[gvp] = np.mean(self.ghost_pos[gvp], axis=0)
                self.ghost_embeds[gvp][0] = self.ghost_embeds[gvp][0] + np.asarray(cemb, np.float32)
                self.ghost_embeds[gvp][1] += 1
                self.ghost_fronts[gvp].append(cur_vp)
                if self.has_real_pos and cand_real_pos is not None:
                    self.ghost_real_pos[gvp].append(np.asarray(cand_real_pos[i]))
            assignments.append(gvp)

        if augment:
            self.augment_ghosts()
        else:
            self.ghost_aug_pos = deepcopy(self.ghost_mean_pos)

        self.graph.update(cur_vp)
        return assignments

    def augment_ghosts(self, draws: Optional[Iterator[np.ndarray]] = None) -> None:
        """Position-noise augmentation of the ghosts (training only): one
        ``normal(0, ghost_aug, 3)`` per ghost, in ghost order, from
        ``self.rng`` or the next of ``draws``."""
        self.ghost_aug_pos = deepcopy(self.ghost_mean_pos)
        if self.ghost_aug:
            for gvp, gpos in self.ghost_aug_pos.items():
                noise = (self.rng.normal(0.0, self.ghost_aug, 3) if draws is None
                         else next(draws))
                noise[1] = 0.0
                noise = np.clip(noise, -self.ghost_aug, self.ghost_aug)
                self.ghost_aug_pos[gvp] = gpos + noise

    # --------------------------------------------------------------- queries
    def front_to_ghost_dist(self, ghost_vp: str) -> Tuple[float, str]:
        best, best_front = math.inf, None
        for front in self.ghost_fronts[ghost_vp]:
            d = _dist(self.node_pos[front], self.ghost_aug_pos[ghost_vp])
            if d < best:
                best, best_front = d, front
        return best, best_front

    def get_node_embeds(self, vp: str) -> np.ndarray:
        if vp.startswith("g"):
            s, n = self.ghost_embeds[vp]
            return s / n
        return self.node_embeds[vp]

    def get_pos_fts(self, cur_vp, cur_pos, cur_ori, gmap_vp_ids,
                    angle_feat_size: int = 4) -> np.ndarray:
        """(ref graph_utils.py:283-327)."""
        base_heading = heading_from_quaternion(cur_ori)
        angles, dists = [], []
        for vp in gmap_vp_ids:
            if vp is None:
                angles.append([0.0, 0.0])
                dists.append([0.0, 0.0, 0.0])
                continue
            if vp.startswith("g"):
                pos = self.ghost_aug_pos[vp]
                front_dis, front_vp = self.front_to_ghost_dist(vp)
                sd = self.graph.distance(cur_vp, front_vp) + front_dis
                ss = len(self.graph.path(cur_vp, front_vp)) + 1 + 1
            else:
                pos = self.node_pos[vp]
                sd = self.graph.distance(cur_vp, vp)
                ss = len(self.graph.path(cur_vp, vp)) + 1
            h, e, d = rel_pos_features_ce(
                cur_pos, pos, base_heading, 0.0, to_clock=True
            )
            angles.append([h, e])
            dists.append([d / MAX_DIST, sd / MAX_DIST, ss / MAX_STEP])
        angles = np.asarray(angles, np.float32)
        ang = angle_features(angles[:, 0], angles[:, 1], angle_feat_size)
        return np.concatenate([ang, np.asarray(dists, np.float32)], axis=1)

    def get_neighbors(self, cur_vp, cur_pos, cur_ori):
        """1-hop nodes + frontier ghosts as polar candidates for the BEV
        branch (ref graph_utils.py:348-372)."""
        base_heading = heading_from_quaternion(cur_ori)
        cands_vp: List[Optional[str]] = [None]
        rel = [np.zeros(2, np.float32)]
        for vp, pos in self.node_pos.items():
            if len(self.graph.path(cur_vp, vp)) == 1:  # direct neighbour
                h, _, d = rel_pos_features_ce(
                    cur_pos, pos, base_heading, 0.0,
                    to_clock=True, return_xz_dist=True,
                )
                cands_vp.append(vp)
                rel.append(np.array([h, d], np.float32))
        for vp, pos in self.ghost_aug_pos.items():
            if cur_vp in self.ghost_fronts[vp]:
                h, _, d = rel_pos_features_ce(
                    cur_pos, pos, base_heading, 0.0,
                    to_clock=True, return_xz_dist=True,
                )
                cands_vp.append(vp)
                rel.append(np.array([h, d], np.float32))
        return cands_vp, np.stack(rel)

    def set_node_pc(self, vp: str, step: int):
        self.node_pc_step[vp] = step

    def gather_pc_steps(self, vp: str, order: int) -> List[int]:
        if order == 0:
            return [self.node_pc_step[vp]]
        steps = [
            s for cvp, s in self.node_pc_step.items()
            if len(self.graph.path(vp, cvp)) <= order
        ]
        return sorted(set(steps))
