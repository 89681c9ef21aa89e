"""Online topological map for discrete-environment navigation (host side).

Re-design of reference map_nav_src/models/graph_utils.py:44-192:

- ``FloydGraph``: incremental all-pairs shortest paths over the explored
  subgraph (Floyd-Warshall relaxation per newly-visited node).
- ``GraphMap``: per-episode map — node positions, running-mean node embed
  *contributions* (kept as (step, slot, weight) index lists so the training
  replay pass can rebuild node features differentiably on device), per-node
  point-cloud buffers for the egocentric BEV gather, and relative-position
  features.

The reference stores live CUDA tensors in the map (node_embeds, node_pc) and
backprops through them at episode end; here everything host-side is numpy or
indices, and the device recomputes embeddings from those indices during the
replay pass (see nav/agent.py).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..geometry import angle_features, rel_pos_features

MAX_DIST = 30.0
MAX_STEP = 10.0
INF = 95959595.0  # sentinel parity with the reference (graph_utils.py:46)


class FloydGraph:
    def __init__(self):
        self._dis: Dict[str, Dict[str, float]] = defaultdict(
            lambda: defaultdict(lambda: INF)
        )
        self._point: Dict[str, Dict[str, str]] = defaultdict(
            lambda: defaultdict(str)
        )
        self._visited = set()

    def distance(self, x: str, y: str) -> float:
        return 0.0 if x == y else self._dis[x][y]

    def add_edge(self, x: str, y: str, dis: float):
        if dis < self._dis[x][y]:
            self._dis[x][y] = self._dis[y][x] = dis
            self._point[x][y] = self._point[y][x] = ""

    def update(self, k: str):
        """Relax all pairs through newly-visited node k."""
        nodes = list(self._dis)
        for x in nodes:
            for y in nodes:
                if x != y:
                    through = self._dis[x][k] + self._dis[k][y]
                    if through < self._dis[x][y]:
                        self._dis[x][y] = self._dis[y][x] = through
                        self._point[x][y] = self._point[y][x] = k
        self._visited.add(k)

    def visited(self, k: str) -> bool:
        return k in self._visited

    def path(self, x: str, y: str) -> List[str]:
        """Node list from x (exclusive) to y (inclusive)."""
        if x == y:
            return []
        k = self._point[x][y]
        if k == "":
            return [y]
        return self.path(x, k) + self.path(k, y)


def make_floyd_graph(use_native: Optional[bool] = None):
    """Native C++ engine when available (``native/``), else the
    Python implementation. Identical surfaces and semantics."""
    if use_native is None or use_native:
        try:
            from ..native import NativeFloydGraph, available

            if available():
                return NativeFloydGraph()
        except Exception:
            if use_native:
                raise
    return FloydGraph()


class GraphMap:
    def __init__(self, start_vp: str, use_native: Optional[bool] = None):
        self.start_vp = start_vp
        self.node_positions: Dict[str, Tuple[float, float, float]] = {}
        self.graph = make_floyd_graph(use_native)
        # vp -> list of (step, slot, raw_weight); final embed = weighted mean
        self.node_embed_refs: Dict[str, List[Tuple[int, int, float]]] = {}
        # vp -> index of the rollout step whose lifted point cloud covers it
        self.node_pc_step: Dict[str, int] = {}
        self.node_step_ids: Dict[str, int] = {}
        self.node_stop_scores: Dict[str, float] = {}
        self.node_og: Dict[str, Optional[str]] = {}  # predicted objid per node

    # ------------------------------------------------------------- structure
    def update_graph(self, ob: dict):
        self.node_positions[ob["viewpoint"]] = tuple(ob["position"])
        for cand in ob["candidate"]:
            self.node_positions[cand["viewpointId"]] = tuple(cand["position"])
            dist = float(
                np.linalg.norm(
                    np.asarray(ob["position"]) - np.asarray(cand["position"])
                )
            )
            self.graph.add_edge(ob["viewpoint"], cand["viewpointId"], dist)
        self.graph.update(ob["viewpoint"])

    # ------------------------------------------------------------ embeddings
    def set_visited_embed(self, vp: str, step: int, num_slots: int):
        """Visited node: masked mean over all pano slots of this step
        (rewrite semantics — ref update_node_embed(rewrite=True),
        graph_utils.py:116-124). Slot -1 denotes 'mean over valid slots'."""
        self.node_embed_refs[vp] = [(step, -1, 1.0)]

    def add_sighting(self, vp: str, step: int, slot: int):
        """Unvisited node: accumulate the candidate-view token embed."""
        self.node_embed_refs.setdefault(vp, []).append((step, slot, 1.0))

    # ------------------------------------------------------------ point cloud
    def set_node_pc(self, vp: str, step: int):
        self.node_pc_step[vp] = step

    def gather_pc_steps(self, vp: str, order: int) -> List[int]:
        """Rollout steps whose point clouds lie within `order` hops of vp
        (ref gather_node_pc, graph_utils.py:129-143)."""
        if order == 0:
            return [self.node_pc_step[vp]]
        steps = [
            s for cvp, s in self.node_pc_step.items()
            if len(self.graph.path(vp, cvp)) <= order
        ]
        return sorted(set(steps))

    # ---------------------------------------------------------------- queries
    def get_pos_fts(
        self, cur_vp: str, vpids, cur_heading: float, cur_elevation: float,
        angle_feat_size: int = 4,
    ) -> np.ndarray:
        angles, dists = [], []
        for vp in vpids:
            if vp is None:
                angles.append([0.0, 0.0])
                dists.append([0.0, 0.0, 0.0])
            else:
                h, e, d = rel_pos_features(
                    self.node_positions[cur_vp], self.node_positions[vp],
                    base_heading=cur_heading, base_elevation=cur_elevation,
                )
                angles.append([h, e])
                dists.append(
                    [
                        d / MAX_DIST,
                        self.graph.distance(cur_vp, vp) / MAX_DIST,
                        len(self.graph.path(cur_vp, vp)) / MAX_STEP,
                    ]
                )
        angles = np.asarray(angles, np.float32)
        ang = angle_features(angles[:, 0], angles[:, 1], angle_feat_size)
        return np.concatenate([ang, np.asarray(dists, np.float32)], axis=1)
