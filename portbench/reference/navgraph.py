"""The reference's navigation graphs: a frozen copy of the program's
``data/nav_graph.py`` (``NavGraph``: scipy CSR graphs, dense all-pairs
Dijkstra, paths from the predecessor matrix; ``build_scanvp_cands``: each
neighbour bound to its nearest of the 36 discrete views), kept here so that
later changes to the program do not reach the reference or the benchmark's
world generator.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import dijkstra

from .geometry import nearest_anchor, normalize_angle, rel_pos_features


class NavGraph:
    """One scan's connectivity graph with precomputed all-pairs shortest
    paths. Node ids are viewpoint-id strings; internal storage is dense."""

    def __init__(self, node_ids: Sequence[str], positions: np.ndarray,
                 edges: Sequence[Tuple[int, int]]):
        self.node_ids: List[str] = list(node_ids)
        self.index: Dict[str, int] = {v: i for i, v in enumerate(self.node_ids)}
        self.positions = np.asarray(positions, dtype=np.float64)  # (n, 3)
        n = len(self.node_ids)
        rows, cols, weights = [], [], []
        adj: List[List[int]] = [[] for _ in range(n)]
        for i, j in edges:
            w = float(np.linalg.norm(self.positions[i] - self.positions[j]))
            rows += [i, j]
            cols += [j, i]
            weights += [w, w]
            adj[i].append(j)
            adj[j].append(i)
        self.adjacency = adj
        graph = csr_matrix((weights, (rows, cols)), shape=(n, n))
        self.distances, self.predecessors = dijkstra(
            graph, directed=False, return_predecessors=True
        )
        self._hops: Optional[np.ndarray] = None

    @property
    def hops(self) -> np.ndarray:
        """(n, n) step counts along the WEIGHTED shortest paths (equal to
        ``len(path(a, b)) - 1``, the quantity the reference's
        get_gmap_pos_fts divides by MAX_STEP — dataset.py:362-384). Computed
        once, lazily, from the predecessor matrix: nodes in ascending
        distance order always see their predecessor's count first."""
        if self._hops is None:
            n = len(self.node_ids)
            hops = np.zeros((n, n), np.int32)
            order = np.argsort(self.distances, axis=1)
            for i in range(n):
                pi = self.predecessors[i]
                hi = hops[i]
                for j in order[i]:
                    p = pi[j]
                    if p >= 0:
                        hi[j] = hi[p] + 1
            self._hops = hops
        return self._hops

    def __len__(self) -> int:
        return len(self.node_ids)

    def position(self, vp: str) -> np.ndarray:
        return self.positions[self.index[vp]]

    def neighbors(self, vp: str) -> List[str]:
        return [self.node_ids[j] for j in self.adjacency[self.index[vp]]]

    def distance(self, a: str, b: str) -> float:
        return float(self.distances[self.index[a], self.index[b]])

    def path(self, a: str, b: str) -> List[str]:
        """Shortest path a..b inclusive, reconstructed from predecessors."""
        i, j = self.index[a], self.index[b]
        if i == j:
            return [a]
        if self.predecessors[i, j] < 0:
            raise ValueError(f"no path {a} -> {b}")
        out = [j]
        while out[-1] != i:
            out.append(int(self.predecessors[i, out[-1]]))
        return [self.node_ids[k] for k in reversed(out)]

    def path_steps(self, a: str, b: str) -> int:
        return int(self.hops[self.index[a], self.index[b]])


def build_scanvp_cands(graphs: Dict[str, NavGraph]) -> Dict[str, Dict[str, list]]:
    """Candidate table {scan_vp: {cand_vp: [viewidx, dist, rel_h, rel_e]}}.

    The reference precomputes this offline (scanvp_candview_relangles.json,
    consumed at dataset.py:67). Here each graph neighbour is bound to its
    nearest of the 36 discrete views (middle elevation ring) with the residual
    heading/elevation offsets.
    """
    out: Dict[str, Dict[str, list]] = {}
    for scan, g in graphs.items():
        for vp in g.node_ids:
            cands = {}
            for nb in g.neighbors(vp):
                h, e, d = rel_pos_features(g.position(vp), g.position(nb))
                view_col = nearest_anchor(h)
                viewidx = 12 + view_col  # middle ring
                rel_h = float(normalize_angle(h - view_col * math.radians(30.0)))
                cands[nb] = [viewidx, float(d), float(rel_h), float(e)]
            out[f"{scan}_{vp}"] = cands
    return out
