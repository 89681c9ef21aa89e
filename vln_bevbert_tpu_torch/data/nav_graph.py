"""Navigation-graph loading and shortest-path machinery.

Replaces the reference's networkx pipeline (load_nav_graphs,
reference pretrain_src/data/common.py:71-103) with scipy CSR graphs and
a dense all-pairs Dijkstra (scans are 30-350 nodes, so the dense matrices are
tiny and path reconstruction from the predecessor matrix is O(path length)).

Also provides synthetic scan generation (random geometric graphs written in
the Matterport connectivity-JSON schema) so the loader and everything above it
is testable without MP3D data — the reference has no such fixtures
(SURVEY.md section 4).
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import dijkstra

from ..geometry import nearest_anchor, normalize_angle, rel_pos_features


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


def load_nav_graphs(connectivity_dir: str,
                    scans: Optional[Sequence[str]] = None) -> Dict[str, NavGraph]:
    """Parse `<scan>_connectivity.json` files (MP3D schema: per-node 4x4 pose
    flattened row-major with position at elements 3/7/11, ``included`` and
    ``unobstructed`` flags — ref common.py:71-103)."""
    if scans is None:
        with open(os.path.join(connectivity_dir, "scans.txt")) as f:
            scans = [line.strip() for line in f if line.strip()]
    graphs = {}
    for scan in scans:
        with open(os.path.join(connectivity_dir, f"{scan}_connectivity.json")) as f:
            items = json.load(f)
        included = [bool(it["included"]) for it in items]
        ids, positions, remap = [], [], {}
        for k, it in enumerate(items):
            if included[k]:
                remap[k] = len(ids)
                ids.append(it["image_id"])
                pose = it["pose"]
                positions.append([pose[3], pose[7], pose[11]])
        edges = set()
        for k, it in enumerate(items):
            if not included[k]:
                continue
            for m, open_edge in enumerate(it["unobstructed"]):
                if open_edge and m < len(items) and included[m]:
                    assert items[m]["unobstructed"][k], "graph must be undirected"
                    edges.add((min(remap[k], remap[m]), max(remap[k], remap[m])))
        graphs[scan] = NavGraph(ids, np.array(positions), sorted(edges))
    return graphs


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


# --------------------------------------------------------------- synthetic


def make_synthetic_scan(
    rng: np.random.Generator, n_nodes: int = 12, extent: float = 12.0
) -> Tuple[List[dict], NavGraph]:
    """Random geometric graph in the connectivity-JSON schema + its NavGraph.
    Guaranteed connected (a random spanning chain plus proximity edges)."""
    pos = np.zeros((n_nodes, 3))
    pos[:, :2] = rng.uniform(0, extent, (n_nodes, 2))
    pos[:, 2] = rng.uniform(1.4, 1.6, n_nodes)
    order = rng.permutation(n_nodes)
    edges = set()
    for a, b in zip(order[:-1], order[1:]):
        edges.add((min(a, b), max(a, b)))
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    for i in range(n_nodes):
        for j in range(i + 1, n_nodes):
            if d[i, j] < extent / 3.5:
                edges.add((i, j))
    ids = [f"vp{i:03d}" for i in range(n_nodes)]
    items = []
    for i in range(n_nodes):
        pose = [0.0] * 16
        pose[0] = pose[5] = pose[10] = pose[15] = 1.0
        pose[3], pose[7], pose[11] = pos[i]
        items.append(
            {
                "image_id": ids[i],
                "pose": pose,
                "included": True,
                "unobstructed": [
                    (min(i, j), max(i, j)) in edges and i != j
                    for j in range(n_nodes)
                ],
                "height": 1.5,
            }
        )
    graph = NavGraph(ids, pos, sorted(edges))
    return items, graph


def write_synthetic_connectivity(
    directory: str, rng: np.random.Generator, n_scans: int = 2, n_nodes: int = 12
) -> Dict[str, NavGraph]:
    os.makedirs(directory, exist_ok=True)
    graphs = {}
    names = []
    for s in range(n_scans):
        scan = f"scan{s:02d}"
        items, graph = make_synthetic_scan(rng, n_nodes)
        with open(os.path.join(directory, f"{scan}_connectivity.json"), "w") as f:
            json.dump(items, f)
        graphs[scan] = graph
        names.append(scan)
    with open(os.path.join(directory, "scans.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return graphs
