"""The benchmark's one traffic generator: a seeded synthetic Matterport-like
world, built from a traffic file's parameters.

A copy of the worlds the port's command lines build with ``--synthetic``
(``data/nav_graph.py:make_synthetic_scan``, ``cli/finetune.py:
synthetic_feature_dbs``, ``data/loader.py:make_synthetic_annotations``), so
that the work a cell gets cannot change with the program:

- ``n_scans`` scans of ``n_nodes`` viewpoints each on an ``extent`` m
  square floor (12 by default), random geometric graphs (a spanning chain
  plus every pair closer than ``edge_radius`` m, ``extent / 3.5`` by
  default);
- per viewpoint 36 view features, a 12 x 14 x 14 grid of CLIP features
  (float16), a depth image (float32 from float16, metres / 10 in
  [0.02, 0.9]) and semantic labels (uint8);
- ``n_items`` R2R-style items: the shortest path between two random
  viewpoints of ``path_len`` viewpoints, a random heading, and an
  instruction of ``[CLS] + n tokens + [SEP]`` with n drawn from ``txt_len``.

The grid features are drawn by a ``torch.Generator`` seeded with ``seed``
on the run's device (in one call), everything else from
``np.random.default_rng(seed)`` in one fixed order, so the same seed gives
the same world on a device, and every seed the same sizes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from .reference.navgraph import NavGraph


@dataclass
class World:
    scans: Dict[str, Tuple[List[str], np.ndarray, List[Tuple[int, int]]]]
    views: Dict[str, np.ndarray] = field(default_factory=dict)
    grids: Dict[str, np.ndarray] = field(default_factory=dict)
    depths: Dict[str, np.ndarray] = field(default_factory=dict)
    sems: Dict[str, np.ndarray] = field(default_factory=dict)
    annotations: List[dict] = field(default_factory=list)


def scan_graph(rng: np.random.Generator, n_nodes: int, extent: float = 12.0,
               radius: float = None):
    """(node ids, positions (n, 3), sorted edges) of one random scan on an
    ``extent`` x ``extent`` m floor, edges under ``radius`` m (by default
    ``extent / 3.5``, the port's)."""
    radius = extent / 3.5 if radius is None else radius
    pos = np.zeros((n_nodes, 3))
    pos[:, :2] = rng.uniform(0, extent, (n_nodes, 2))
    pos[:, 2] = rng.uniform(1.4, 1.6, n_nodes)
    order = rng.permutation(n_nodes)
    edges = {(min(a, b), max(a, b)) for a, b in zip(order[:-1], order[1:])}
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    for i in range(n_nodes):
        for j in range(i + 1, n_nodes):
            if d[i, j] < radius:
                edges.add((i, j))
    return [f"vp{i:03d}" for i in range(n_nodes)], pos, sorted(edges)


def annotations(graphs: Dict[str, NavGraph], rng: np.random.Generator, n_items: int,
                path_len=(3, 7), txt_len=(10, 40), vocab=(1996, 29611)) -> List[dict]:
    items = []
    scans = list(graphs)
    for i in range(n_items):
        scan = scans[int(rng.integers(len(scans)))]
        g = graphs[scan]
        for _ in range(20):
            a, b = rng.choice(len(g), 2, replace=False)
            path = g.path(g.node_ids[a], g.node_ids[b])
            if path_len[0] <= len(path) <= path_len[1]:
                break
        enc = [101] + list(rng.integers(vocab[0], vocab[1], int(rng.integers(*txt_len)))) + [102]
        items.append({"instr_id": f"synt_{i}", "scan": scan, "path": path,
                      "heading": float(rng.uniform(0, 2 * np.pi)), "instr_encoding": enc})
    return items


def make_world(params: dict, seed: int, image_feat_size: int, grid_feat_size: int,
               grid_hw: int, num_views: int, num_sem: int = 40, device="cpu") -> World:
    """The world of a traffic file's ``world`` block, from ``seed``. The
    grid features, most of its bytes, are drawn in one call by a generator
    on ``device`` and handed to the host as the feature store holds them."""
    rng = np.random.default_rng(seed)
    world = World(scans={})
    for s in range(params["n_scans"]):
        world.scans[f"scan{s:02d}"] = scan_graph(rng, params["n_nodes"],
                                                 params.get("extent", 12.0),
                                                 params.get("edge_radius"))
    keys = [f"{scan}_{vp}" for scan, (ids, _, _) in world.scans.items() for vp in ids]
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed)
    grids = torch.randn(len(keys), num_views, grid_hw * grid_hw, grid_feat_size,
                        generator=gen, device=device).half().cpu().numpy()
    for k, key in enumerate(keys):
        world.grids[key] = grids[k]
    for key in keys:
        world.views[key] = rng.normal(size=(36, image_feat_size)).astype(np.float32)
        world.depths[key] = rng.uniform(0.02, 0.9, (num_views, grid_hw, grid_hw)
                                        ).astype(np.float16).astype(np.float32)
        world.sems[key] = rng.integers(0, num_sem, (num_views, grid_hw, grid_hw)
                                       ).astype(np.uint8)
    graphs = {scan: NavGraph(*g) for scan, g in world.scans.items()}
    world.annotations = annotations(graphs, rng, params["n_items"],
                                    tuple(params["path_len"]), tuple(params["txt_len"]))
    return world
