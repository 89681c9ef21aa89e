"""Text-path datasets ("nav_db"): one training example per
(instruction, truncated path, chosen end viewpoint).

Behaviour parity with reference pretrain_src/data/dataset.py
(ReverieTextPathData / R2RTextPathData / SoonTextPathData) — end-viewpoint
sampling (pos / neg-in-path / neg-others), trajectory panorama tokens
(candidate views first, then non-candidate views, then objects), global-map
node tables with pairwise shortest-path distances, raw BEV camera inputs, and
shortest-path action labels — produced as ragged numpy dicts that
data/batching.py packs into the static-shape device contract.

A frozen copy of the program's ``data/pathdata.py`` for the benchmark's reference:
later changes to the program do not reach it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from .geometry import (
    angle_features,
    bev_camera_poses,
    nearest_anchor,
    rel_pos_features_batch,
    se3_from_xyzhe,
    view_rel_angles,
    world_to_ego_cells_stop_centre,
)
from .navgraph import NavGraph

MAX_DIST = 30.0     # ref dataset.py:19
MAX_STEP = 10.0     # ref dataset.py:20
TRAIN_MAX_STEP = 20  # ref dataset.py:21


@dataclass
class PathExample:
    """Ragged per-example inputs (host side)."""

    instr_id: str
    instr_encoding: np.ndarray           # (L,) int
    # trajectory (one entry per step)
    traj_view_fts: List[np.ndarray]      # (n_views_t, Dimg)
    traj_loc_fts: List[np.ndarray]       # (n_views_t [+n_obj_t], A+3)
    traj_nav_types: List[np.ndarray]     # (n_tokens_t,)
    traj_cand_vpids: List[List[str]]
    traj_vpids: List[str]
    # global map
    gmap_vpids: List[Optional[str]]      # [None] + nodes
    gmap_step_ids: np.ndarray
    gmap_visited_masks: np.ndarray
    gmap_pos_fts: np.ndarray             # (N, A+3)
    gmap_pair_dists: np.ndarray          # (N, N)
    # raw BEV inputs
    depths: np.ndarray                   # (V, H, W) metres
    grid_fts: np.ndarray                 # (V*H*W, C)
    sem_labels: np.ndarray               # (V*H*W,)
    T_c2w: np.ndarray                    # (V, 4, 4)
    T_w2c: np.ndarray                    # (4, 4)
    S_w2c: np.ndarray                    # (3,)
    bev_cand_cells: np.ndarray           # (1+K,) flat cells, [0] = centre/stop
    bev_gpos_fts: np.ndarray             # (A+3,)
    # labels
    global_act_label: int = -100
    local_act_label: int = -100
    # objects (REVERIE/SOON)
    traj_obj_fts: Optional[List[np.ndarray]] = None   # (n_obj_t, Dobj)
    obj_label: int = -100
    obj_probs: Optional[np.ndarray] = None            # (n_obj_last, P)


class TextPathData:
    """R2R-style dataset over (annotations, graphs, feature stores).

    feature stores:
      view_db  : 36-view pooled features per scan_vp, (36, Dimg[+prob])
      grid_db  : (V, H*W, C) grid features
      depth_db : (V, H, W) depth, stored as metres/10 (reference convention)
      sem_db   : (V, H, W) uint8 semantic labels
    """

    def __init__(
        self,
        annotations: Sequence[dict],
        graphs: Dict[str, NavGraph],
        scanvp_cands: Dict[str, Dict[str, list]],
        view_db,
        grid_db=None,
        depth_db=None,
        sem_db=None,
        obj_db=None,
        image_feat_size: int = 512,
        angle_feat_size: int = 4,
        obj_feat_size: int = 0,
        obj_prob_size: int = 0,
        max_objects: int = 20,
        max_txt_len: int = 200,
        bev_dim: int = 21,
        bev_res: float = 0.5,
        num_views: int = 12,
        act_visited_node: bool = False,
        dataset: str = "r2r",
        pano_cache_size: int = 2048,
    ):
        self.data = list(annotations)
        self.graphs = graphs
        self.scanvp_cands = scanvp_cands
        self.view_db = view_db
        self.grid_db = grid_db
        self.depth_db = depth_db
        self.sem_db = sem_db
        self.obj_db = obj_db
        self.image_feat_size = image_feat_size
        self.angle_feat_size = angle_feat_size
        self.obj_feat_size = obj_feat_size
        self.obj_prob_size = obj_prob_size
        self.max_objects = max_objects
        self.max_txt_len = max_txt_len
        self.bev_dim = bev_dim
        self.bev_res = bev_res
        self.num_views = num_views
        self.act_visited_node = act_visited_node
        self.dataset = dataset
        # relative angles of the 36 discrete views from the canonical base
        # view 12 (middle ring, heading 0) — ref dataset.py:70-71
        self.rel_angles_12 = view_rel_angles(base_view_id=12)
        # (scan, vp) -> pano-token LRU (~112 KB/entry at 768-wide features)
        from collections import OrderedDict

        self.pano_cache_size = pano_cache_size
        self._pano_cache: "OrderedDict[str, tuple]" = OrderedDict()

    def __len__(self):
        return len(self.data)

    # ------------------------------------------------------------ end vp pick
    def sample_end_vp(self, item: dict, end_vp_type: str, rng: np.random.Generator):
        gt_path = item["path"]
        if self.dataset == "r2r":
            if end_vp_type == "pos":
                return len(gt_path) - 1, gt_path[-1]
            end_idx = int(rng.integers(0, max(len(gt_path) - 1, 1)))
            return end_idx, gt_path[end_idx]
        # REVERIE/SOON: pos_vps set (ref dataset.py:169-180)
        scan = item["scan"]
        pos_vps = item["pos_vps"]
        if end_vp_type == "pos":
            vp = pos_vps[int(rng.integers(len(pos_vps)))]
        elif end_vp_type == "neg_in_gt_path":
            cands = [v for v in gt_path if v not in pos_vps] or gt_path
            vp = cands[int(rng.integers(len(cands)))]
        else:  # neg_others
            excluded = set(pos_vps) | set(gt_path)
            cands = [v for v in self.graphs[scan].node_ids if v not in excluded]
            vp = cands[int(rng.integers(len(cands)))]
        return None, vp

    # -------------------------------------------------------------- main entry
    def get_input(
        self,
        idx: int,
        end_vp_type: str,
        rng: np.random.Generator,
        return_act_label: bool = False,
        return_obj_label: bool = False,
        return_obj_probs: bool = False,
        end_vp: Optional[str] = None,
    ) -> PathExample:
        item = self.data[idx]
        scan = item["scan"]
        graph = self.graphs[scan]
        start_vp = item["path"][0]
        start_heading = item.get("heading", 0.0)

        if end_vp is None:
            end_idx, end_vp = self.sample_end_vp(item, end_vp_type, rng)
        else:
            end_idx = item["path"].index(end_vp) if end_vp in item["path"] else None

        if self.dataset == "r2r":
            gt_path = item["path"][: end_idx + 1]
        else:
            gt_path = graph.path(start_vp, end_vp)

        cur_heading, cur_elevation = self.current_angle(scan, gt_path, start_heading)
        if len(gt_path) > TRAIN_MAX_STEP:
            gt_path = gt_path[:TRAIN_MAX_STEP] + [end_vp]

        traj = self.trajectory_pano_features(scan, gt_path)
        gmap = self.gmap_inputs(scan, gt_path, cur_heading, cur_elevation)
        bev = self.bev_inputs(scan, end_vp, cur_heading, traj["cand_vpids"][-1])

        ex = PathExample(
            instr_id=item["instr_id"],
            instr_encoding=np.asarray(item["instr_encoding"][: self.max_txt_len]),
            traj_view_fts=[x[:, : self.image_feat_size] for x in traj["view_fts"]],
            traj_loc_fts=traj["loc_fts"],
            traj_nav_types=traj["nav_types"],
            traj_cand_vpids=traj["cand_vpids"],
            traj_vpids=gt_path,
            gmap_vpids=gmap["vpids"],
            gmap_step_ids=gmap["step_ids"],
            gmap_visited_masks=gmap["visited_masks"],
            gmap_pos_fts=gmap["pos_fts"],
            gmap_pair_dists=gmap["pair_dists"],
            depths=bev["depths"],
            grid_fts=bev["grid_fts"],
            sem_labels=bev["sem_labels"],
            T_c2w=bev["T_c2w"],
            T_w2c=bev["T_w2c"],
            S_w2c=bev["S_w2c"],
            bev_cand_cells=bev["cand_cells"],
            bev_gpos_fts=self.rel_pos_fts(
                scan, end_vp, [start_vp], cur_heading, cur_elevation
            )[0],
            traj_obj_fts=traj.get("obj_fts"),
        )

        if return_act_label:
            ex.global_act_label, ex.local_act_label = self.act_labels(
                item, scan, end_vp, end_idx, gmap["vpids"], gmap["visited_masks"],
                traj["cand_vpids"],
            )
        if return_obj_label and traj.get("obj_ids") is not None:
            ex.obj_label = self.obj_label(item, traj["obj_ids"])
        if return_obj_probs and traj.get("obj_full_fts") is not None:
            last = traj["obj_full_fts"][-1]
            if len(last):
                logits = last[:, self.obj_feat_size:]
                e = np.exp(logits - logits.max(axis=1, keepdims=True))
                ex.obj_probs = (e / e.sum(axis=1, keepdims=True)).astype(np.float32)
            else:
                ex.obj_probs = np.zeros((0, self.obj_prob_size), np.float32)
        return ex

    # -------------------------------------------------------------- components
    def current_angle(self, scan, path, start_heading):
        """Agent heading after traversing the path: the discrete view used to
        enter the final node (ref get_cur_angle, dataset.py:245-256)."""
        if len(path) < 2:
            return start_heading, 0.0
        viewidx = self.scanvp_cands[f"{scan}_{path[-2]}"][path[-1]][0]
        return (viewidx % 12) * math.radians(30.0), 0.0

    def _pano_tokens(self, scan, vp):
        """Per-viewpoint pano tokens (fts, view loc fts, nav types,
        cand_vpids) — a pure function of (scan, vp), LRU-cached: flagship
        trajectories revisit viewpoints constantly across examples, and the
        reference rebuilds these python-side per sample (its named hot spot,
        dataset.py:265-324)."""
        key = f"{scan}_{vp}"
        hit = self._pano_cache.get(key)
        if hit is not None:
            self._pano_cache.move_to_end(key)
            return hit
        view36 = self.view_db.get(scan, vp)
        cands = self.scanvp_cands[key]
        used, rows, angles, cand_vpids = set(), [], [], []
        for cand_vp, (viewidx, _dist, rel_h, rel_e) in cands.items():
            used.add(viewidx)
            rows.append(viewidx)
            base = self.rel_angles_12[viewidx]
            angles.append([base[0] + rel_h, base[1] + rel_e])
            cand_vpids.append(cand_vp)
        rest = [v for v in range(36) if v not in used]
        rows.extend(rest)
        fts = np.ascontiguousarray(
            view36[np.asarray(rows), : self.image_feat_size], np.float32
        )
        angles = np.concatenate(
            [np.asarray(angles, np.float32).reshape(-1, 2),
             self.rel_angles_12[rest]], axis=0,
        )
        ang_fts = angle_features(angles[:, 0], angles[:, 1], self.angle_feat_size)
        loc = np.concatenate(
            [ang_fts, np.ones((len(fts), 3), np.float32)], axis=1
        )
        nav = np.zeros(len(fts), np.int64)
        nav[: len(cand_vpids)] = 1
        entry = (fts, loc, nav, cand_vpids)
        self._pano_cache[key] = entry
        if len(self._pano_cache) > self.pano_cache_size:
            self._pano_cache.popitem(last=False)
        return entry

    def trajectory_pano_features(self, scan, path):
        """Per-step pano tokens: candidate views (possibly repeating a view
        feature), remaining views, objects (ref get_traj_pano_fts,
        dataset.py:265-324,580-622)."""
        out = {"view_fts": [], "loc_fts": [], "nav_types": [], "cand_vpids": []}
        if self.obj_db is not None:
            out["obj_fts"] = []
            out["obj_full_fts"] = []
        for vp in path:
            fts, loc, nav, cand_vpids = self._pano_tokens(scan, vp)
            if self.obj_db is not None:
                obj_full, obj_loc, obj_ids = self._objects(scan, vp)
                out["obj_full_fts"].append(obj_full)
                out["obj_fts"].append(obj_full[:, : self.obj_feat_size])
                loc = np.concatenate([loc, obj_loc], axis=0)
                nav = np.concatenate([nav, np.full(len(obj_full), 2, np.int64)])
                out["obj_ids"] = obj_ids  # last step's object ids survive
            out["view_fts"].append(fts)
            out["loc_fts"].append(loc)
            out["nav_types"].append(nav)
            out["cand_vpids"].append(cand_vpids)
        return out

    def _objects(self, scan, vp):
        rec = self.obj_db.get(scan, vp) if f"{scan}_{vp}" in self.obj_db else None
        if rec is None:
            return (
                np.zeros((0, self.obj_feat_size + self.obj_prob_size), np.float32),
                np.zeros((0, self.angle_feat_size + 3), np.float32),
                [],
            )
        fts = rec["fts"][: self.max_objects].astype(np.float32)
        angles = rec["directions"][: self.max_objects]
        sizes = rec["sizes"][: self.max_objects]
        ang_fts = angle_features(
            angles[:, 0], angles[:, 1], self.angle_feat_size
        )
        h, w = rec.get("image_hw", (480, 640))
        box = np.stack(
            [sizes[:, 1] / h, sizes[:, 0] / w, sizes[:, 0] * sizes[:, 1] / (h * w)],
            axis=1,
        ).astype(np.float32)
        return fts, np.concatenate([ang_fts, box], axis=1), list(rec["obj_ids"][: self.max_objects])

    def rel_pos_fts(self, scan, cur_vp, vpids, cur_heading, cur_elevation):
        """(len(vpids), A+3): angle features + [line dist, geodesic dist,
        path steps] normalised (ref get_gmap_pos_fts, dataset.py:362-384).
        A ``None`` entry (the [stop] token) contributes zero angles/dists.

        Fully vectorised (one batched rel-pos + two matrix gathers) — the
        reference loops python per node here, the measured host hot spot."""
        g = self.graphs[scan]
        n = len(vpids)
        live = np.array([vp is not None for vp in vpids])
        h_full = np.zeros(n, np.float64)
        e_full = np.zeros(n, np.float64)
        d3 = np.zeros((n, 3), np.float32)
        if live.any():
            idx = np.array([g.index[vp] for vp in vpids if vp is not None])
            ci = g.index[cur_vp]
            h, e, d = rel_pos_features_batch(
                g.positions[ci], g.positions[idx],
                base_heading=cur_heading, base_elevation=cur_elevation,
            )
            h_full[live] = h
            e_full[live] = e
            d3[live, 0] = d / MAX_DIST
            d3[live, 1] = g.distances[ci, idx] / MAX_DIST
            d3[live, 2] = g.hops[ci, idx] / MAX_STEP
        ang_fts = angle_features(h_full, e_full, self.angle_feat_size)
        return np.concatenate([ang_fts, d3], axis=1)

    def gmap_inputs(self, scan, path, cur_heading, cur_elevation):
        """Node table: [stop] + visited (in visit order, step id = last visit)
        + frontier (ref get_gmap_inputs, dataset.py:326-360)."""
        g = self.graphs[scan]
        visited: Dict[str, int] = {}
        frontier: Dict[str, int] = {}
        for t, vp in enumerate(path):
            visited[vp] = t + 1
            frontier.pop(vp, None)
            for nb in self.scanvp_cands[f"{scan}_{vp}"]:
                if nb not in visited:
                    frontier[nb] = 0
        vpids = [None] + list(visited) + list(frontier)
        step_ids = np.array([0] + list(visited.values()) + [0] * len(frontier))
        if self.act_visited_node:
            visited_masks = np.array(
                [False] + [vp == path[-1] for vp in vpids[1:]]
            )
        else:
            visited_masks = np.array(
                [False] + [True] * len(visited) + [False] * len(frontier)
            )
        pos_fts = self.rel_pos_fts(scan, path[-1], vpids, cur_heading, cur_elevation)
        n = len(vpids)
        dists = np.zeros((n, n), np.float32)
        if n > 1:  # one matrix gather instead of n^2/2 python dict lookups
            idx = np.array([g.index[v] for v in vpids[1:]])
            dists[1:, 1:] = g.distances[np.ix_(idx, idx)] / MAX_DIST
        return {
            "vpids": vpids,
            "step_ids": step_ids.astype(np.int64),
            "visited_masks": visited_masks,
            "pos_fts": pos_fts,
            "pair_dists": dists,
        }

    def bev_inputs(self, scan, cur_vp, cur_heading, cand_vpids):
        """Raw device-side BEV inputs (ref get_bev_inputs, dataset.py:397-440).
        Depth files store metres/10; re-scaled to metres here so the device
        kernel is unit-clean."""
        g = self.graphs[scan]
        pos = g.position(cur_vp)
        # grid features keep their STORED dtype (fp16 on disk): the device
        # lift-splat casts to bf16 on-chip (ops/bev.py splat), so upcasting
        # on the host would only double host copy + H2D bytes — numpy's f16
        # cast alone (~90 MB/s here) would cap the loader at ~25 samples/s
        grid = np.asarray(self.grid_db.get(scan, cur_vp))
        depth = np.asarray(self.depth_db.get(scan, cur_vp), np.float32) * 10.0
        sem = np.asarray(
            self.sem_db.get(scan, cur_vp), np.int32
        ).reshape(-1)
        cam_xyzhe = bev_camera_poses(pos, num_views=self.num_views)
        T_c2w = se3_from_xyzhe(cam_xyzhe)
        T_w2c = se3_from_xyzhe(
            np.array([[0, 0, 0, cur_heading, 0]], np.float32)
        )[0]
        S_w2c = cam_xyzhe[0, :3].copy()
        cand_pos = np.array([g.position(vp) for vp in cand_vpids], np.float64)
        cand_cells = world_to_ego_cells_stop_centre(
            cand_pos, pos, cur_heading, self.bev_dim, self.bev_res
        )
        return {
            "depths": depth,
            "grid_fts": grid.reshape(-1, grid.shape[-1]),
            "sem_labels": sem,
            "T_c2w": T_c2w,
            "T_w2c": T_w2c,
            "S_w2c": S_w2c,
            "cand_cells": cand_cells,
        }

    def act_labels(self, item, scan, end_vp, end_idx, gmap_vpids,
                   gmap_visited_masks, traj_cand_vpids):
        """Teacher action (ref R2R get_act_labels dataset.py:471-487;
        REVERIE/SOON variant dataset.py:132-156)."""
        if self.dataset == "r2r":
            if end_vp == item["path"][-1]:
                return 0, 0
            gt_next = item["path"][end_idx + 1]
            glabel = llabel = -100
            for k, vp in enumerate(gmap_vpids):
                if vp == gt_next:
                    glabel = k
                    break
            for k, vp in enumerate(traj_cand_vpids[-1]):
                if vp == gt_next:
                    llabel = k + 1
                    break
            return glabel, llabel
        # REVERIE/SOON: nearest-to-goal unvisited node / candidate
        pos_vps = item["pos_vps"]
        if end_vp in pos_vps:
            return 0, 0
        g = self.graphs[scan]

        def goal_cost(vp):
            return min(
                g.distance(end_vp, vp) + g.distance(vp, pv) for pv in pos_vps
            )

        glabel = llabel = -100
        best = math.inf
        for k, vp in enumerate(gmap_vpids):
            if k > 0 and not gmap_visited_masks[k]:
                c = goal_cost(vp)
                if c < best:
                    best, glabel = c, k
        best = math.inf
        for k, vp in enumerate(traj_cand_vpids[-1]):
            c = goal_cost(vp)
            if c < best:
                best, llabel = c, k + 1
        return glabel, llabel

    def obj_label(self, item, last_vp_objids):
        if self.dataset == "soon":
            lbl = item["obj_pseudo_label"]["idx"]
            return lbl if lbl < self.max_objects else -100
        gt_obj_id = item["instr_id"].split("_")[1]
        for k, oid in enumerate(last_vp_objids):
            if str(oid) == gt_obj_id:
                return k
        return -100
