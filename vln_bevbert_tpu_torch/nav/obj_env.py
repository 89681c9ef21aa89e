"""REVERIE / SOON object-navigation environments.

Deltas over R2RNavBatch, mirroring reference map_nav_src/reverie/env.py
and soon/env.py: a per-viewpoint object store merged into observations,
object-goal episodes, and the object-grounding metric suites (REVERIE
RGS/RGSPL over obj2vps goal sets, env.py:360-410; SOON detection
success/det_spl with heading-elevation bbox containment, soon/env.py:319-380 —
shapely's Polygon.contains replaced by a numpy convex-quad test).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..geometry import angle_features
from .env import ERROR_MARGIN, R2RNavBatch


def point_in_convex_quad(point, quad) -> bool:
    """Point-in-convex-polygon via consistent cross-product signs."""
    p = np.asarray(point, np.float64)
    q = np.asarray(quad, np.float64)
    signs = []
    for i in range(len(q)):
        a, b = q[i], q[(i + 1) % len(q)]
        cross = (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0])
        signs.append(cross)
    signs = np.asarray(signs)
    return bool((signs >= 0).all() or (signs <= 0).all())


class ObjectDB:
    """{scan_vp: {fts (n, D+P), directions (n,2), sizes (n,2), obj_ids}}."""

    def __init__(self, data: Dict[str, dict], image_hw=(480, 640)):
        self.data = data
        self.image_hw = image_hw

    def get(self, scan: str, viewpoint: str) -> Optional[dict]:
        rec = self.data.get(f"{scan}_{viewpoint}")
        if rec is not None and "image_hw" not in rec:
            rec = {**rec, "image_hw": self.image_hw}
        return rec

    def __contains__(self, key: str) -> bool:
        return key in self.data


class ReverieObjectNavBatch(R2RNavBatch):
    def __init__(self, *args, obj_db: ObjectDB, obj2vps: Dict[str, List[str]],
                 max_objects: int = 20, multi_endpoints: bool = False,
                 **kwargs):
        self.obj_db = obj_db
        self.obj2vps = obj2vps  # {scan_objid: [vps where visible]}
        self.max_objects = max_objects
        self.multi_endpoints = multi_endpoints
        super().__init__(*args, **kwargs)
        self.gt_trajs = {
            x["instr_id"]: (x["scan"], x["path"], x.get("objId"))
            for x in self.data if "objId" in x
        }

    def next_minibatch(self):
        """Multi-endpoint episode resampling (ref reverie/env.py:193-214):
        with multi_endpoints, swap the episode goal for a random viewpoint
        from which the target object is visible."""
        super().next_minibatch()
        if not self.multi_endpoints:
            return
        batch = [dict(item) for item in self.batch]
        for item in batch:
            key = f"{item['scan']}_{item['objId']}"
            end_vps = self.obj2vps.get(key, [])
            if end_vps:
                end_vp = end_vps[int(self.rng.integers(len(end_vps)))]
                g = self.graphs[item["scan"]]
                item["path"] = g.path(item["path"][0], end_vp)
        self.batch = batch

    def _observations(self) -> List[dict]:
        obs = super()._observations()
        for ob, item in zip(obs, self.batch):
            rec = self.obj_db.get(ob["scan"], ob["viewpoint"])
            if rec is None:
                ob.update(
                    obj_img_fts=np.zeros((0, 0), np.float32),
                    obj_ang_fts=np.zeros((0, self.angle_feat_size), np.float32),
                    obj_box_fts=np.zeros((0, 3), np.float32),
                    obj_ids=[],
                )
            else:
                n = min(len(rec["fts"]), self.max_objects)
                dirs = np.asarray(rec["directions"][:n], np.float32)
                sizes = np.asarray(rec["sizes"][:n], np.float32)
                h, w = rec["image_hw"]
                ob.update(
                    obj_img_fts=np.asarray(rec["fts"][:n], np.float32),
                    obj_ang_fts=angle_features(
                        dirs[:, 0], dirs[:, 1], self.angle_feat_size
                    ),
                    obj_box_fts=np.stack(
                        [sizes[:, 1] / h, sizes[:, 0] / w,
                         sizes[:, 0] * sizes[:, 1] / (h * w)], axis=1
                    ).astype(np.float32),
                    obj_ids=list(rec["obj_ids"][:n]),
                )
            ob["gt_obj_id"] = item.get("objId")
            ob["gt_end_vps"] = item.get("end_vps", [item["path"][-1]])
        return obs

    # ------------------------------------------------------------------ eval
    def eval_item(self, scan, pred_path, gt_path, pred_objid=None,
                  gt_objid=None):
        g = self.graphs[scan]
        dist = g.distance
        path = sum(pred_path, [])
        assert path[0] == gt_path[0]
        goal_vps = set(self.obj2vps.get(f"{scan}_{gt_objid}", [gt_path[-1]]))
        traj_len = float(
            np.sum([dist(a, b) for a, b in zip(path[:-1], path[1:])])
        )
        gt_len = float(
            np.sum([dist(a, b) for a, b in zip(gt_path[:-1], gt_path[1:])])
        )
        scores = {
            "action_steps": len(pred_path) - 1,
            "trajectory_steps": len(path) - 1,
            "trajectory_lengths": traj_len,
            "success": float(path[-1] in goal_vps),
            "oracle_success": float(any(x in goal_vps for x in path)),
        }
        scores["spl"] = (
            scores["success"] * gt_len / max(traj_len, gt_len, 0.01)
        )
        scores["rgs"] = float(str(pred_objid) == str(gt_objid))
        scores["rgspl"] = scores["rgs"] * gt_len / max(traj_len, gt_len, 0.01)
        return scores

    def eval_metrics(self, preds: Sequence[dict]):
        from collections import defaultdict

        metrics = defaultdict(list)
        for item in preds:
            scan, gt_path, gt_objid = self.gt_trajs[item["instr_id"]]
            scores = self.eval_item(
                scan, item["trajectory"], gt_path,
                pred_objid=item.get("pred_objid"), gt_objid=gt_objid,
            )
            for k, v in scores.items():
                metrics[k].append(v)
        avg = {
            "action_steps": float(np.mean(metrics["action_steps"])),
            "steps": float(np.mean(metrics["trajectory_steps"])),
            "lengths": float(np.mean(metrics["trajectory_lengths"])),
            "sr": float(np.mean(metrics["success"]) * 100),
            "oracle_sr": float(np.mean(metrics["oracle_success"]) * 100),
            "spl": float(np.mean(metrics["spl"]) * 100),
            "rgs": float(np.mean(metrics["rgs"]) * 100),
            "rgspl": float(np.mean(metrics["rgspl"]) * 100),
        }
        return avg, dict(metrics)


class SoonObjectNavBatch(ReverieObjectNavBatch):
    """SOON: object pseudo-label bboxes; detection succeeds when the predicted
    object direction falls inside the ground-truth heading/elevation quad
    (ref soon/env.py:319-380)."""

    def eval_soon_item(self, pred_path, obj_heading, obj_elevation, gt_item):
        scan = gt_item["scan"]
        g = self.graphs[scan]
        dist = g.distance
        gt_path = gt_item["path"]
        gt_bboxes = gt_item["bboxes"]
        start_vp, goal_vp = gt_path[0], gt_path[-1]
        path = sum(pred_path, [])
        assert path[0] == gt_path[0]
        nearest = min(path, key=lambda vp: dist(vp, goal_vp))
        scores = {}
        if path[-1] in gt_bboxes:
            goal_vp = path[-1]
            bb = gt_bboxes[path[-1]]
            scores["heading_error"] = abs(bb["heading"] - obj_heading)
            scores["elevation_error"] = abs(bb["elevation"] - obj_elevation)
            scores["point_det_error"] = math.hypot(
                bb["heading"] - obj_heading, bb["elevation"] - obj_elevation
            )
            quad = [
                (bb["target"][c]["heading"], bb["target"][c]["elevation"])
                for c in ("left_top", "right_top", "right_bottom", "left_bottom")
            ]
            scores["det_success"] = point_in_convex_quad(
                (obj_heading, obj_elevation), quad
            )
        else:
            scores["det_success"] = False
        traj_len = float(
            np.sum([dist(a, b) for a, b in zip(path[:-1], path[1:])])
        )
        scores.update(
            action_steps=len(pred_path) - 1,
            trajectory_steps=len(path) - 1,
            trajectory_lengths=traj_len,
            nav_error=dist(path[-1], goal_vp),
            oracle_error=dist(nearest, goal_vp),
        )
        scores["success"] = scores["nav_error"] < ERROR_MARGIN
        scores["oracle_success"] = scores["oracle_error"] < ERROR_MARGIN
        scores["goal_progress"] = dist(start_vp, goal_vp) - dist(path[-1], goal_vp)
        gt_len = dist(gt_path[0], goal_vp)
        scores["spl"] = (
            scores["success"] * gt_len / max(traj_len, gt_len, 0.01)
        )
        scores["det_spl"] = (
            scores["det_success"] * gt_len / max(traj_len, gt_len, 0.01)
        )
        return scores
