"""DAgger navigation agent for discrete environments (port of
``vln_bevbert_tpu/nav/agent.py``), rollout-then-replay:

1. *Rollout*: each step runs the panorama encoder, the device BEV lift, the
   device neighbourhood gather + egocentric splat (the CUDA splat kernel on
   the card) and the navigation model on the device, in eval mode, and the
   graph bookkeeping, the variable building and the policy's node-embedding
   contraction on the host. The host work runs while the panorama forward is
   in flight: uploads go through pinned memory without waiting for the
   device, and the first host read of ``pano_embeds`` is the step's sync
   point. A training rollout records every step (``StepRecord``).
2. *Replay* (``_learn`` -> ``learn_from_bundle``): the recorded episode
   again, in training mode (dropout through the CUDA dropout kernel on the
   card): the language once, the panorama encoder over all steps jointly,
   then per step the node embeddings as a device contraction of those pano
   tokens and the navigation forward, one backward through the whole
   episode, the float32 global-norm clip and AdamW.

The host helpers (``_language_variable`` ... ``_make_equiv_action``) repeat
the JAX agent's: the port imports nothing of the JAX package. Object grounding
(REVERIE/SOON), the teacher-recollection store, the mesh-sharded replay and
the scan-block bench probes are not ported yet.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..configs import FinetuneConfig
from ..geometry import (
    bev_polar_pos,
    se3_from_xyzhe,
    world_to_ego_cells_stop_centre,
)
from ..models.bert import init_params
from ..models.glocal import cross_entropy
from ..models.nav import GlocalTextPathNavCMT
from ..models.surgery import count_transferred, transfer_pretrained
from ..ops.bev import BevProjector
from ..ops.dropout import set_dropout_generator
from ..parallel.optim import finetune_optim
from ..parallel.train_step import TrainState, load_checkpoint, save_checkpoint
from ..utils.device import to_device
from ..utils.rng import make_generator, train_generator
from .env import R2RNavBatch
from .eval_utils import compute_dtw_metrics
from .graph_map import GraphMap

IGNORE_ID = -100
FEEDBACKS = ("argmax", "teacher", "sample", "expl_sample")
# the supervised and acted-on head per fusion mode
LOGITS_KEY = {"local": "local_logits", "global": "global_logits", "avg": "fused_logits"}


@dataclass
class StepRecord:
    """What the replay needs of one training-rollout step: host arrays, and
    the step's BEV features as the device tensor the splat produced (no
    gradient flows into them). The object slots are not ported yet."""

    active: np.ndarray                 # (B,) bool
    view_fts: np.ndarray               # (B, V, Dimg)
    loc_fts: np.ndarray                # (B, V, A+3)
    nav_types: np.ndarray              # (B, V)
    view_lens: np.ndarray              # (B,)
    gmap_agg: np.ndarray               # (B, N, T*V)
    gmap_step_ids: np.ndarray          # (B, N)
    gmap_pos_fts: np.ndarray           # (B, N, A+3)
    gmap_masks: np.ndarray             # (B, N)
    gmap_visited_masks: np.ndarray     # (B, N)
    gmap_pair_dists: np.ndarray        # (B, N, N)
    targets: np.ndarray                # (B,), IGNORE_ID once ended
    bev_fts: Optional[torch.Tensor] = None       # (B, C, Dgrid) on the device
    bev_nav_masks: Optional[np.ndarray] = None   # (B, C)
    bev_cand_idxs: Optional[np.ndarray] = None   # (B, K)
    local_masks: Optional[np.ndarray] = None     # (B, K)
    fuse_map: Optional[np.ndarray] = None        # (B, N, K)
    bev_pos_fts: Optional[np.ndarray] = None     # (B, C, A+3+3)
    step_idx: int = 0


class DevicePcStore:
    """Device-resident per-step point-cloud memory, (B, T, P, ...) buffers.

    The JAX store updates functionally with donated buffers; here
    ``set_step`` writes step ``t`` in place (``buf[:, t] = x``). Features are
    kept in bfloat16."""

    def __init__(self, batch: int, max_steps: int, num_points: int,
                 feat_dim: int, device):
        self.pc = torch.zeros(batch, max_steps, num_points, 3, device=device)
        self.valid = torch.zeros(batch, max_steps, num_points, dtype=torch.bool,
                                 device=device)
        self.feats = torch.zeros(batch, max_steps, num_points, feat_dim,
                                 dtype=torch.bfloat16, device=device)

    def set_step(self, t: int, pc, valid, feats):
        self.pc[:, t] = pc
        self.valid[:, t] = valid
        self.feats[:, t] = feats


def gather_and_splat(projector: BevProjector, pc_buf, valid_buf, feat_buf,
                     step_sel, step_ok, T_w2c, S_w2c):
    """Device-side neighbourhood gather + egocentric splat.

    pc_buf (B, T, P, 3); step_sel (B, S) int32 step indices per sample;
    step_ok (B, S) slot validity. Only the points' positions and validity
    are gathered here; the splat reads the (B, T, P, C) features in place
    through ``step_sel``. Returns bev features (B, cells, C) float32."""
    b, s = step_sel.shape
    rows = torch.arange(b, device=step_sel.device)[:, None]
    sel = step_sel.long()
    pc = pc_buf[rows, sel]          # (B, S, P, 3)
    valid = valid_buf[rows, sel] & step_ok[:, :, None]
    p = pc.shape[2]
    cell, geo_ok = projector.ego_cells(pc.reshape(b, s * p, 3), T_w2c, S_w2c)
    bev, _, _, _ = projector.splat(
        cell, valid.reshape(b, s * p) & geo_ok, feat_buf, step_sel=step_sel
    )
    return bev


class GMapNavAgent:
    def __init__(self, cfg: FinetuneConfig, env: R2RNavBatch, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.env = env
        self.seed = seed
        self.device = torch.device(device)
        self.model = GlocalTextPathNavCMT(cfg.model, device=self.device).eval()
        self.projector = BevProjector(
            vfov=math.radians(90.0),
            grid_hw=cfg.shapes.grid_hw,
            num_views=cfg.shapes.num_views,
            map_dim=cfg.model.bev_dim,
            map_res=cfg.model.bev_res,
            z_clip=0.5,
            device=self.device,
        )
        self.polar = bev_polar_pos(cfg.model.bev_dim).reshape(-1, 3)
        self.np_rng = np.random.default_rng(seed)
        # dropout in the replay draws its per-row seeds from here
        set_dropout_generator(self.model, train_generator(seed, self.device))
        self._state: Optional[TrainState] = None
        self.transferred: Optional[int] = None
        self.logs: Dict[str, List[float]] = {"IL_loss": [], "grad_norm": [], "entropy": []}

    # ------------------------------------------------------------------ init
    def init_params(self, generator: Optional[torch.Generator] = None,
                    pretrained: Optional[Mapping[str, torch.Tensor]] = None) -> Optional[int]:
        """Random parameters from a seeded generator on the agent's device;
        with ``pretrained`` (a state dict, e.g. a pretraining model's), every
        entry of it whose name and shape the navigation model shares replaces
        the fresh value. Returns how many entries were transferred, or None
        (also kept as ``self.transferred``)."""
        init_params(self.model, generator or make_generator(self.seed, self.device))
        self.transferred = None
        if pretrained is not None:
            fresh = self.model.state_dict()
            self.model.load_state_dict(transfer_pretrained(pretrained, fresh))
            self.transferred = count_transferred(pretrained, fresh)
        return self.transferred

    @property
    def train_state(self) -> TrainState:
        """Gradient buffers and the fine-tuning AdamW state, made at first use
        (an eval-only agent holds none)."""
        if self._state is None:
            self._state = TrainState(self.model, finetune_optim(self.cfg), decay_all=True)
        return self._state

    # ---------------------------------------------------------------- device
    def _upload(self, x) -> torch.Tensor:
        """numpy -> tensor on the agent's device, without waiting for the
        device's queued work (pinned staging + non-blocking copy)."""
        return to_device(x, self.device)

    @torch.inference_mode()
    def _forward(self, mode: str, batch: Dict[str, Any]):
        """One model call ('language' / 'panorama' / 'navigation')."""
        return self.model(mode, {k: self._upload(v) for k, v in batch.items()})

    # ------------------------------------------------------------- variables
    def _language_variable(self, obs):
        # bucket text length to multiples of 32, as the JAX agent does
        raw = max(len(ob["instr_encoding"]) for ob in obs)
        L = min(((raw + 31) // 32) * 32, self.cfg.max_instr_len)
        B = len(obs)
        ids = np.zeros((B, L), np.int32)
        masks = np.zeros((B, L), bool)
        for i, ob in enumerate(obs):
            enc = np.asarray(ob["instr_encoding"])[:L]
            ids[i, : len(enc)] = enc
            masks[i, : len(enc)] = True
        return {"txt_ids": ids, "txt_masks": masks}

    def _panorama_variable(self, obs):
        """Static slots: candidate views first, then the remaining views."""
        sh, m = self.cfg.shapes, self.cfg.model
        B, V = len(obs), sh.max_pano_len
        A = m.angle_feat_size
        view_fts = np.zeros((B, V, m.image_feat_size), np.float32)
        loc_fts = np.zeros((B, V, A + 3), np.float32)
        nav_types = np.zeros((B, V), np.int32)
        view_lens = np.zeros(B, np.int32)
        cand_vpids: List[List[str]] = []
        for i, ob in enumerate(obs):
            used = set()
            k = 0
            cands = []
            for cand in ob["candidate"]:
                if k >= V:
                    break
                view_fts[i, k] = cand["feature"][: m.image_feat_size]
                loc_fts[i, k, :A] = cand["feature"][m.image_feat_size :]
                loc_fts[i, k, A:] = 1.0
                nav_types[i, k] = 1
                used.add(cand["pointId"])
                cands.append(cand["viewpointId"])
                k += 1
            feat36 = ob["feature"]
            for view in range(36):
                if view in used or k >= V:
                    continue
                view_fts[i, k] = feat36[view, : m.image_feat_size]
                loc_fts[i, k, :A] = feat36[view, m.image_feat_size :]
                loc_fts[i, k, A:] = 1.0
                k += 1
            view_lens[i] = k
            cand_vpids.append(cands)
        out = {"view_fts": view_fts, "loc_fts": loc_fts, "nav_types": nav_types,
               "view_lens": view_lens}
        return out, cand_vpids

    def lift(self, obs):
        """World point clouds from the agent-relative camera ring. Depth is
        stored metres/10. Returns device tensors (points, valid, feats)."""
        B = len(obs)
        nv = self.cfg.shapes.num_views
        xyzhe = np.zeros((B, nv, 5), np.float32)
        for i, ob in enumerate(obs):
            x, y, z = ob["position"]
            xyzhe[i, :, 0] = x
            xyzhe[i, :, 1] = z
            xyzhe[i, :, 2] = -y
            xyzhe[i, :, 3] = -(np.arange(nv) * (2 * math.pi / nv) + ob["heading"])
            xyzhe[i, :, 4] = math.pi
        T = se3_from_xyzhe(xyzhe.reshape(-1, 5)).reshape(B, nv, 4, 4).astype(np.float32)
        depths = np.stack([ob["depth"] for ob in obs]).astype(np.float32) * 10.0
        pc, no_depth = self.projector.lift(self._upload(depths), self._upload(T))
        feats = self._upload(
            np.stack([ob["rgb"] for ob in obs]).reshape(B, -1, self.cfg.model.bev_grid_feat_size)
        )
        return pc, ~no_depth, feats

    def _make_pc_store(self, B: int) -> DevicePcStore:
        return DevicePcStore(B, self.cfg.max_action_len, self.cfg.shapes.num_points,
                             self.cfg.model.bev_grid_feat_size, self.device)

    def _nav_gmap_variable(self, obs, gmaps, pano_store):
        """Global-map tensors + aggregation matrix for the policy."""
        sh, m = self.cfg.shapes, self.cfg.model
        B, N = len(obs), sh.max_gmap_len
        V = sh.max_pano_len
        T = self.cfg.max_action_len
        A = m.angle_feat_size
        out = {
            "gmap_vpids": [],
            "gmap_agg": np.zeros((B, N, T * V), np.float32),
            "gmap_step_ids": np.zeros((B, N), np.int32),
            "gmap_pos_fts": np.zeros((B, N, A + 3), np.float32),
            "gmap_masks": np.zeros((B, N), bool),
            "gmap_visited_masks": np.zeros((B, N), bool),
            "gmap_pair_dists": np.zeros((B, N, N), np.float32),
            "no_vp_left": [],
        }
        for i, (ob, gmap) in enumerate(zip(obs, gmaps)):
            if self.cfg.act_visited_nodes:
                # only the current node counts as visited
                visited = [k for k in gmap.node_positions if k == ob["viewpoint"]]
                unvisited = [k for k in gmap.node_positions if k != ob["viewpoint"]]
            else:
                visited = [k for k in gmap.node_positions if gmap.graph.visited(k)]
                unvisited = [k for k in gmap.node_positions if not gmap.graph.visited(k)]
            out["no_vp_left"].append(len(unvisited) == 0)
            vpids = ([None] + visited + unvisited)[:N]
            n = len(vpids)
            out["gmap_vpids"].append(vpids)
            out["gmap_masks"][i, :n] = True
            out["gmap_visited_masks"][i, 1 : 1 + len(visited)] = True
            out["gmap_step_ids"][i, :n] = [
                min(gmap.node_step_ids.get(vp, 0), m.max_action_steps - 1)
                for vp in vpids
            ]
            out["gmap_pos_fts"][i, :n] = gmap.get_pos_fts(
                ob["viewpoint"], vpids, ob["heading"], ob["elevation"], A
            )
            for a in range(1, n):
                for b in range(a + 1, n):
                    d = gmap.graph.distance(vpids[a], vpids[b]) / 30.0
                    out["gmap_pair_dists"][i, a, b] = d
                    out["gmap_pair_dists"][i, b, a] = d
            for node, vp in enumerate(vpids):
                if vp is None:
                    continue
                refs = gmap.node_embed_refs.get(vp, [])
                if not refs:
                    continue
                w = 1.0 / len(refs)
                for (t, slot, _wt) in refs:
                    if slot == -1:
                        # visited: mean over the valid slots of that step's pano
                        vl = int(pano_store["view_lens"][t][i])
                        out["gmap_agg"][i, node, t * V : t * V + vl] += w / max(vl, 1)
                    else:
                        out["gmap_agg"][i, node, t * V + slot] += w
        return out

    def _nav_bev_variable(self, obs, gmaps, pc_store: DevicePcStore):
        """Gather neighbourhood point clouds from the device store, splat them
        to the egocentric BEV on the device, map candidates to cells."""
        sh, m = self.cfg.shapes, self.cfg.model
        B = len(obs)
        C, K = m.num_bev_tokens, sh.max_local_len
        S_max = sh.max_pc_steps
        A = m.angle_feat_size
        step_sel = np.zeros((B, S_max), np.int32)
        step_ok = np.zeros((B, S_max), bool)
        S_w2c = np.zeros((B, 3), np.float32)
        T_w2c = np.zeros((B, 4, 4), np.float32)
        bev_nav_masks = np.zeros((B, C), bool)
        bev_cand_idxs = np.zeros((B, K), np.int32)
        local_masks = np.zeros((B, K), bool)
        bev_cand_vpids: List[List[Optional[str]]] = []
        bev_pos_fts = np.zeros((B, C, A + 3 + 3), np.float32)
        for i, (ob, gmap) in enumerate(zip(obs, gmaps)):
            steps = gmap.gather_pc_steps(ob["viewpoint"], self.cfg.pc_order)[-S_max:]
            step_sel[i, : len(steps)] = steps
            step_ok[i, : len(steps)] = True
            x, y, z = ob["position"]
            S_w2c[i] = [x, z, -y]
            T_w2c[i] = se3_from_xyzhe(
                np.array([[0, 0, 0, ob["heading"], 0]], np.float32)
            )[0]
            cand_pos = np.array(
                [c["position"] for c in ob["candidate"]], np.float64
            ).reshape(-1, 3)
            cells = world_to_ego_cells_stop_centre(
                cand_pos, np.asarray(ob["position"]), ob["heading"],
                m.bev_dim, m.bev_res,
            )[:K]
            bev_cand_idxs[i, : len(cells)] = cells
            local_masks[i, : len(cells)] = True
            bev_nav_masks[i, cells] = True
            bev_cand_vpids.append(
                ([None] + [c["viewpointId"] for c in ob["candidate"]])[:K]
            )
            gpos = gmap.get_pos_fts(
                ob["viewpoint"], [gmap.start_vp], ob["heading"], ob["elevation"], A
            )[0]
            bev_pos_fts[i, :, : A + 3] = gpos
            bev_pos_fts[i, :, A + 3 :] = self.polar
        bev_fts = gather_and_splat(
            self.projector, pc_store.pc, pc_store.valid, pc_store.feats,
            self._upload(step_sel), self._upload(step_ok),
            self._upload(T_w2c), self._upload(S_w2c),
        )
        return {
            "bev_fts": bev_fts,
            "bev_pos_fts": bev_pos_fts,
            "bev_nav_masks": bev_nav_masks,
            "bev_cand_idxs": bev_cand_idxs,
            "local_masks": local_masks,
            "bev_cand_vpids": bev_cand_vpids,
        }

    def _build_fuse_map(self, gmap_vpids, gmap_visited_masks, bev_cand_vpids):
        sh = self.cfg.shapes
        B, N, K = len(gmap_vpids), sh.max_gmap_len, sh.max_local_len
        fm = np.zeros((B, N, K), np.float32)
        for i in range(B):
            fm[i, 0, 0] = 1.0
            visited = {
                vp for vp, m in zip(gmap_vpids[i], gmap_visited_masks[i]) if m and vp
            }
            back_cols = [
                k for k, vp in enumerate(bev_cand_vpids[i])
                if k > 0 and vp in visited
            ]
            fresh = {
                vp: k for k, vp in enumerate(bev_cand_vpids[i])
                if k > 0 and vp not in visited
            }
            for n, vp in enumerate(gmap_vpids[i]):
                if n == 0 or vp is None or vp in visited:
                    continue
                if vp in fresh:
                    fm[i, n, fresh[vp]] = 1.0
                else:
                    for k in back_cols:
                        fm[i, n, k] = 1.0
        return fm

    # --------------------------------------------------------------- teacher
    def _teacher_action(self, obs, vpids, ended, visited_masks=None,
                        imitation_learning=False, t=None, traj=None):
        a = np.full(len(obs), IGNORE_ID, np.int64)
        for i, ob in enumerate(obs):
            if ended[i]:
                continue
            g = self.env.graphs[ob["scan"]]
            if imitation_learning:
                if ob["viewpoint"] != ob["gt_path"][t]:
                    a[i] = IGNORE_ID
                    continue
                if t == len(ob["gt_path"]) - 1:
                    a[i] = 0
                else:
                    goal = ob["gt_path"][t + 1]
                    for j, vp in enumerate(vpids[i]):
                        if vp == goal:
                            a[i] = j
                            break
                continue
            if ob["viewpoint"] == ob["gt_path"][-1]:
                a[i] = 0
                continue
            best, best_j = math.inf, IGNORE_ID
            for j, vp in enumerate(vpids[i]):
                if j == 0 or vp is None:
                    continue
                if visited_masks is not None and visited_masks[i][j]:
                    continue
                if self.cfg.expert_policy == "ndtw":
                    cand_path = (
                        sum(traj[i]["path"], [])
                        + self.env.graphs[ob["scan"]].path(ob["viewpoint"], vp)
                    )
                    cost = -compute_dtw_metrics(
                        g.distance, cand_path, ob["gt_path"], threshold=3.0
                    )["nDTW"]
                else:  # spl expert
                    cost = g.distance(vp, ob["gt_path"][-1]) + g.distance(
                        ob["viewpoint"], vp
                    )
                if cost < best:
                    best, best_j = cost, j
            a[i] = best_j
        return a

    # --------------------------------------------------------------- rollout
    def rollout(self, feedback: str = "argmax", train: bool = False):
        """One batch of episodes. ``feedback``: 'argmax' (greedy), 'teacher'
        (follow the expert), 'sample' (draw from the policy's softmax),
        'expl_sample' (argmax, exploring w.p. ``1 - expl_max_ratio``). With
        ``train`` every step is recorded and one replay update follows.
        Returns (trajectories, the update's loss or None)."""
        if feedback not in FEEDBACKS:
            raise ValueError(f"unknown feedback {feedback!r}")
        # a training rollout records the splat's BEV features for the
        # replay's graph: inference tensors cannot be saved for backward
        with torch.no_grad() if train else torch.inference_mode():
            traj, lang, records = self._rollout(feedback, train)
        loss = None
        if train and records:
            loss = self._learn(lang, records)
        return traj, loss

    def _rollout(self, feedback: str, train: bool):
        cfg = self.cfg
        obs = self.env.reset()
        B = len(obs)
        T = cfg.max_action_len

        gmaps = [GraphMap(ob["viewpoint"]) for ob in obs]
        for i, ob in enumerate(obs):
            gmaps[i].update_graph(ob)
        traj = [
            {"instr_id": ob["instr_id"], "path": [[ob["viewpoint"]]], "pred_objid": None}
            for ob in obs
        ]
        lang = self._language_variable(obs)
        txt_embeds = self._forward("language", lang)

        ended = np.zeros(B, bool)
        just_ended = np.zeros(B, bool)
        pano_store = {"view_lens": {}, "embeds": {}}
        pc_store = self._make_pc_store(B)
        records: List[StepRecord] = []

        for t in range(T):
            for i, gmap in enumerate(gmaps):
                if not ended[i]:
                    gmap.node_step_ids[obs[i]["viewpoint"]] = t + 1

            # enqueue the pano forward, then do every piece of host work that
            # does not need its result before reading it back
            pano_in, cand_vpids = self._panorama_variable(obs)
            pano_embeds, _ = self._forward("panorama", pano_in)
            pano_store["view_lens"][t] = pano_in["view_lens"]

            pc, pc_valid, pc_feats = self.lift(obs)
            pc_store.set_step(t, pc, pc_valid, pc_feats)

            for i, gmap in enumerate(gmaps):
                if ended[i]:
                    continue
                vp = obs[i]["viewpoint"]
                gmap.set_visited_embed(vp, t, pano_in["view_lens"][i])
                gmap.set_node_pc(vp, t)
                for j, cand_vp in enumerate(cand_vpids[i]):
                    if not gmap.graph.visited(cand_vp):
                        gmap.add_sighting(cand_vp, t, j)

            nav_g = self._nav_gmap_variable(obs, gmaps, pano_store)
            nav_b = self._nav_bev_variable(obs, gmaps, pc_store)
            fuse_map = self._build_fuse_map(
                nav_g["gmap_vpids"], nav_g["gmap_visited_masks"],
                nav_b["bev_cand_vpids"],
            )
            # first point that needs the pano result on the host: sync here
            pano_store["embeds"][t] = pano_embeds.float().cpu().numpy()
            gmap_img = self._policy_node_embeds(nav_g["gmap_agg"], pano_store, B)
            nav_in = {
                "txt_embeds": txt_embeds,
                "txt_masks": lang["txt_masks"],
                "gmap_img_embeds": gmap_img,
                "gmap_step_ids": nav_g["gmap_step_ids"],
                "gmap_pos_fts": nav_g["gmap_pos_fts"],
                "gmap_masks": nav_g["gmap_masks"],
                "gmap_pair_dists": nav_g["gmap_pair_dists"],
                "gmap_visited_masks": nav_g["gmap_visited_masks"],
                "bev_fts": nav_b["bev_fts"],
                "bev_pos_fts": nav_b["bev_pos_fts"],
                "bev_masks": np.ones((B, self.cfg.model.num_bev_tokens), bool),
                "bev_nav_masks": nav_b["bev_nav_masks"],
                "bev_cand_idxs": nav_b["bev_cand_idxs"],
                "local_masks": nav_b["local_masks"],
                "fuse_map": fuse_map,
            }
            nav_outs = self._forward("navigation", nav_in)
            nav_vpids = (
                nav_b["bev_cand_vpids"] if cfg.fusion == "local" else nav_g["gmap_vpids"]
            )

            # the host teacher overlaps the device navigation forward
            targets = self._teacher_action(
                obs, nav_vpids, ended,
                visited_masks=(
                    None if cfg.fusion == "local" else nav_g["gmap_visited_masks"]
                ),
                imitation_learning=(feedback == "teacher"), t=t, traj=traj,
            )

            # float32 logits, then the JAX agent's numpy ops: equal logits
            # give equal probabilities and equal sampled actions
            nav_logits = nav_outs[LOGITS_KEY.get(cfg.fusion, "fused_logits")].float().cpu().numpy()
            nav_probs = np.exp(nav_logits - nav_logits.max(-1, keepdims=True))
            nav_probs /= nav_probs.sum(-1, keepdims=True)

            for i, gmap in enumerate(gmaps):
                if not ended[i]:
                    gmap.node_stop_scores[obs[i]["viewpoint"]] = float(nav_probs[i, 0])

            if train:
                records.append(StepRecord(
                    active=~ended.copy(),
                    view_fts=pano_in["view_fts"], loc_fts=pano_in["loc_fts"],
                    nav_types=pano_in["nav_types"], view_lens=pano_in["view_lens"],
                    gmap_agg=nav_g["gmap_agg"], gmap_step_ids=nav_g["gmap_step_ids"],
                    gmap_pos_fts=nav_g["gmap_pos_fts"], gmap_masks=nav_g["gmap_masks"],
                    gmap_visited_masks=nav_g["gmap_visited_masks"],
                    gmap_pair_dists=nav_g["gmap_pair_dists"],
                    targets=np.where(ended, IGNORE_ID, targets),
                    bev_fts=nav_b["bev_fts"], bev_nav_masks=nav_b["bev_nav_masks"],
                    bev_cand_idxs=nav_b["bev_cand_idxs"], local_masks=nav_b["local_masks"],
                    fuse_map=fuse_map, bev_pos_fts=nav_b["bev_pos_fts"], step_idx=t,
                ))

            a_t = self._pick_actions(feedback, targets, nav_logits, nav_probs, nav_g, nav_b)
            if feedback in ("teacher", "sample"):
                a_t_stop = [ob["viewpoint"] == ob["gt_path"][-1] for ob in obs]
            else:
                a_t_stop = a_t == 0

            actions: List[Optional[str]] = []
            for i in range(B):
                if (
                    a_t_stop[i]
                    or ended[i]
                    or nav_g["no_vp_left"][i]
                    or t == T - 1
                    or targets[i] == IGNORE_ID and feedback == "teacher"
                ):
                    actions.append(None)
                    just_ended[i] = True
                else:
                    actions.append(nav_vpids[i][a_t[i]])

            self._make_equiv_action(actions, gmaps, obs, traj)

            # stop-node backtrack on episode end
            for i in range(B):
                if not ended[i] and just_ended[i]:
                    stop_node, stop_score = None, -math.inf
                    for vp, sc in gmaps[i].node_stop_scores.items():
                        if sc > stop_score:
                            stop_node, stop_score = vp, sc
                    if stop_node is not None and obs[i]["viewpoint"] != stop_node:
                        traj[i]["path"].append(
                            gmaps[i].graph.path(obs[i]["viewpoint"], stop_node)
                        )

            obs = self.env.get_obs()
            for i, ob in enumerate(obs):
                if not ended[i]:
                    gmaps[i].update_graph(ob)
            ended |= np.array([a is None for a in actions])
            if ended.all():
                break
        return traj, lang, records

    def _pick_actions(self, feedback, targets, nav_logits, nav_probs, nav_g, nav_b):
        """The step's action index per sample; draws from ``np_rng`` in the
        JAX agent's order."""
        if feedback == "teacher":
            return targets
        a_t = nav_logits.argmax(-1)
        if feedback == "sample":
            a_t = np.array([self.np_rng.choice(len(p), p=p) for p in nav_probs])
            with np.errstate(divide="ignore", invalid="ignore"):
                ent = -np.nansum(np.where(nav_probs > 0, nav_probs * np.log(nav_probs), 0.0), -1)
            self.logs["entropy"].append(float(ent.sum()))
        elif feedback == "expl_sample":
            if self.cfg.fusion == "local":
                actionable = np.asarray(nav_b["bev_nav_masks"], bool)
            else:
                actionable = nav_g["gmap_masks"] & ~nav_g["gmap_visited_masks"]
            explore = self.np_rng.random(len(a_t)) > self.cfg.expl_max_ratio
            for i in range(len(a_t)):
                if explore[i] and actionable[i].any():
                    a_t[i] = self.np_rng.choice(np.arange(actionable.shape[1])[actionable[i]])
        return a_t

    def _policy_node_embeds(self, gmap_agg, pano_store, B):
        """Host float32 contraction of the stored pano tokens."""
        V = self.cfg.shapes.max_pano_len
        T = self.cfg.max_action_len
        D = self.cfg.model.hidden_size
        tokens = np.zeros((B, T * V, D), np.float32)
        for t, emb in pano_store["embeds"].items():
            tokens[:, t * V : t * V + emb.shape[1]] = emb
        return np.einsum("bnm,bmd->bnd", gmap_agg, tokens).astype(np.float32)

    def _make_equiv_action(self, actions, gmaps, obs, traj):
        """Teleport to the chosen node along the map's shortest path."""
        for i, ob in enumerate(obs):
            act = actions[i]
            if act is None:
                continue
            path = gmaps[i].graph.path(ob["viewpoint"], act)
            traj[i]["path"].append(path)
            prev = traj[i]["path"][-2][-1] if len(path) == 1 else path[-2]
            cands = self.env.scanvp_cands.get(f"{ob['scan']}_{prev}", {})
            viewidx = cands.get(act, [12])[0]
            self.env.teleport(i, act, (viewidx % 12) * math.radians(30.0))

    # ----------------------------------------------------------------- learn
    def _learn(self, lang, records: List[StepRecord]) -> float:
        """Stack the records to T = ``max_action_len`` steps, padding with
        zeros and IGNORE_ID targets (the JAX agent's bundle), and replay them.
        The BEV features stay on the device."""
        T = self.cfg.max_action_len
        pad = T - len(records)

        def stack(attr):
            arrs = [np.asarray(getattr(r, attr)) for r in records]
            return np.stack(arrs + [np.zeros_like(arrs[0])] * pad)

        keys = ["view_fts", "loc_fts", "nav_types", "view_lens", "gmap_agg",
                "gmap_step_ids", "gmap_pos_fts", "gmap_masks", "gmap_pair_dists",
                "gmap_visited_masks"]
        if self.cfg.model.use_bev:
            keys += ["bev_nav_masks", "bev_cand_idxs", "local_masks", "fuse_map",
                     "bev_pos_fts"]
        rb: Dict[str, Any] = {k: stack(k) for k in keys}
        if self.cfg.model.use_bev:
            bev = [r.bev_fts for r in records]
            rb["bev_fts"] = torch.stack(bev + [torch.zeros_like(bev[0])] * pad)
        tgt = [r.targets for r in records]
        rb["targets"] = np.stack(tgt + [np.full_like(tgt[0], IGNORE_ID)] * pad)
        rb["txt_ids"] = lang["txt_ids"]
        rb["txt_masks"] = lang["txt_masks"]
        rb["step_idx"] = np.arange(T, dtype=np.int32)
        return self.learn_from_bundle(rb)

    def _episode_loss(self, rb: Mapping[str, Any]) -> torch.Tensor:
        """The episode's imitation loss, differentiable in the parameters, in
        the model's current mode (the replay runs it in training mode).

        ``rb`` holds step-leading (T, B, ...) arrays (``txt_*`` are (B, L)).
        The panorama encoder runs over all T*B step-rows at once; then each
        step's node embeddings are the float32 contraction of the recorded
        aggregation matrix with those tokens on the device, so the gradient
        of a later step reaches the earlier steps' panoramas. Per step a
        sum-reduction cross-entropy with IGNORE_ID on the fusion-selected
        head; the total is scaled by ``ml_weight / B``."""
        cfg = self.cfg
        use_bev = cfg.model.use_bev
        dev = {k: self._upload(v) for k, v in rb.items()}
        T, B = dev["view_fts"].shape[:2]
        txt_masks = dev["txt_masks"]
        txt_embeds = self.model("language", {"txt_ids": dev["txt_ids"], "txt_masks": txt_masks})
        pano_embeds, pano_masks = self.model("panorama", {
            k: dev[k].reshape(T * B, *dev[k].shape[2:])
            for k in ("view_fts", "loc_fts", "nav_types", "view_lens")
        })
        P, D = pano_embeds.shape[1:]
        tokens = (pano_embeds * pano_masks[..., None]).reshape(T, B, P, D)
        tokens = tokens.transpose(0, 1).reshape(B, T * P, D).float()
        logits_key = LOGITS_KEY[cfg.fusion] if use_bev else "global_logits"
        targets = np.asarray(rb["targets"])
        total = torch.zeros((), device=self.device)
        for t in range(T):
            # a step whose targets are all IGNORE_ID (the padding after an
            # episode's last step) adds exactly zero to the loss and the
            # gradient: the JAX scan runs it, the port skips it
            if (targets[t] == IGNORE_ID).all():
                continue
            nav_in = {
                "txt_embeds": txt_embeds, "txt_masks": txt_masks,
                "gmap_img_embeds": torch.matmul(dev["gmap_agg"][t].float(), tokens),
                **{k: dev[k][t] for k in ("gmap_step_ids", "gmap_pos_fts", "gmap_masks",
                                          "gmap_pair_dists", "gmap_visited_masks")},
            }
            if use_bev:
                nav_in.update({k: dev[k][t] for k in ("bev_fts", "bev_pos_fts", "bev_nav_masks",
                                                       "bev_cand_idxs", "local_masks",
                                                       "fuse_map")})
                nav_in["bev_masks"] = torch.ones(dev["bev_fts"].shape[1:3], dtype=torch.bool,
                                                 device=self.device)
            outs = self.model("navigation", nav_in)
            total = total + cross_entropy(outs[logits_key], dev["targets"][t])[0].sum()
        return total * cfg.ml_weight / B

    @contextlib.contextmanager
    def _training(self):
        self.model.train()
        try:
            yield
        finally:
            self.model.eval()

    def learn_from_bundle(self, rb: Mapping[str, Any]) -> float:
        """One replay update from a bundle (``_learn``'s, or any in its
        layout, e.g. ``vln_bevbert_tpu.data.synthetic.synthetic_replay_bundle``):
        the episode loss with dropout on, its backward, the float32
        global-norm clip and AdamW. Reads back once, as the JAX agent reads
        its loss: the loss and the gradient norm, appended to ``logs``."""
        state = self.train_state
        with self._training():
            loss = self._episode_loss(rb)
        loss.backward()
        gnorm = state.apply_gradients()
        loss_val, gnorm_val = torch.stack([loss.detach(), gnorm]).tolist()
        self.logs["IL_loss"].append(loss_val)
        self.logs["grad_norm"].append(gnorm_val)
        return loss_val

    def train_iters(self, n_iters: int, feedback: str = "sample") -> List[float]:
        """``n_iters`` training rollouts, each followed by its replay update;
        'dagger' runs a teacher-forced and a sampled rollout per iteration."""
        losses = []
        for _ in range(n_iters):
            runs = ("teacher", "sample") if feedback == "dagger" else (feedback,)
            for fb in runs:
                _, loss = self.rollout(feedback=fb, train=True)
                if loss is not None:
                    losses.append(loss)
        return losses

    # ----------------------------------------------------------- checkpoints
    def save_ckpt(self, path: str) -> str:
        """Parameters and the AdamW state (bf16 mu, f32 nu, count), one torch file."""
        return save_checkpoint(path, self.model, self.train_state)

    def restore_ckpt(self, path: str, with_opt: bool = True) -> None:
        ckpt = load_checkpoint(path, self.device)
        self.model.load_state_dict(ckpt["params"])
        if with_opt:
            self.train_state.load_state_dict(ckpt["opt_state"])

    # ------------------------------------------------------------------ test
    def test(self, max_batches: Optional[int] = None):
        """Greedy evaluation over the dataset until it wraps."""
        self.env.reset_epoch(shuffle=False)
        results = {}
        n = 0
        while True:
            trajs, _ = self.rollout(feedback="argmax", train=False)
            looped = False
            for tr in trajs:
                if tr["instr_id"] in results:
                    looped = True
                else:
                    results[tr["instr_id"]] = tr
            n += 1
            if looped or (max_batches and n >= max_batches):
                break
        return [
            {"instr_id": k, "trajectory": v["path"], "pred_objid": v.get("pred_objid")}
            for k, v in results.items()
        ]


class _EnvStub:
    """The env surface a replay-only agent needs: none beyond its batch."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size


def make_replay_agent(cfg: FinetuneConfig, batch_size: int, seed: int = 0,
                      device="cpu") -> GMapNavAgent:
    """An env-less agent with random parameters, for replay updates from
    prepared bundles."""
    agent = GMapNavAgent(cfg, _EnvStub(batch_size), seed=seed, device=device)
    agent.init_params()
    return agent
