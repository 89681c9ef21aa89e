"""Continuous-environment navigation agent, the SS-BEV trainer core (port of
``vln_bevbert_tpu/ce/agent.py``), on the discrete agent's
rollout-then-replay machinery.

Per rollout step: the frozen waypoint predictor proposes candidates from the
12 views' depth features (on the device, under ``inference_mode``, then the
host NMS); the panorama encoder runs over [candidates | 12 views]; the
step's point cloud is lifted into the device store; the ghost-node
``CEGraphMap`` takes the candidates; the 11x11 BEV is splatted from the
gathered point clouds (``gather_and_splat``, the CUDA splat kernel on the
card); the navigation model scores stop and the ghosts. Training rollouts
use scheduled sampling (teacher w.p. ``sample_ratio``) and the discrete
agent's replay (``_learn``, dropout through the CUDA dropout kernel).

The habitat frame is already y-up: ``_ce_lift`` and ``_ce_bev_variable``
take positions as they come, where the discrete agent swaps to (x, z, -y).
Eval rollouts with ``cfg.ce_back_algo == 'control'`` walk the map with the
low-level controller (``ce/control.py``); training rollouts teleport.
With ``cfg.model.use_bev`` False (the topo-only ETP trainer) there is no
point-cloud store, no lift and no splat, and the global logits decide.

The frozen predictor is ``self.wp_model``: outside ``self.model``, so outside
the optimizer and the agent's checkpoints. Every host draw comes from one
``np_rng``, in the JAX agent's order: the waypoint sampling, the ghost
noise, the action sample and the teacher coin, the controller's tryout side.

Data parallelism (JAX's ``mesh=``): rank ``rank`` of ``world`` acts in an env
that holds its rows of the global batch, and every rank makes the draws of
every row in the one process's order and keeps its own: the waypoint
sampling runs over the gathered heatmaps, the ghost noise over the gathered
ghost counts, the action sample and the teacher coin over the gathered
probabilities, and the controller's tryout coins in rank turns. The rollout
ends when every rank's rows have ended, and ``evaluate`` averages the
episodes of every rank. So W ranks of b rows take the trajectories, and
leave ``np_rng`` in the state, of one process at W * b rows.
"""

from __future__ import annotations

import copy
import functools
import math
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from ..configs import FinetuneConfig
from ..geometry import angle_features, se3_from_xyzhe
from ..models.bert import init_params
from ..nav.agent import IGNORE_ID, GMapNavAgent, StepRecord, gather_and_splat
from ..parallel import distributed
from ..utils.rng import make_generator
from .control import LowLevelController
from .env import SUCCESS_DISTANCE, SyntheticContinuousEnv
from .graph_map import CEGraphMap
from .waypoint_predictor import WaypointPredictor, extract_waypoints

CE_FEEDBACKS = ("argmax", "teacher", "sample")


class CEAgent(GMapNavAgent):
    def __init__(self, cfg: FinetuneConfig, env: SyntheticContinuousEnv, seed: int = 0,
                 loc_noise: float = 0.5, ghost_aug: float = 0.0, sample_ratio: float = 0.75,
                 waypoint_aug: bool = True, device="cuda"):
        super().__init__(cfg, env, seed=seed, device=device)
        self.loc_noise = loc_noise
        self.ghost_aug = ghost_aug
        self.sample_ratio = sample_ratio
        self.waypoint_aug = waypoint_aug  # ref IL.waypoint_aug
        self.wp_model = WaypointPredictor(
            cfg.model, depth_feat_size=int(np.prod(env.depth_feat_shape)), device=self.device,
        ).eval().requires_grad_(False)

    # ------------------------------------------------------------------ init
    def init_params(self, generator: Optional[torch.Generator] = None,
                    pretrained: Optional[Mapping[str, torch.Tensor]] = None,
                    wp_params: Optional[Mapping[str, torch.Tensor]] = None) -> Optional[int]:
        """The navigation model as ``GMapNavAgent.init_params`` makes it; the
        frozen waypoint predictor from ``wp_params`` (a ``WaypointPredictor``
        state dict, e.g. ``frozen.load_waypoint_params``'s) or random from a
        generator seeded 7."""
        transferred = super().init_params(generator, pretrained)
        if wp_params is None:
            init_params(self.wp_model, make_generator(7, self.device))
        else:
            self.wp_model.load_state_dict(wp_params)
        return transferred

    # ------------------------------------------------------------ per-step IO
    def _waypoints(self, obs, train: bool):
        """Frozen waypoint prediction, then the host NMS: per sample the
        candidates' (angles, distances). Returns them and the heatmap."""
        env = self.env
        depth = np.concatenate([ob["depth_features"] for ob in obs], 0).reshape(
            len(obs) * env.num_views, *env.depth_feat_shape)
        with torch.inference_mode():
            heat = self.wp_model(self._upload(depth)).cpu().numpy()
        sampled = train and self.waypoint_aug
        # sampling draws per peak of every row: over the global rows
        angles, dists, _ = extract_waypoints(
            self._global_rows(heat) if sampled else heat,
            max_candidates=min(5, self.cfg.shapes.max_local_len - 1),
            in_train=sampled, rng=self.np_rng,
        )
        if sampled:
            angles, dists = self._own_rows(angles), self._own_rows(dists)
        return angles, dists, heat

    def _ce_panorama_variable(self, obs, cand_angles, cand_dists):
        """Pano tokens: [waypoint candidates | 12 views] in static slots.
        Candidate feature = nearest camera's view feature + angle features."""
        sh, m = self.cfg.shapes, self.cfg.model
        B, V = len(obs), sh.max_pano_len
        A = m.angle_feat_size
        view_fts = np.zeros((B, V, m.image_feat_size), np.float32)
        loc_fts = np.zeros((B, V, A + 3), np.float32)
        nav_types = np.zeros((B, V), np.int32)
        view_lens = np.zeros(B, np.int32)
        n_cam = self.env.num_views
        for i, ob in enumerate(obs):
            k = 0
            for ang, dis in zip(cand_angles[i], cand_dists[i]):
                if k >= V:
                    break
                cam = int(round(ang / (2 * math.pi / n_cam))) % n_cam
                view_fts[i, k] = ob["view_fts"][cam][: m.image_feat_size]
                # clockwise candidate angle, elevation 0
                loc_fts[i, k, :A] = angle_features([ang], [0.0], A)[0]
                loc_fts[i, k, A:] = [1.0, 1.0, dis / 30.0]
                nav_types[i, k] = 1
                k += 1
            for cam in range(n_cam):
                if k >= V:
                    break
                view_fts[i, k] = ob["view_fts"][cam][: m.image_feat_size]
                ang = cam * (2 * math.pi / n_cam)
                loc_fts[i, k, :A] = angle_features([ang], [0.0], A)[0]
                loc_fts[i, k, A:] = 1.0
                k += 1
            view_lens[i] = k
        return {"view_fts": view_fts, "loc_fts": loc_fts, "nav_types": nav_types,
                "view_lens": view_lens}

    def _ce_lift(self, obs):
        """World point clouds on the device. The habitat frame is already
        y-up: the cameras sit at the agent's position as it comes, a
        counter-clockwise ring offset by the agent's heading."""
        B = len(obs)
        nv = self.env.num_views
        xyzhe = np.zeros((B, nv, 5), np.float32)
        for i, ob in enumerate(obs):
            xyzhe[i, :, :3] = ob["position"]
            xyzhe[i, :, 3] = -(np.arange(nv) * (2 * math.pi / nv) + ob["heading"])
            xyzhe[i, :, 4] = math.pi
        T = se3_from_xyzhe(xyzhe.reshape(-1, 5)).reshape(B, nv, 4, 4).astype(np.float32)
        depths = np.stack([ob["depth"] for ob in obs]).astype(np.float32) * 10.0
        pc, no_depth = self.projector.lift(self._upload(depths), self._upload(T))
        feats = self._upload(
            np.stack([ob["rgb"] for ob in obs]).reshape(B, -1, self.cfg.model.bev_grid_feat_size)
        )
        return pc, ~no_depth, feats

    def _ce_gmap_variable(self, obs, gmaps, embed_refs, pano_store):
        """[stop] + real nodes (visited, masked from action) + ghosts."""
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
            "cur_vps": [],
        }
        for i, (ob, gmap) in enumerate(zip(obs, gmaps)):
            nodes = list(gmap.node_pos)
            ghosts = list(gmap.ghost_aug_pos)
            out["no_vp_left"].append(len(ghosts) == 0)
            cur_vp = nodes[-1]
            out["cur_vps"].append(cur_vp)
            vpids = ([None] + nodes + ghosts)[:N]
            n = len(vpids)
            out["gmap_vpids"].append(vpids)
            out["gmap_masks"][i, :n] = True
            out["gmap_visited_masks"][i, 1 : 1 + len(nodes)] = True
            out["gmap_step_ids"][i, :n] = [
                min(gmap.node_step_ids.get(vp, 0) if vp else 0, m.max_action_steps - 1)
                for vp in vpids
            ]
            out["gmap_pos_fts"][i, :n] = gmap.get_pos_fts(
                cur_vp, ob["position"], ob["orientation"], vpids, A
            )

            def graph_dist(a, b):
                # a ghost's distance goes through its nearest front node
                da, fa = gmap.front_to_ghost_dist(a) if a.startswith("g") else (0.0, a)
                db, fb = gmap.front_to_ghost_dist(b) if b.startswith("g") else (0.0, b)
                return da + gmap.graph.distance(fa, fb) + db

            for a in range(1, n):
                for b in range(a + 1, n):
                    d = graph_dist(vpids[a], vpids[b]) / 30.0
                    out["gmap_pair_dists"][i, a, b] = d
                    out["gmap_pair_dists"][i, b, a] = d
            for node_i, vp in enumerate(vpids):
                if vp is None:
                    continue
                refs = embed_refs[i].get(vp, [])
                if not refs:
                    continue
                w = 1.0 / len(refs)
                for (t, slot) in refs:
                    if slot == -1:
                        vl = int(pano_store["view_lens"][t][i])
                        out["gmap_agg"][i, node_i, t * V : t * V + vl] += w / max(vl, 1)
                    else:
                        out["gmap_agg"][i, node_i, t * V + slot] += w
        return out

    def _ce_bev_variable(self, obs, gmaps, pc_store):
        """Splat the gathered point clouds on the device; candidate cells from
        the polar relative positions of the 1-hop nodes and the front ghosts
        (ref _discretize_polar_relpos, ss_trainer_BEV.py:465-475)."""
        sh, m = self.cfg.shapes, self.cfg.model
        B = len(obs)
        C, K = m.num_bev_tokens, sh.max_local_len
        S_max = sh.max_pc_steps
        A = m.angle_feat_size
        c = (m.bev_dim - 1) // 2
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
            cur_vp = list(gmap.node_pos)[-1]
            steps = gmap.gather_pc_steps(cur_vp, self.cfg.pc_order)[-S_max:]
            step_sel[i, : len(steps)] = steps
            step_ok[i, : len(steps)] = True
            S_w2c[i] = ob["position"]  # y-up already
            T_w2c[i] = se3_from_xyzhe(np.array([[0, 0, 0, ob["heading"], 0]], np.float32))[0]
            cands_vp, relpos = gmap.get_neighbors(cur_vp, ob["position"], ob["orientation"])
            cells = [c * m.bev_dim + c]
            for ang, dis in relpos[1:]:
                gx = int(round(dis * math.sin(ang) / m.bev_res)) + c
                gz = int(round(-dis * math.cos(ang) / m.bev_res)) + c
                gx = min(max(gx, 0), m.bev_dim - 1)
                gz = min(max(gz, 0), m.bev_dim - 1)
                cells.append(gz * m.bev_dim + gx)
            cells = np.asarray(cells[:K], np.int64)
            bev_cand_idxs[i, : len(cells)] = cells
            local_masks[i, : len(cells)] = True
            bev_nav_masks[i, cells] = True
            bev_cand_vpids.append(cands_vp[:K])
            gpos = gmap.get_pos_fts(cur_vp, ob["position"], ob["orientation"],
                                    [list(gmap.node_pos)[0]], A)[0]
            bev_pos_fts[i, :, : A + 3] = gpos
            bev_pos_fts[i, :, A + 3 :] = self.polar
        bev_fts = gather_and_splat(
            self.projector, pc_store.pc, pc_store.valid, pc_store.feats,
            self._upload(step_sel), self._upload(step_ok),
            self._upload(T_w2c), self._upload(S_w2c),
        )
        return {"bev_fts": bev_fts, "bev_pos_fts": bev_pos_fts, "bev_nav_masks": bev_nav_masks,
                "bev_cand_idxs": bev_cand_idxs, "local_masks": local_masks,
                "bev_cand_vpids": bev_cand_vpids}

    # --------------------------------------------------------------- teacher
    def _ce_teacher(self, obs, gmaps, gmap_vpids, ended):
        """Oracle: stop within the success radius, else the ghost minimising
        (geodesic to its front + front->ghost + ghost->goal) (ref
        _teacher_action_new, ss_trainer_BEV.py:317-345); a slot's ghost->goal
        distances ride one batched ``dists_to_goal`` query."""
        a = np.full(len(obs), IGNORE_ID, np.int64)
        for i, gmap in enumerate(gmaps):
            if ended[i]:
                continue
            if self.env.dist_to_goal(i) < SUCCESS_DISTANCE:
                a[i] = 0
                continue
            cur_vp = list(gmap.node_pos)[-1]
            ghosts = [(j, vp) for j, vp in enumerate(gmap_vpids[i])
                      if vp is not None and vp.startswith("g")]
            if not ghosts:
                continue
            goal_d = self.env.dists_to_goal(i, [gmap.ghost_aug_pos[vp] for _, vp in ghosts])
            best, best_j = math.inf, IGNORE_ID
            for (j, vp), dg in zip(ghosts, goal_d):
                front_dis, front_vp = gmap.front_to_ghost_dist(vp)
                cost = gmap.graph.distance(cur_vp, front_vp) + front_dis + dg
                if cost < best:
                    best, best_j = cost, j
            a[i] = best_j
        return a

    # --------------------------------------------------------------- rollout
    def rollout(self, feedback: str = "sample", train: bool = True,
                sample_ratio: Optional[float] = None):
        """One batch of episodes. ``feedback``: 'argmax' (greedy, with the
        stop redirect to the best stop score), 'teacher' (the oracle) or
        'sample' (scheduled sampling: the teacher w.p. ``sample_ratio``, else
        a draw from the policy). With ``train`` every step is recorded and
        one replay update follows. Returns (trajectories, loss or None)."""
        if feedback not in CE_FEEDBACKS:
            raise ValueError(f"unknown feedback {feedback!r}")
        sample_ratio = self.sample_ratio if sample_ratio is None else sample_ratio
        # a training rollout records the splat's BEV features for the
        # replay's graph: inference tensors cannot be saved for backward
        with torch.no_grad() if train else torch.inference_mode():
            traj, lang, records = self._ce_rollout(feedback, train, sample_ratio)
        loss = None
        if train and records:
            loss = self._learn(lang, records)
        return traj, loss

    def _ce_rollout(self, feedback: str, train: bool, sample_ratio: float):
        cfg = self.cfg
        env = self.env
        obs = env.reset()
        B = len(obs)
        T = cfg.max_action_len

        ghost_aug = self.ghost_aug if train else 0.0
        gmaps = [CEGraphMap(loc_noise=self.loc_noise, ghost_aug=ghost_aug, rng=self.np_rng)
                 for _ in range(B)]
        embed_refs: List[Dict[str, list]] = [dict() for _ in range(B)]
        prev_vp: List[Optional[str]] = [None] * B
        walked = [[obs[i]["position"].copy()] for i in range(B)]
        headings = [[float(obs[i]["heading"])] for i in range(B)]
        traj = [{"instr_id": ob["instr_id"], "positions": walked[i], "headings": headings[i]}
                for i, ob in enumerate(obs)]

        def log_move(i, positions):
            walked[i].extend(positions)
            headings[i].extend([float(env.headings[i])] * len(positions))

        use_bev = cfg.model.use_bev  # False = the topo-only ETP trainer
        lang = self._language_variable(obs)
        txt_embeds = self._forward("language", lang)
        ended = np.zeros(B, bool)
        pano_store = {"view_lens": {}, "embeds": {}}
        pc_store = self._make_pc_store(B) if use_bev else None
        records: List[StepRecord] = []
        # eval rollouts walk with low-level control, training ones teleport
        # (ref ss_trainer_BEV.py:1108-1179)
        use_control = (not train) and cfg.ce_back_algo == "control"
        ctrl = LowLevelController(env, self.np_rng) if use_control else None

        for t in range(T):
            # 1. waypoint prediction (frozen)
            cand_angles, cand_dists, _ = self._waypoints(obs, train)

            # 2. pano encoding, queued; 3. the step's point cloud into the
            # device store while it runs
            pano_in = self._ce_panorama_variable(obs, cand_angles, cand_dists)
            pano_embeds, _ = self._forward("panorama", pano_in)
            pano_store["view_lens"][t] = pano_in["view_lens"]
            if use_bev:
                pc, pc_valid, pc_feats = self._ce_lift(obs)
                pc_store.set_step(t, pc, pc_valid, pc_feats)
            pano_np = pano_embeds.float().cpu().numpy()
            pano_store["embeds"][t] = pano_np

            # 4. graph update with ghost bookkeeping
            for i, gmap in enumerate(gmaps):
                if ended[i]:
                    continue
                cur_vp, cand_vp, cand_pos = gmap.identify_node(
                    obs[i]["position"], obs[i]["orientation"], cand_angles[i], cand_dists[i])
                assignments = gmap.update_graph(
                    prev_vp[i], t + 1, cur_vp, obs[i]["position"], None, cand_vp, cand_pos,
                    [pano_np[i, j] for j in range(len(cand_vp))], augment=False,
                )
                # visited node = its pano's mean; ghosts accumulate their
                # candidate-slot sightings (ref graph_utils.py:231-239)
                embed_refs[i][cur_vp] = [(t, -1)]
                for j, assigned in enumerate(assignments):
                    if assigned.startswith("g"):
                        embed_refs[i].setdefault(assigned, []).append((t, j))
                gmap.set_node_pc(cur_vp, t)
                prev_vp[i] = cur_vp
            # the ghost noise, drawn after every map's update
            if ghost_aug:
                self._augment_ghosts(gmaps, ended)

            # 5. navigation forward
            nav_g = self._ce_gmap_variable(obs, gmaps, embed_refs, pano_store)
            nav_in = {
                "txt_embeds": txt_embeds,
                "txt_masks": lang["txt_masks"],
                "gmap_img_embeds": self._policy_node_embeds(nav_g["gmap_agg"], pano_store, B),
                **{k: nav_g[k] for k in ("gmap_step_ids", "gmap_pos_fts", "gmap_masks",
                                         "gmap_pair_dists", "gmap_visited_masks")},
            }
            nav_b = fuse_map = None
            if use_bev:
                nav_b = self._ce_bev_variable(obs, gmaps, pc_store)
                fuse_map = self._build_fuse_map(nav_g["gmap_vpids"], nav_g["gmap_visited_masks"],
                                                nav_b["bev_cand_vpids"])
                nav_in.update({
                    **{k: nav_b[k] for k in ("bev_fts", "bev_pos_fts", "bev_nav_masks",
                                             "bev_cand_idxs", "local_masks")},
                    "bev_masks": np.ones((B, cfg.model.num_bev_tokens), bool),
                    "fuse_map": fuse_map,
                })
            nav_outs = self._forward("navigation", nav_in)
            # the oracle teacher overlaps the device's navigation forward
            targets = self._ce_teacher(obs, gmaps, nav_g["gmap_vpids"], ended)
            # topo-only: the model's fused logits are its global logits
            nav_logits = nav_outs["fused_logits"].float().cpu().numpy()
            nav_probs = np.exp(nav_logits - nav_logits.max(-1, keepdims=True))
            nav_probs /= nav_probs.sum(-1, keepdims=True)
            for i, gmap in enumerate(gmaps):
                if not ended[i]:
                    gmap.node_stop_scores[nav_g["cur_vps"][i]] = float(nav_probs[i, 0])
            if train:
                rec = StepRecord(
                    active=~ended.copy(),
                    **{k: pano_in[k] for k in ("view_fts", "loc_fts", "nav_types", "view_lens")},
                    **{k: nav_g[k] for k in ("gmap_agg", "gmap_step_ids", "gmap_pos_fts",
                                             "gmap_masks", "gmap_visited_masks",
                                             "gmap_pair_dists")},
                    targets=np.where(ended, IGNORE_ID, targets),
                    step_idx=t,
                )
                if use_bev:
                    for k in ("bev_fts", "bev_nav_masks", "bev_cand_idxs", "local_masks",
                              "bev_pos_fts"):
                        setattr(rec, k, nav_b[k])
                    rec.fuse_map = fuse_map
                records.append(rec)

            # scheduled sampling (ss_trainer_BEV.py:1097-1100); eval: argmax
            if feedback == "argmax":
                a_t = nav_logits.argmax(-1)
            elif feedback == "teacher":
                a_t = targets
            else:
                probs = self._global_rows(nav_probs)
                a_t = np.array([self.np_rng.choice(len(p), p=p) for p in probs])
                use_teacher = self.np_rng.uniform(size=len(probs)) < sample_ratio
                a_t, use_teacher = self._own_rows(a_t), self._own_rows(use_teacher)
                a_t = np.where((targets != IGNORE_ID) & use_teacher, targets, a_t)

            act = functools.partial(self._act, gmaps, a_t, nav_g, ended, t, feedback, ctrl,
                                    log_move)
            if use_control:
                self._in_rank_turns(ctrl, act)
            else:
                act()
            if self._all_ranks(ended.all()):
                break
            # a subprocess pool (ce/env_pool.py) synthesises the sensors in
            # its workers: dispatch now, then gather
            if hasattr(env, "begin_observations"):
                env.begin_observations()
            obs = env.observations()
        return traj, lang, records

    def _act(self, gmaps, a_t, nav_g, ended, t, feedback, ctrl, log_move):
        """Carry out the step's actions of the rows that have not ended:
        stop (an argmax stop first goes back to the node of the best stop
        score) or move to the chosen ghost, by teleport or, with ``ctrl``,
        low-level control."""
        cfg, env = self.cfg, self.env
        T = cfg.max_action_len
        use_control = ctrl is not None
        for i, gmap in enumerate(gmaps):
            if ended[i]:
                continue
            choice = int(a_t[i])
            stop = (choice == 0 or nav_g["no_vp_left"][i] or t == T - 1
                    or choice == IGNORE_ID)
            cur_vp = nav_g["cur_vps"][i]

            def back_path_to(dest_vp):
                if dest_vp == cur_vp:
                    return None
                return [(p, gmap.node_pos[p]) for p in gmap.graph.path(cur_vp, dest_vp)]

            if stop:
                # argmax only: go back to the node of the best stop score
                best_vp, best_sc = None, -math.inf
                for vp, sc in gmap.node_stop_scores.items():
                    if sc > best_sc:
                        best_vp, best_sc = vp, sc
                if best_vp is not None and best_vp != cur_vp and feedback == "argmax":
                    if use_control:
                        log_move(i, ctrl.execute(i, {
                            "act": 0, "back_path": back_path_to(best_vp),
                            "stop_pos": gmap.node_pos[best_vp], "tryout": cfg.ce_tryout,
                        }))
                    else:
                        env.teleport(i, gmap.node_pos[best_vp])
                        log_move(i, [gmap.node_pos[best_vp].copy()])
                env.stop(i)
                ended[i] = True
                continue
            vp = nav_g["gmap_vpids"][i][choice]
            if vp is None or not vp.startswith("g"):
                # only ghosts are actionable
                ended[i] = True
                env.stop(i)
                continue
            front_dis, front_vp = gmap.front_to_ghost_dist(vp)
            target_pos = gmap.ghost_mean_pos[vp].copy()
            if use_control:
                # back to the front node along the map, then low-level
                # control to the ghost (ref environments.py:449-460)
                log_move(i, ctrl.execute(i, {
                    "act": 4, "back_path": back_path_to(front_vp),
                    "front_pos": gmap.node_pos[front_vp], "ghost_pos": target_pos,
                    "tryout": cfg.ce_tryout,
                }))
            else:
                # through the front node, then to the ghost
                if front_vp != cur_vp:
                    log_move(i, [gmap.node_pos[front_vp].copy()])
                heading = math.atan2(
                    -(target_pos[0] - gmap.node_pos[front_vp][0]),
                    -(target_pos[2] - gmap.node_pos[front_vp][2]),
                ) % (2 * math.pi)
                env.teleport(i, target_pos, heading)
                log_move(i, [target_pos.copy()])
            gmap.delete_ghost(vp)

    # ------------------------------------------------------ data parallelism
    def _augment_ghosts(self, gmaps, ended) -> None:
        """The ghost noise of a step, drawn as the one process draws it: row
        by row over the global rows, one ``normal(0, ghost_aug, 3)`` per
        ghost of each row's map that was updated; each rank applies its own
        rows' draws (an ended row's map was not updated and keeps its
        ghosts)."""
        counts = np.array([0 if ended[i] else len(g.ghost_mean_pos) for i, g in enumerate(gmaps)])
        b = len(gmaps)
        for row, n in enumerate(self._global_rows(counts)):
            draws = [self.np_rng.normal(0.0, self.ghost_aug, 3) for _ in range(n)]
            i = row - self.rank * b
            if 0 <= i < b and not ended[i]:
                gmaps[i].augment_ghosts(iter(draws))

    def _in_rank_turns(self, ctrl: LowLevelController, act) -> None:
        """``act()`` (this rank's low-level moves) with the tryout coins the
        one process would give these rows: the ranks take turns in rank
        order, each drawing from one copy of ``np_rng`` after the coins that
        the ranks before it drew; then every rank's ``np_rng`` stands where
        the copy does."""
        coins = copy.deepcopy(self.np_rng)
        for turn in range(self.world):
            n = 0
            if turn == self.rank:
                ctrl.rng = counted = _CountedCoins(coins)
                try:
                    act()
                finally:
                    ctrl.rng = self.np_rng
                n = counted.n
            n = distributed.all_gather_objects(n)[turn]
            if turn != self.rank:
                for _ in range(n):
                    coins.choice([True, False])
        self.np_rng.bit_generator.state = coins.bit_generator.state

    # ------------------------------------------------------------------ eval
    def evaluate(self, num_batches: int = 2) -> Dict[str, float]:
        """Mean episode metrics of ``num_batches`` greedy rollouts from the
        start of the env's split, over every rank's episodes in the one
        process's order (batch by batch, rank by rank)."""
        self.env.reset_epoch()
        batches = []
        for _ in range(num_batches):
            trajs, _ = self.rollout(feedback="argmax", train=False)
            batches.append([self.env.eval_episode(i, tr["positions"])
                            for i, tr in enumerate(trajs)])
        ranks = distributed.all_gather_objects(batches)
        metrics = [m for n in range(num_batches) for mine in ranks for m in mine[n]]
        return {k: float(np.mean([m[k] for m in metrics])) for k in metrics[0]}


class _CountedCoins:
    """The controller's tryout coins from ``rng``, counted."""

    def __init__(self, rng: np.random.Generator):
        self.rng, self.n = rng, 0

    def choice(self, options):
        self.n += 1
        return self.rng.choice(options)
