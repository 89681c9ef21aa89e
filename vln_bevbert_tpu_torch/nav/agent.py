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

With ``obj_feat_size > 0`` (REVERIE/SOON) every panorama carries object
slots after its views, P = V + O: they join the node means of the global map,
the last step's slots are the local branch's object tokens, ``og_head``
grounds the goal object (``pred_objid`` at the stop node), and the replay
adds the object cross-entropy against ``_teacher_object``.

The host helpers (``_language_variable`` ... ``_make_equiv_action``) repeat
the JAX agent's: the port imports nothing of the JAX package. The
teacher-recollection store is ``nav/recollection.py``.

Tracing (``utils/profiling.py``; nothing is recorded outside
``profiling.recording()``): host spans of a rollout, ``rollout.language``
once an episode batch, then each step ``rollout.panorama`` (the variable and
the forward's enqueue), ``rollout.lift`` (the lift and its store),
``rollout.gmap`` (the graph update from the step's observation, the
bookkeeping and ``_nav_gmap_variable``), ``rollout.bev``
(``_nav_bev_variable`` with its gather and splat, and the fusion map),
``rollout.readback`` twice (the sync on the panorama tokens, then the
logits), ``rollout.node_embeds`` (``_policy_node_embeds``),
``rollout.navigation``, ``rollout.teacher`` and ``rollout.act`` (the actions,
``_make_equiv_action`` and the stop-node backtrack); the env's own spans
(``env.reset``, ``env.get_obs``, ``env.teleport``) nest in them or stand
alone. ``_forward`` stamps the device phases ``nav.language``,
``nav.panorama`` and ``nav.navigation`` around its model call.
``GMapNavAgent.counters()`` counts episodes, decisions, steps, global-map
nodes, the node contraction's token slots and splatted points since the
agent was made.

``make_replay_block`` is the JAX package's ``lax.scan`` block of a
replay-training inner loop over one fixed bundle: where
``graphs.capturable`` says so (the card) one update is captured into a CUDA
graph (``utils/graphs.py``) and replayed; elsewhere the updates run eagerly.

Data parallelism (JAX's ``mesh=``; the reference fine-tunes under DDP,
agent_base.py:121-123): rank ``rank`` of ``world`` processes acts in an env
that holds its rows of the global batch (``R2RNavBatch(rank=, world=)``),
and every decision that the one process at the global batch takes over all
rows is taken over all rows here too, so that the ranks together compute
what it computes: the text bucket's length, the end of a rollout, the
sampled and exploring actions (drawn from ``np_rng`` over the gathered
global rows, each rank keeping its own), the evaluation's end, and which
replay steps are all padding. The replay runs on the rank's rows: its loss
scales by ``ml_weight`` over the global batch, dropout draws the global
rows' seeds (``ops/dropout.py``), and the gradients are summed over the
ranks before the clip and AdamW (``TrainState.all_reduce_grads``).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional

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
from ..ops.dropout import set_dropout_generator, step_rows
from ..parallel import distributed
from ..parallel.mesh import replicate_module
from ..parallel.optim import finetune_optim
from ..parallel.train_step import (
    TrainState,
    dropout_generators,
    load_checkpoint,
    save_checkpoint,
)
from ..utils import graphs, profiling
from ..utils.device import resolve_device, to_device
from ..utils.rng import make_generator, train_generator
from .env import R2RNavBatch
from .eval_utils import compute_dtw_metrics
from .graph_map import GraphMap

IGNORE_ID = -100
FEEDBACKS = ("argmax", "teacher", "sample", "expl_sample")
#: the device phase of each model mode (``_forward``)
PHASES = {mode: f"nav.{mode}" for mode in ("language", "panorama", "navigation")}
# the supervised and acted-on head per fusion mode
LOGITS_KEY = {"local": "local_logits", "global": "global_logits", "avg": "fused_logits"}


def _on_host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclass
class StepRecord:
    """What the replay needs of one training-rollout step: host arrays, and
    the step's BEV features as the device tensor the splat produced (no
    gradient flows into them). P = V + O panorama slots."""

    active: np.ndarray                 # (B,) bool
    view_fts: np.ndarray               # (B, V, Dimg)
    loc_fts: np.ndarray                # (B, P, A+3)
    nav_types: np.ndarray              # (B, P)
    view_lens: np.ndarray              # (B,)
    gmap_agg: np.ndarray               # (B, N, T*P)
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
    obj_fts: Optional[np.ndarray] = None         # (B, O, Dobj)
    obj_lens: Optional[np.ndarray] = None        # (B,)
    obj_targets: Optional[np.ndarray] = None     # (B,), IGNORE_ID off the goal


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


class CountingProjector(BevProjector):
    """The agent's projector: each ``splat`` also adds the points it splats
    (valid and inside the grid) to ``points``, a device counter that is read
    only when asked for (``GMapNavAgent.counters``)."""

    def __init__(self, *args, device=None, **kwargs):
        super().__init__(*args, device=device, **kwargs)
        self.points = torch.zeros((), dtype=torch.int64, device=device)

    def splat(self, cell, valid, *args, **kwargs):
        self.points += valid.sum()
        return super().splat(cell, valid, *args, **kwargs)


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
        """In a process group (``parallel.distributed.initialize``) the agent
        is its process's data-parallel rank and ``env`` holds that rank's
        rows."""
        self.cfg = cfg
        self.env = env
        self.seed = seed
        self.device = resolve_device(device)
        self.rank, self.world = distributed.rank(), distributed.world_size()
        self.model = GlocalTextPathNavCMT(cfg.model, device=self.device).eval()
        self.projector = CountingProjector(
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
        set_dropout_generator(self.model, train_generator(seed, self.device), self.rank,
                              self.world)
        self._state: Optional[TrainState] = None
        self.transferred: Optional[int] = None
        self.logs: Dict[str, List[float]] = {"IL_loss": [], "grad_norm": [], "entropy": []}
        self._counts = dict.fromkeys(("episodes", "nav_decisions", "rollout_steps",
                                      "gmap_nodes", "node_tokens"), 0)

    def counters(self) -> Dict[str, int]:
        """Since the agent was made (this rank's rows): ``episodes`` ended by
        its rollouts, ``nav_decisions`` (a row's step taken before its
        episode ended), ``rollout_steps`` (steps of the batch),
        ``gmap_nodes`` (the global map's valid entries, the stop slot
        included, over every row of every step), ``node_tokens`` (token
        slots the node contraction read, ``s * V`` at a step with ``s``
        steps stored, counted once for the batch) and ``splat_points``
        (points splatted into the BEV). Reading ``splat_points`` waits for
        the device."""
        return {**self._counts, "splat_points": int(self.projector.points)}

    # ------------------------------------------------------------------ init
    def init_params(self, generator: Optional[torch.Generator] = None,
                    pretrained: Optional[Mapping[str, torch.Tensor]] = None) -> Optional[int]:
        """Random parameters from a seeded generator on the agent's device;
        with ``pretrained`` (a state dict, e.g. a pretraining model's), every
        entry of it whose name and shape the navigation model shares replaces
        the fresh value. Returns how many entries were transferred, or None
        (also kept as ``self.transferred``). Under data parallelism rank 0's
        values are broadcast."""
        init_params(self.model, generator or make_generator(self.seed, self.device))
        self.transferred = None
        if pretrained is not None:
            fresh = self.model.state_dict()
            self.model.load_state_dict(transfer_pretrained(pretrained, fresh))
            self.transferred = count_transferred(pretrained, fresh)
        replicate_module(self.model)
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
        """One model call ('language' / 'panorama' / 'navigation'), stamped
        as the device phase ``nav.<mode>`` after its uploads."""
        inputs = {k: self._upload(v) for k, v in batch.items()}
        profiling.device_phase(PHASES[mode], self.device)
        out = self.model(mode, inputs)
        profiling.device_phase(None, self.device)
        return out

    # ------------------------------------------------------ data parallelism
    def _global_rows(self, x: np.ndarray) -> np.ndarray:
        """Every rank's rows of ``x``, in rank order (one process: ``x``)."""
        if self.world == 1:
            return x
        return np.concatenate(distributed.all_gather_objects(np.asarray(x)))

    def _own_rows(self, x: np.ndarray) -> np.ndarray:
        """This rank's rows of a global ``x``."""
        if self.world == 1:
            return x
        b = len(x) // self.world
        return x[self.rank * b:(self.rank + 1) * b]

    def _all_ranks(self, flags: np.ndarray) -> np.ndarray:
        """``flags`` (per step or one) true on every rank."""
        if self.world == 1:
            return flags
        flags = np.asarray(flags)
        return distributed.all_reduce_host((~flags).astype(np.int64)) == 0

    # ------------------------------------------------------------- variables
    def _language_variable(self, obs):
        # bucket text length to multiples of 32, as the JAX agent does, over
        # the global batch's rows
        raw = max(len(ob["instr_encoding"]) for ob in obs)
        if self.world > 1:
            raw = int(distributed.all_reduce_host(np.array([raw], np.int64), "max")[0])
        L = min(((raw + 31) // 32) * 32, self.cfg.max_instr_len)
        B = len(obs)
        ids = np.zeros((B, L), np.int32)
        masks = np.zeros((B, L), bool)
        for i, ob in enumerate(obs):
            enc = np.asarray(ob["instr_encoding"])[:L]
            ids[i, : len(enc)] = enc
            masks[i, : len(enc)] = True
        return {"txt_ids": ids, "txt_masks": masks}

    @property
    def with_objects(self) -> bool:
        return self.cfg.model.obj_feat_size > 0

    @property
    def num_pano_slots(self) -> int:
        sh = self.cfg.shapes
        return sh.max_pano_len + (sh.max_objects if self.with_objects else 0)

    def _panorama_variable(self, obs):
        """Static slots: candidate views first, then the remaining views,
        then (with objects) up to O objects. Returns (inputs, candidate
        viewpoint ids, object ids) per sample."""
        sh, m = self.cfg.shapes, self.cfg.model
        B, V = len(obs), sh.max_pano_len
        O = sh.max_objects if self.with_objects else 0
        A = m.angle_feat_size
        view_fts = np.zeros((B, V, m.image_feat_size), np.float32)
        loc_fts = np.zeros((B, V + O, A + 3), np.float32)
        nav_types = np.zeros((B, V + O), np.int32)
        view_lens = np.zeros(B, np.int32)
        obj_fts = np.zeros((B, O, m.obj_feat_size), np.float32) if O else None
        obj_lens = np.zeros(B, np.int32) if O else None
        cand_vpids: List[List[str]] = []
        obj_ids: List[List[str]] = []
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
            if O:
                n_obj = min(len(ob.get("obj_ids", [])), O)
                if n_obj:
                    obj_fts[i, :n_obj] = ob["obj_img_fts"][:n_obj, : m.obj_feat_size]
                    loc_fts[i, V : V + n_obj, :A] = ob["obj_ang_fts"][:n_obj]
                    loc_fts[i, V : V + n_obj, A:] = ob["obj_box_fts"][:n_obj]
                    nav_types[i, V : V + n_obj] = 2
                obj_lens[i] = n_obj
                obj_ids.append(list(ob.get("obj_ids", []))[:O])
            else:
                obj_ids.append([])
        out = {"view_fts": view_fts, "loc_fts": loc_fts, "nav_types": nav_types,
               "view_lens": view_lens}
        if O:
            out.update(obj_fts=obj_fts, obj_lens=obj_lens)
        return out, cand_vpids, obj_ids

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
        V = self.num_pano_slots
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
                        # visited: mean over the valid slots of that step's
                        # pano, views and objects
                        vl = int(pano_store["view_lens"][t][i])
                        ol = int(pano_store["obj_lens"][t][i]) if self.with_objects else 0
                        total = max(vl + ol, 1)
                        out["gmap_agg"][i, node, t * V : t * V + vl] += w / total
                        if ol:
                            base = t * V + sh.max_pano_len
                            out["gmap_agg"][i, node, base : base + ol] += w / total
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

    def _teacher_object(self, obs, ended, obj_ids):
        """The goal object's slot at a goal viewpoint, else IGNORE_ID."""
        targets = np.full(len(obs), IGNORE_ID, np.int64)
        for i, ob in enumerate(obs):
            if ended[i] or ob["viewpoint"] not in ob.get("gt_end_vps", []):
                continue
            for j, oid in enumerate(obj_ids[i]):
                if str(oid) == str(ob.get("gt_obj_id")):
                    targets[i] = j
                    break
        return targets

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
        span = profiling.span
        obs = self.env.reset()
        B = len(obs)
        T = cfg.max_action_len

        gmaps = [GraphMap(ob["viewpoint"]) for ob in obs]
        # rows whose map takes in their latest observation at the next step
        fresh = np.ones(B, bool)
        traj = [
            {"instr_id": ob["instr_id"], "path": [[ob["viewpoint"]]], "pred_objid": None}
            for ob in obs
        ]
        with span("rollout.language"):
            lang = self._language_variable(obs)
            txt_embeds = self._forward("language", lang)

        ended = np.zeros(B, bool)
        just_ended = np.zeros(B, bool)
        pano_store = {"view_lens": {}, "obj_lens": {}, "embeds": {}}
        pc_store = self._make_pc_store(B)
        records: List[StepRecord] = []
        counts = self._counts

        for t in range(T):
            counts["rollout_steps"] += 1
            counts["nav_decisions"] += int((~ended).sum())
            # enqueue the pano forward, then do every piece of host work that
            # does not need its result before reading it back
            with span("rollout.panorama"):
                pano_in, cand_vpids, obj_ids = self._panorama_variable(obs)
                pano_embeds, _ = self._forward("panorama", pano_in)
                pano_store["view_lens"][t] = pano_in["view_lens"]
                if self.with_objects:
                    pano_store["obj_lens"][t] = pano_in["obj_lens"]

            with span("rollout.lift"):
                pc, pc_valid, pc_feats = self.lift(obs)
                pc_store.set_step(t, pc, pc_valid, pc_feats)

            with span("rollout.gmap"):
                for i, ob in enumerate(obs):
                    if fresh[i]:
                        gmaps[i].update_graph(ob)
                for i, gmap in enumerate(gmaps):
                    if not ended[i]:
                        gmap.node_step_ids[obs[i]["viewpoint"]] = t + 1
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
            counts["gmap_nodes"] += int(nav_g["gmap_masks"].sum())

            with span("rollout.bev"):
                nav_b = self._nav_bev_variable(obs, gmaps, pc_store)
                fuse_map = self._build_fuse_map(
                    nav_g["gmap_vpids"], nav_g["gmap_visited_masks"],
                    nav_b["bev_cand_vpids"],
                )
            # first point that needs the pano result on the host: sync here
            with span("rollout.readback"):
                pano_store["embeds"][t] = pano_embeds.float().cpu().numpy()
            with span("rollout.node_embeds"):
                gmap_img = self._policy_node_embeds(nav_g["gmap_agg"], pano_store, B)
            with span("rollout.navigation"):
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
                if self.with_objects:
                    V, O = self.cfg.shapes.max_pano_len, self.cfg.shapes.max_objects
                    nav_in["obj_embeds"] = pano_embeds[:, V : V + O]
                    nav_in["obj_masks"] = np.arange(O)[None, :] < pano_in["obj_lens"][:, None]
                nav_outs = self._forward("navigation", nav_in)
            nav_vpids = (
                nav_b["bev_cand_vpids"] if cfg.fusion == "local" else nav_g["gmap_vpids"]
            )

            # the host teacher overlaps the device navigation forward
            with span("rollout.teacher"):
                targets = self._teacher_action(
                    obs, nav_vpids, ended,
                    visited_masks=(
                        None if cfg.fusion == "local" else nav_g["gmap_visited_masks"]
                    ),
                    imitation_learning=(feedback == "teacher"), t=t, traj=traj,
                )
                obj_targets = (self._teacher_object(obs, ended, obj_ids)
                               if self.with_objects else None)

            # float32 logits, then the JAX agent's numpy ops: equal logits
            # give equal probabilities and equal sampled actions
            with span("rollout.readback"):
                nav_logits = nav_outs[LOGITS_KEY.get(cfg.fusion, "fused_logits")
                                      ].float().cpu().numpy()
                obj_logits = (nav_outs["obj_logits"].float().cpu().numpy()
                              if self.with_objects else None)
            with span("rollout.act"):
                nav_probs = np.exp(nav_logits - nav_logits.max(-1, keepdims=True))
                nav_probs /= nav_probs.sum(-1, keepdims=True)
                for i, gmap in enumerate(gmaps):
                    if not ended[i]:
                        vp = obs[i]["viewpoint"]
                        gmap.node_stop_scores[vp] = float(nav_probs[i, 0])
                        if self.with_objects and obj_ids[i]:
                            # the grounded object at this node, for a stop here
                            best = int(obj_logits[i, : len(obj_ids[i])].argmax())
                            gmap.node_og[vp] = obj_ids[i][best]

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
                        obj_fts=pano_in.get("obj_fts"), obj_lens=pano_in.get("obj_lens"),
                        obj_targets=obj_targets,
                    ))

                a_t = self._pick_actions(feedback, targets, nav_logits, nav_probs, nav_g,
                                         nav_b)
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
                        if self.with_objects and stop_node is not None:
                            traj[i]["pred_objid"] = gmaps[i].node_og.get(stop_node)

            obs = self.env.get_obs()
            # the rows not ended before this step take in the observation
            # (at the next step's ``rollout.gmap``)
            fresh = ~ended
            ended |= np.array([a is None for a in actions])
            if self._all_ranks(ended.all()):
                break
        counts["episodes"] += B
        return traj, lang, records

    def _pick_actions(self, feedback, targets, nav_logits, nav_probs, nav_g, nav_b):
        """The step's action index per sample; draws from ``np_rng`` in the
        JAX agent's order, over the global batch's rows."""
        if feedback == "teacher":
            return targets
        a_t = nav_logits.argmax(-1)
        if feedback == "sample":
            nav_probs = self._global_rows(nav_probs)
            a_t = self._own_rows(np.array([self.np_rng.choice(len(p), p=p) for p in nav_probs]))
            with np.errstate(divide="ignore", invalid="ignore"):
                ent = -np.nansum(np.where(nav_probs > 0, nav_probs * np.log(nav_probs), 0.0), -1)
            self.logs["entropy"].append(float(ent.sum()))
        elif feedback == "expl_sample":
            if self.cfg.fusion == "local":
                actionable = np.asarray(nav_b["bev_nav_masks"], bool)
            else:
                actionable = nav_g["gmap_masks"] & ~nav_g["gmap_visited_masks"]
            a_t, actionable = self._global_rows(a_t), self._global_rows(actionable)
            explore = self.np_rng.random(len(a_t)) > self.cfg.expl_max_ratio
            for i in range(len(a_t)):
                if explore[i] and actionable[i].any():
                    a_t[i] = self.np_rng.choice(np.arange(actionable.shape[1])[actionable[i]])
            a_t = self._own_rows(a_t)
        return a_t

    def _policy_node_embeds(self, gmap_agg, pano_store, B):
        """Host float32 contraction of the stored pano tokens: each node's
        row of ``gmap_agg`` (B, N, T * V) against the tokens of the ``s``
        steps stored so far. Its columns from ``s * V`` on are zero, so one
        batched BLAS product over the first ``s * V`` gives the whole sum.
        Both operands are C-contiguous float32 (on a strided slice a BLAS
        caller falls back to its own loop), and the product runs on
        PyTorch's CPU threads: numpy's BLAS would keep a second pool of
        threads spinning after each product, taking the cores from the
        thread that launches the model's kernels."""
        V = self.num_pano_slots
        D = self.cfg.model.hidden_size
        embeds = pano_store["embeds"]
        s = len(embeds)
        tokens = np.empty((B, s * V, D), np.float32)
        for t in range(s):
            tokens[:, t * V : (t + 1) * V] = embeds[t]
        self._counts["node_tokens"] += s * V
        agg = np.ascontiguousarray(gmap_agg[:, :, : s * V], dtype=np.float32)
        return torch.matmul(torch.from_numpy(agg), torch.from_numpy(tokens)).numpy()

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
        zeros and IGNORE_ID targets (the JAX agent's bundle, object slots
        included), and replay them. The BEV features stay on the device."""
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
        if self.with_objects:
            keys += ["obj_fts", "obj_lens"]
        rb: Dict[str, Any] = {k: stack(k) for k in keys}
        if self.cfg.model.use_bev:
            bev = [r.bev_fts for r in records]
            rb["bev_fts"] = torch.stack(bev + [torch.zeros_like(bev[0])] * pad)
        for key in ("targets", "obj_targets") if self.with_objects else ("targets",):
            tgt = [getattr(r, key) for r in records]
            rb[key] = np.stack(tgt + [np.full_like(tgt[0], IGNORE_ID)] * pad)
        rb["txt_ids"] = lang["txt_ids"]
        rb["txt_masks"] = lang["txt_masks"]
        rb["step_idx"] = np.arange(T, dtype=np.int32)
        return self.learn_from_bundle(rb)

    def _replay_skip(self, rb: Mapping[str, Any]) -> np.ndarray:
        """(T,) bool: the bundle's steps whose targets are IGNORE_ID in every
        row of every rank (the padding after an episode's last step). Such a
        step adds exactly zero to the loss and the gradient: the JAX scan
        runs it, the port skips it. Over every rank's rows, so that a rank
        runs a step another rank needs and its dropout generator advances as
        the one process's does."""
        ignored = _on_host(rb["targets"]) == IGNORE_ID
        if "obj_fts" in rb:
            ignored &= _on_host(rb["obj_targets"]) == IGNORE_ID
        return self._all_ranks(ignored.all(axis=1))

    def _episode_loss(self, rb: Mapping[str, Any],
                      skip: Optional[np.ndarray] = None) -> torch.Tensor:
        """The episode's imitation loss, differentiable in the parameters, in
        the model's current mode (the replay runs it in training mode).

        ``rb`` holds step-leading (T, B, ...) arrays (``txt_*`` are (B, L)).
        The panorama encoder runs over all T*B step-rows at once; then each
        step's node embeddings are the float32 contraction of the recorded
        aggregation matrix with those tokens on the device, so the gradient
        of a later step reaches the earlier steps' panoramas. Per step a
        sum-reduction cross-entropy with IGNORE_ID on the fusion-selected
        head, plus, with objects, on ``obj_logits`` against ``obj_targets``
        (the step's object slots of the masked pano tokens are the local
        branch's object tokens); the total is scaled by ``ml_weight / B``.
        Under data parallelism ``rb`` holds this rank's rows, B is the global
        batch, and the panorama's T*B rows are step-major for dropout.
        ``skip`` (``_replay_skip``'s, computed from ``rb`` when None) names
        the steps left out; with it the loss reads nothing on the host."""
        cfg = self.cfg
        use_bev = cfg.model.use_bev
        dev = {k: self._upload(v) for k, v in rb.items()}
        T, B = dev["view_fts"].shape[:2]
        txt_masks = dev["txt_masks"]
        txt_embeds = self.model("language", {"txt_ids": dev["txt_ids"], "txt_masks": txt_masks})
        with_objects = "obj_fts" in rb
        pano_keys = ("view_fts", "loc_fts", "nav_types", "view_lens")
        if with_objects:
            pano_keys += ("obj_fts", "obj_lens")
        with step_rows(T):
            pano_embeds, pano_masks = self.model("panorama", {
                k: dev[k].reshape(T * B, *dev[k].shape[2:]) for k in pano_keys
            })
        P, D = pano_embeds.shape[1:]
        V = dev["view_fts"].shape[2]
        steps = (pano_embeds * pano_masks[..., None]).reshape(T, B, P, D)
        tokens = steps.transpose(0, 1).reshape(B, T * P, D).float()
        logits_key = LOGITS_KEY[cfg.fusion] if use_bev else "global_logits"
        if skip is None:
            skip = self._replay_skip(rb)
        total = torch.zeros((), device=self.device)
        for t in range(T):
            if skip[t]:
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
            if with_objects:
                nav_in["obj_embeds"] = steps[t, :, V:]
                slot = torch.arange(P - V, device=self.device)[None, :]
                nav_in["obj_masks"] = slot < dev["obj_lens"][t][:, None]
            outs = self.model("navigation", nav_in)
            total = total + cross_entropy(outs[logits_key], dev["targets"][t])[0].sum()
            if with_objects:
                total = total + cross_entropy(outs["obj_logits"], dev["obj_targets"][t])[0].sum()
        return total * cfg.ml_weight / (B * self.world)

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
        the episode loss with dropout on, its backward, the gradients summed
        over the data-parallel ranks, the float32 global-norm clip and AdamW.
        Reads back once, as the JAX agent reads its loss: the (global) loss
        and the gradient norm, appended to ``logs``."""
        loss, gnorm = self._replay_update(rb)
        loss_val, gnorm_val = torch.stack([loss, gnorm]).tolist()
        self.logs["IL_loss"].append(loss_val)
        self.logs["grad_norm"].append(gnorm_val)
        return loss_val

    def _replay_update(self, rb: Mapping[str, Any], skip: Optional[np.ndarray] = None,
                       moves: Optional[bool] = None):
        """(global loss, gradient norm) of one replay update, device
        tensors; ``moves`` as ``TrainState.apply_gradients`` takes it (given,
        a graph can capture the update and the caller advances the host
        counts)."""
        state = self.train_state
        with self._training():
            loss = self._episode_loss(rb, skip)
        loss.backward()
        state.all_reduce_grads()
        gnorm = state.apply_gradients(moves)
        return distributed.all_reduce_(loss.detach()), gnorm

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
        """Greedy evaluation over the dataset until it wraps (on any rank:
        every rank stops after the same batch). Returns this rank's
        trajectories; ``distributed.merge_results`` joins the ranks'."""
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
            if not self._all_ranks(np.array(not looped)) or (max_batches and n >= max_batches):
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
                      device="cuda") -> GMapNavAgent:
    """An env-less agent with random parameters, for replay updates from
    prepared bundles (in a process group, the rank's rows:
    ``parallel.mesh.shard_replay_bundle`` cuts them). The card unless the
    caller asks for the CPU: without CUDA, a CUDA ``device`` raises."""
    agent = GMapNavAgent(cfg, _EnvStub(batch_size), seed=seed, device=device)
    agent.init_params()
    return agent


def make_replay_block(agent: GMapNavAgent, length: int) -> Callable[[Mapping[str, Any]],
                                                                     torch.Tensor]:
    """``length`` replay updates of ``learn_from_bundle`` over one fixed
    bundle (JAX ``make_replay_block``): returns ``block(rb)`` -> the
    (global) losses, a (length,) device tensor; nothing reads back.

    The bundle is uploaded once. On the card the update (the episode loss
    with its dropout kernels, forward and backward, the gradient
    all-reduce, the clip and AdamW) is captured into a CUDA graph per
    (bundle signature, skipped steps, whether it moves the parameters) and
    replayed ``length`` times; the splat does not run (the bundle carries
    ``bev_fts``). Where ``graphs.capturable`` says no at the call (the CPU,
    a gloo group) the updates run eagerly, as ``block.eager`` runs them on
    any device."""
    device = agent.device
    cache = graphs.GraphCache()

    def eager(rb: Mapping[str, Any]) -> torch.Tensor:
        skip = agent._replay_skip(rb)
        dev = {k: agent._upload(v) for k, v in rb.items()}
        return torch.stack([agent._replay_update(dev, skip)[0] for _ in range(length)])

    def block(rb: Mapping[str, Any]) -> torch.Tensor:
        if not graphs.capturable(device):
            return eager(rb)
        state = agent.train_state
        skip = agent._replay_skip(rb)
        losses, loaded = [], set()  # the bundle is copied in once
        for _ in range(length):
            moves = state.tx.moves_next
            loss, _ = cache.step((graphs.signature(rb), tuple(skip.tolist()), moves), rb, device,
                                 lambda inputs: agent._replay_update(inputs, skip, moves),
                                 state.device_state(), dropout_generators(agent.model), loaded)
            losses.append(loss.clone())
            state.tx.advance(moves)
        return torch.stack(losses)

    block.graphs, block.eager = cache, eager
    return block
