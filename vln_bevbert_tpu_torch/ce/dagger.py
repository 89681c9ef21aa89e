"""DAgger / teacher-recollection trainer for the legacy PREVALENT policy
(port of ``vln_bevbert_tpu/ce/dagger.py``).

Role of the reference's registered "dagger" trainer
(bevbert_ce/vlnce_baselines/dagger_trainer.py:186-188): collect beta-mixed
teacher/policy trajectories in the continuous env once per dagger iteration,
persist the per-step training inputs to a disk store (the reference uses an
LMDB, dagger_trainer.py:101-111), then run supervised epochs streaming
episodes back from disk; the simulator is not touched during the epochs.

The trained policy is Recurrent VLN-BERT (PREVALENT, ``models/legacy.py``).
Candidate tokens are embedded by a VisionEncoder-style projection
(vlnbert_PREVALENT.py:345-359: ``visn_fc`` -> LayerNorm -> dropout) over
[rgb view feature | spatially pooled depth feature | angle features].

Candidate slots are static (K = max_candidates + 1, the stop action in the
slot after the last live candidate, masked beyond); episodes are padded to
``max_action_len`` with action IGNORE_ID and stored as float16 candidate
arrays. One BPTT update (``_update``) is the language pass with dropout on,
a Python loop over the recurrent visual steps (the JAX ``lax.scan``; a
trailing step whose actions are all IGNORE_ID adds exactly zero and is
skipped), the summed cross-entropy over valid actions divided by their
count, one backward, ``clip_by_global_norm(40)`` and AdamW with optax's
default betas, decay on every parameter and a bfloat16 first moment. The
frozen waypoint predictor is ``self.wp_model``, outside the trained model,
run under ``inference_mode``. Every host draw comes from one ``np_rng``, in
the JAX agent's order: ``extract_waypoints``, the teacher mix of each step,
then ``iter_batches``' permutation.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import FinetuneConfig, ModelConfig
from ..geometry import angle_features
from ..models.bert import Dense, LayerNorm, init_params
from ..models.legacy import RecurrentVLNBert, prevalent_to_state_dict
from ..ops.dropout import Dropout, set_dropout_generator
from ..parallel import distributed
from ..parallel.optim import finetune_optim
from ..parallel.train_step import TrainState, load_checkpoint, save_checkpoint
from ..utils.device import to_device
from ..utils.npz_store import NpzShardStore
from ..utils.rng import make_generator, train_generator
from .geometry_ce import estimate_cand_pos, heading_from_quaternion
from .waypoint_predictor import WaypointPredictor, extract_waypoints

IGNORE_ID = -100
STOP_RADIUS = 1.5  # ref dagger_trainer.py:224 "within target range"


class PrevalentPolicy(nn.Module):
    """Candidate embedder + RecurrentVLNBert core. ``visn_fc`` takes the
    concat [rgb ``image_feat_size`` | pooled depth ``depth_dim`` | angle
    ``angle_feat_size``]."""

    def __init__(self, cfg: ModelConfig, depth_dim: int, device=None):
        super().__init__()
        self.vln_bert = RecurrentVLNBert(cfg, device=device)
        in_dim = cfg.image_feat_size + depth_dim + cfg.angle_feat_size
        self.visn_fc = Dense(cfg, in_dim, cfg.hidden_size, device)
        self.visn_ln = LayerNorm(cfg, device=device)
        self.visn_dropout = Dropout(cfg.hidden_dropout_prob, site="prevalent_cand")

    def embed_candidates(self, cand_rgb, cand_depth, cand_dir) -> torch.Tensor:
        x = torch.cat([cand_rgb, cand_depth, cand_dir], dim=-1).float()
        return self.visn_dropout(self.visn_ln(self.visn_fc(x)))

    def forward(self, mode: str, batch: Mapping[str, torch.Tensor]):
        if mode == "language":
            return self.vln_bert("language", batch)
        if mode == "visual":
            img = self.embed_candidates(batch["cand_rgb"], batch["cand_depth"],
                                        batch["cand_dir"])
            return self.vln_bert("visual", {
                "lang_embeds": batch["lang_embeds"], "txt_masks": batch["txt_masks"],
                "img_feats": img, "vis_masks": batch["cand_masks"]})
        raise ValueError(f"unknown mode: {mode}")


class DaggerEpisodeStore(NpzShardStore):
    """Disk-backed episode store (role of the reference's LMDB recollection
    store, dagger_trainer.py:101-111 + recollection_dataset.py): the shared
    NpzShardStore FIFO persistence plus epoch batching."""

    def iter_batches(self, batch_size: int, rng: Optional[np.random.Generator] = None):
        """Stream shuffled fixed-size batches from disk: every batch is full.
        When the store holds at least batch_size episodes, the trailing
        remainder is completed from the tail of the epoch order (episodes
        repeat across batches, never within one batch); only a store smaller
        than batch_size wraps cyclically."""
        rng = rng or np.random.default_rng(0)
        order = rng.permutation(len(self))
        n = len(order)
        if n == 0:
            return
        if n < batch_size:
            order = np.resize(order, batch_size)  # tiles cyclically
            n = batch_size
        for i in range(0, n - batch_size + 1, batch_size):
            yield _stack_episodes([self.get(j) for j in order[i : i + batch_size]])
        if n % batch_size:  # remainder: last full window of the order
            yield _stack_episodes([self.get(j) for j in order[-batch_size:]])


def _stack_episodes(eps: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    batch = {k: np.stack([e[k] for e in eps])
             for k in ("cand_rgb", "cand_depth", "cand_dir", "cand_masks", "action")}
    batch["txt_ids"], batch["txt_masks"] = _bucket_language(
        [e["instruction_enc"] for e in eps])
    return batch


def _bucket_language(encodings) -> Tuple[np.ndarray, np.ndarray]:
    """Token ids and masks, (B, L) with L the longest encoding rounded up to
    a multiple of 32 (bucketed like the agents' language variable)."""
    L = ((max(len(enc) for enc in encodings) + 31) // 32) * 32
    ids = np.zeros((len(encodings), L), np.int32)
    masks = np.zeros((len(encodings), L), bool)
    for i, enc in enumerate(encodings):
        ids[i, : len(enc)] = enc
        masks[i, : len(enc)] = True
    return ids, masks


#: why PREVALENT DAgger refuses a process group of more than one rank
PREVALENT_WORLD_ONE = (
    "PREVALENT DAgger runs in one process: JAX builds it without a mesh and trains the "
    "global batch on one device, its episode store mixing every row into each BPTT batch. "
    "Run it at world size 1 with --batch_size W*b, which computes what W ranks of b rows "
    "would.")


class PrevalentDaggerAgent:
    """Collects episodes and trains the PREVALENT policy in the CE env, in
    one process (a process group of more than one rank is refused)."""

    def __init__(self, cfg: FinetuneConfig, env, seed: int = 0, max_candidates: int = 5,
                 grad_norm: float = 40.0, device="cuda"):
        if distributed.world_size() > 1:
            raise RuntimeError(PREVALENT_WORLD_ONE)
        # grad_norm 40: ref dagger_trainer.py:458 clips the VLNBERT branch at
        # 40 (the glocal trainers clip at 5)
        self.cfg = cfg
        self.env = env
        self.seed = seed
        self.device = torch.device(device)
        self.max_candidates = max_candidates
        self.K = max_candidates + 1  # + stop slot
        self.depth_dim = env.depth_feat_shape[0]  # channels after spatial pool
        self.np_rng = np.random.default_rng(seed)
        self.model = PrevalentPolicy(cfg.model, self.depth_dim, device=self.device).eval()
        self.wp_model = WaypointPredictor(
            cfg.model, depth_feat_size=int(np.prod(env.depth_feat_shape)), device=self.device,
        ).eval().requires_grad_(False)
        # dropout in the BPTT update draws its per-row seeds from here
        set_dropout_generator(self.model, train_generator(seed, self.device))
        self.optim = dataclasses.replace(finetune_optim(cfg), grad_norm=grad_norm)
        self._state: Optional[TrainState] = None
        self.logs: Dict[str, List[float]] = {"loss": [], "grad_norm": []}

    # ------------------------------------------------------------------ init
    def init_params(self, generator: Optional[torch.Generator] = None,
                    prevalent_state_dict: Optional[Mapping[str, Any]] = None,
                    wp_params: Optional[Mapping[str, torch.Tensor]] = None) -> None:
        """Random parameters from a seeded generator; with
        ``prevalent_state_dict`` (the reference's torch PREVALENT layout) the
        ``vln_bert`` core from it. The frozen waypoint predictor from
        ``wp_params`` or random from a generator seeded 7, as ``CEAgent``."""
        init_params(self.model, generator or make_generator(self.seed, self.device))
        if prevalent_state_dict is not None:
            self.model.vln_bert.load_state_dict(prevalent_to_state_dict(prevalent_state_dict))
        if wp_params is None:
            init_params(self.wp_model, make_generator(7, self.device))
        else:
            self.wp_model.load_state_dict(wp_params)

    @property
    def train_state(self) -> TrainState:
        """Gradient buffers and the AdamW state, made at first use."""
        if self._state is None:
            self._state = TrainState(self.model, self.optim, decay_all=True)
        return self._state

    def _upload(self, x) -> torch.Tensor:
        return to_device(x, self.device)

    # ------------------------------------------------------------ collection
    def _candidate_features(self, obs, cand_angles, cand_dists):
        """Static-slot candidate arrays; slot ``k`` (after the last live
        candidate) is the stop action with zero features, mirroring the
        reference's stop-as-last-candidate convention
        (dagger_trainer.py:222-228)."""
        m = self.cfg.model
        B = len(obs)
        n_cam = self.env.num_views
        rgb = np.zeros((B, self.K, m.image_feat_size), np.float32)
        dep = np.zeros((B, self.K, self.depth_dim), np.float32)
        dirs = np.zeros((B, self.K, m.angle_feat_size), np.float32)
        masks = np.zeros((B, self.K), bool)
        stop_idx = np.zeros(B, np.int32)
        for i, ob in enumerate(obs):
            k = 0
            depth_pooled = ob["depth_features"].reshape(n_cam, self.depth_dim, -1).mean(-1)
            for ang, dis in zip(cand_angles[i], cand_dists[i]):
                if k >= self.max_candidates:
                    break
                cam = int(round(ang / (2 * math.pi / n_cam))) % n_cam
                rgb[i, k] = ob["view_fts"][cam][: m.image_feat_size]
                dep[i, k] = depth_pooled[cam]
                dirs[i, k] = angle_features([ang], [0.0], m.angle_feat_size)[0]
                k += 1
            masks[i, : k + 1] = True  # candidates + the stop slot
            stop_idx[i] = k
        return rgb, dep, dirs, masks, stop_idx

    def _teacher(self, obs, cand_angles, cand_dists, stop_idx):
        """Oracle action (ref dagger_trainer._teacher_action:214-228): stop
        within STOP_RADIUS of the goal, else the candidate whose estimated
        position minimises the geodesic distance to the goal; a slot's
        candidate distances ride one batched ``dists_to_goal`` query."""
        a = np.zeros(len(obs), np.int64)
        for i, ob in enumerate(obs):
            if self.env.dist_to_goal(i) < STOP_RADIUS or not len(cand_angles[i]):
                a[i] = stop_idx[i]
                continue
            pos = estimate_cand_pos(ob["position"], ob["orientation"],
                                    cand_angles[i][: self.max_candidates],
                                    cand_dists[i][: self.max_candidates])
            a[i] = int(np.argmin(self.env.dists_to_goal(i, pos)))
        return a

    def collect(self, store: DaggerEpisodeStore, n_rollouts: int, beta: float = 1.0) -> int:
        """Teacher-policy-mixed rollouts; per step the executed action is the
        oracle w.p. ``beta`` else the policy argmax (dagger_trainer.py:
        304-307); the STORED action label is always the oracle's (:327)."""
        total = 0
        for _ in range(n_rollouts):
            with torch.inference_mode():
                eps = self._collect_rollout(beta)
            for e in eps:
                store.append(e)
            total += len(eps)
        return total

    def _collect_rollout(self, beta: float) -> List[Dict[str, np.ndarray]]:
        m, env = self.cfg.model, self.env
        T = self.cfg.max_action_len
        obs = env.reset()
        B = len(obs)
        ids, masks = _bucket_language([ob["instr_encoding"] for ob in obs])
        txt_masks = self._upload(masks)
        h_t, lang_feats = self.model("language", {"txt_ids": self._upload(ids),
                                                  "txt_masks": txt_masks})
        eps = [{
            "instruction_enc": ids[i][masks[i]],
            "cand_rgb": np.zeros((T, self.K, m.image_feat_size), np.float16),
            "cand_depth": np.zeros((T, self.K, self.depth_dim), np.float16),
            "cand_dir": np.zeros((T, self.K, m.angle_feat_size), np.float16),
            "cand_masks": np.zeros((T, self.K), bool),
            "action": np.full((T,), IGNORE_ID, np.int32),
        } for i in range(B)]
        ended = np.zeros(B, bool)
        for t in range(T):
            depth = np.concatenate([ob["depth_features"] for ob in obs], 0).reshape(
                B * env.num_views, *env.depth_feat_shape)
            heat = self.wp_model(self._upload(depth)).cpu().numpy()
            cand_angles, cand_dists, _ = extract_waypoints(
                heat, max_candidates=self.max_candidates, in_train=False, rng=self.np_rng)
            rgb, dep, dirs, cmask, stop_idx = self._candidate_features(obs, cand_angles,
                                                                        cand_dists)
            # recurrent step: h_t into language slot 0 (base_il_trainer.py:455-456)
            lf = torch.cat([h_t[:, None].to(lang_feats.dtype), lang_feats[:, 1:]], dim=1)
            h_t, scores = self.model("visual", {
                "lang_embeds": lf, "txt_masks": txt_masks, "cand_rgb": self._upload(rgb),
                "cand_depth": self._upload(dep), "cand_dir": self._upload(dirs),
                "cand_masks": self._upload(cmask)})
            scores = np.where(cmask, scores.float().cpu().numpy(), -np.inf)
            oracle = self._teacher(obs, cand_angles, cand_dists, stop_idx)
            act = scores.argmax(-1)
            mix = self.np_rng.uniform(size=B) <= beta
            act = np.where(mix, oracle, act)
            for i in range(B):
                if ended[i]:
                    continue
                eps[i]["cand_rgb"][t] = rgb[i]
                eps[i]["cand_depth"][t] = dep[i]
                eps[i]["cand_dir"][t] = dirs[i]
                eps[i]["cand_masks"][t] = cmask[i]
                eps[i]["action"][t] = oracle[i]
                if act[i] == stop_idx[i] or t == T - 1:
                    env.stop(i)
                    ended[i] = True
                else:
                    pos = estimate_cand_pos(obs[i]["position"], obs[i]["orientation"],
                                            [cand_angles[i][act[i]]],
                                            [cand_dists[i][act[i]]])[0]
                    # candidate angles are ego-relative clockwise; teleport
                    # takes the absolute heading: face the travelled direction
                    new_heading = (heading_from_quaternion(obs[i]["orientation"])
                                   + float(cand_angles[i][act[i]])) % (2 * math.pi)
                    env.teleport(i, pos, new_heading)
            if ended.all():
                break
            obs = env.observations()
        return eps

    # --------------------------------------------------------------- training
    @contextlib.contextmanager
    def _training(self):
        self.model.train()
        try:
            yield
        finally:
            self.model.eval()

    def _bptt_loss(self, batch: Mapping[str, np.ndarray]) -> torch.Tensor:
        """The summed cross-entropy over valid actions of a stacked episode
        batch, divided by their count, in the model's current mode: the
        language pass, then the recurrent visual steps, each with h_t in
        language slot 0 (a new tensor, never written in place)."""
        dev = {k: self._upload(v) for k, v in batch.items()}
        actions = np.asarray(batch["action"])
        valid_np = actions != IGNORE_ID
        h_t, lang_feats = self.model("language", {"txt_ids": dev["txt_ids"],
                                                  "txt_masks": dev["txt_masks"]})
        # trailing steps whose actions are all IGNORE_ID (the padding after
        # every episode's end) add exactly zero: the JAX scan runs them, the
        # port stops before them
        live = np.nonzero(valid_np.any(0))[0]
        total = torch.zeros((), device=self.device)
        for t in range(int(live[-1]) + 1 if len(live) else 0):
            lf = torch.cat([h_t[:, None].to(lang_feats.dtype), lang_feats[:, 1:]], dim=1)
            cmask = dev["cand_masks"][:, t]
            h_t, scores = self.model("visual", {
                "lang_embeds": lf, "txt_masks": dev["txt_masks"],
                "cand_rgb": dev["cand_rgb"][:, t].float(),
                "cand_depth": dev["cand_depth"][:, t].float(),
                "cand_dir": dev["cand_dir"][:, t].float(), "cand_masks": cmask})
            scores = torch.where(cmask, scores, torch.full_like(scores, -1e9))
            action = dev["action"][:, t].long()
            valid = action != IGNORE_ID
            logp = F.log_softmax(scores, dim=-1)
            ce = -logp.gather(1, torch.where(valid, action, 0)[:, None])[:, 0]
            total = total + (ce * valid).sum()
        return total / max(float(valid_np.sum()), 1.0)

    def _update(self, batch: Mapping[str, np.ndarray]):
        """One BPTT update (the reference's _update_agent, dagger_trainer.py:
        420-462): the loss with dropout on, its backward, the float32
        global-norm clip and AdamW. Returns (loss, grad norm) on the device."""
        state = self.train_state
        with self._training():
            loss = self._bptt_loss(batch)
        loss.backward()
        gnorm = state.apply_gradients()
        return loss.detach(), gnorm

    def train_epochs(self, store: DaggerEpisodeStore, epochs: int,
                     batch_size: Optional[int] = None) -> List[float]:
        """``epochs`` passes over the store; one read-back per update (the
        loss and the gradient norm, appended to ``logs``)."""
        batch_size = batch_size or self.env.batch_size
        losses = []
        for _ in range(epochs):
            for batch in store.iter_batches(batch_size, self.np_rng):
                loss, gnorm = self._update(batch)
                loss_val, gnorm_val = torch.stack([loss, gnorm]).tolist()
                self.logs["loss"].append(loss_val)
                self.logs["grad_norm"].append(gnorm_val)
                losses.append(loss_val)
        return losses

    # ------------------------------------------------------------ checkpoint
    def save_ckpt(self, path: str) -> str:
        """The policy's parameters and the AdamW state, one torch file (the
        frozen waypoint predictor is not in it)."""
        return save_checkpoint(path, self.model, self.train_state)

    def restore_ckpt(self, path: str, with_opt: bool = True) -> None:
        ckpt = load_checkpoint(path, self.device)
        self.model.load_state_dict(ckpt["params"])
        if with_opt:
            self.train_state.load_state_dict(ckpt["opt_state"])


def run_dagger(agent, store_dir: str, *, policy: str, dagger_iters: int = 3,
               update_size: int = 32, p: float = 0.75, epochs: int = 2,
               capacity: Optional[int] = None, log_fn=None) -> Dict[str, Any]:
    """The reference dagger loop (dagger_trainer.train:536-560 + IL.DAGGER
    defaults): per iteration collect ``update_size`` episodes at
    beta = p**iter (0.0**0.0 treated as 0, :478-480), then train ``epochs``
    over everything collected so far.

    ``agent`` is a PrevalentDaggerAgent (policy 'prevalent') or a glocal
    CEAgent (policy 'bev' or 'etp', collected through the
    TeacherRecollectionStore, which spills every bundle to ``store_dir`` and
    trains through ``learn_from_bundle``). The rollouts per iteration and
    ``collected`` count episodes of the env's global batch (under data
    parallelism a rank's env holds a share of its rows)."""
    history: Dict[str, Any] = {"collected": [], "losses": [], "betas": []}
    if policy == "prevalent":
        store = DaggerEpisodeStore(store_dir, capacity=capacity)

        def collect(n_roll, beta):
            return agent.collect(store, n_roll, beta=beta)

        def train():
            return agent.train_epochs(store, epochs)
    else:
        from ..nav.recollection import TeacherRecollectionStore

        store = TeacherRecollectionStore(agent, capacity=capacity or 1024, spill_dir=store_dir)

        def collect(n_roll, beta):
            return store.collect(n_roll, beta=beta) * agent.env.batch_size

        def train():
            return store.train_epochs(epochs, rng=agent.np_rng)
    for it in range(dagger_iters):
        beta = 0.0 if p == 0.0 else p ** it
        batch = agent.env.batch_size
        n = collect(max(1, (update_size + batch - 1) // batch), beta)
        losses = train()
        history["betas"].append(beta)
        history["collected"].append(n)
        history["losses"].append(float(np.mean(losses)) if losses else float("nan"))
        if log_fn:
            log_fn(it, {"dagger/beta": beta, "dagger/collected": n,
                        "dagger/loss": history["losses"][-1], "dagger/store_size": len(store)})
    return history
