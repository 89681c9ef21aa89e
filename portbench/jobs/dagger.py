"""DAgger fine-tuning as users run it: ``GMapNavAgent.train_iters(1,
feedback="dagger")`` over the program's ``R2RNavBatch``, one iteration a
teacher-forced rollout and a sampled rollout, each recorded and followed by
its eager replay update (``_learn``).

Set-up (``setup_s``, from process start): the world from the seed, the env
and the agent, the benchmark's weights and dropout generator, and the run's
first three rollouts with their updates (teacher, sampled, teacher), through
the calls ``train_iters`` makes: the updates the reference follows.

The window: whole iterations until ``--seconds`` have passed at the end of
one. ``episodes_per_s`` is every episode trained in the window (the batch's
episodes of each rollout, with the update that follows it) over the
window's wall time; ``nav_step_ms_p95`` the 95th percentile over every
navigation step of the window, from one observation of the env to the next.
With ``--trace 1`` the first ``trace_iterations`` iterations are traced.

After the window (the program freed): the reference works the BEV of every
step of the three checked rollouts out again from the observations, the
rollouts' fused logits, and the three updates in float32 from the same
weights and dropout seeds, and compares (``reference/train.py:compare``,
``bev_gap``, ``prob_gap``).
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from .. import counts, trace as tr
from .. import harness
from ..harness import Cell, Record, Result
from ..reference import bev as rbev, model as rmodel, nav as rnav, train as rtrain
from ..reference.config import settings
from .pretrain import Phases, dropout_seed, world_of

CHECK_ROLLOUTS = ("teacher", "sample", "teacher")


def nav_model(cell: Cell, num: rmodel.Numerics, device) -> rmodel.NavModel:
    m, _ = settings(cell.config["run"])
    with torch.device("meta"):
        model = rmodel.NavModel(m, num)
    return model if str(device) == "meta" else model.to_empty(device=device)


def weights(cell: Cell, seed: int, device) -> Dict[str, torch.Tensor]:
    m, _ = settings(cell.config["run"])
    shape_model = nav_model(cell, rmodel.Numerics(), "meta")
    named = [(n, tuple(p.shape)) for n, p in shape_model.named_parameters()]
    kinds = {n: rmodel.init_kind(n, p, shape_model) for n, p in shape_model.named_parameters()}
    return rtrain.seeded_weights(named, kinds, seed, device, m.initializer_range)


class Tap:
    """The benchmark's wrappers around the agent and its env: spans (env,
    update), the observation times that bound each navigation step, and,
    while ``keep`` is set, what the reference needs of each rollout."""

    def __init__(self, agent, record: Record, timeline: tr.Timeline):
        from vln_bevbert_tpu_torch.nav import agent as agent_mod

        self.record, self.timeline = record, timeline
        self.keep = self.resetting = False
        self.rollouts: List[dict] = []     # kept: obs, gathers, logits, bundle
        self.obs_times: List[List[float]] = []
        self.traced = None                 # while tracing: shapes and valid points
        env = agent.env
        for name in ("reset", "get_obs", "teleport"):
            setattr(env, name, self._env_call(getattr(env, name), name))
        splat = agent_mod.gather_and_splat
        agent_mod.gather_and_splat = self._gather(splat)
        forward = agent._forward
        agent._forward = self._forward(forward)
        learn = agent._learn
        agent._learn = self._learn(learn)
        bundle = agent.learn_from_bundle
        agent.learn_from_bundle = self._bundle(bundle)
        rollout = agent.rollout
        agent.rollout = self._rollout(rollout)

    def _rollout(self, fn):
        """The trace's idle gaps outside the env and the update are the
        rollout's host work."""
        def call(*args, **kwargs):
            with self.timeline.span("rollout"):
                return fn(*args, **kwargs)
        return call

    def _env_call(self, fn, name):
        def call(*args, **kwargs):
            if self.resetting:  # the env's reset reads its first observation
                return fn(*args, **kwargs)
            self.resetting = name == "reset"
            try:
                with self.record.span("env"), self.timeline.span("env"):
                    out = fn(*args, **kwargs)
            finally:
                self.resetting = False
            if name == "reset":
                self.obs_times.append([time.perf_counter()])
                if self.keep:
                    self.rollouts.append({"obs": [out], "gathers": [], "logits": []})
            elif name == "get_obs":
                self.obs_times[-1].append(time.perf_counter())
                if self.keep:
                    self.rollouts[-1]["obs"].append(out)
            return out
        return call

    def _gather(self, fn):
        def call(projector, pc, valid, feats, step_sel, step_ok, T_w2c, S_w2c):
            out = fn(projector, pc, valid, feats, step_sel, step_ok, T_w2c, S_w2c)
            if self.keep:
                self.rollouts[-1]["gathers"].append(
                    (step_sel.cpu().numpy(), step_ok.cpu().numpy()))
            if self.traced is not None:
                b, s = step_sel.shape
                rows = torch.arange(b, device=step_sel.device)[:, None]
                n_valid = (valid[rows, step_sel.long()] & step_ok[:, :, None]).sum(dim=(1, 2))
                self.traced["gathers"].append((n_valid, s * pc.shape[2], feats.shape[-1],
                                               feats.element_size()))
            return out
        return call

    def _forward(self, fn):
        def call(mode, batch):
            out = fn(mode, batch)
            if mode == "navigation" and self.keep:
                self.rollouts[-1]["logits"].append(out["fused_logits"].float().cpu())
            if self.traced is not None:
                self.traced["forwards"].append((mode, {k: tuple(np.shape(v)) for k, v
                                                       in batch.items()}))
            return out
        return call

    def _learn(self, fn):
        def call(lang, records):
            with self.record.span("update"), self.timeline.span("update"):
                return fn(lang, records)
        return call

    def _bundle(self, fn):
        def call(rb):
            if self.keep:
                self.rollouts[-1]["bundle"] = {
                    k: (v.cpu() if isinstance(v, torch.Tensor) else np.array(v))
                    for k, v in rb.items()}
            if self.traced is not None:
                self.traced["updates"].append(
                    (tuple(np.shape(rb["txt_ids"])), tuple(np.shape(rb["view_fts"])),
                     int((~rnav.skipped(np.asarray(rb["targets"]))).sum())))
            return fn(rb)
        return call


# ---------------------------------------------------------------- counting
def count_traced(cell: Cell, traced: dict) -> dict:
    """FLOPs of the traced forwards and updates (the reference on ``meta``,
    at the program's precision), the updates' dropout bytes, and the
    gathers' splat bytes."""
    m, s = settings(cell.config["run"])
    model = nav_model(cell, rmodel.Numerics(torch.bfloat16), "meta")
    D, C = m.hidden_size, m.num_bev_tokens
    meta = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt, device="meta")  # noqa
    cache: Dict[tuple, tuple] = {}

    def nav_batch(B, L, N, K):
        return {"txt_embeds": meta(B, L, D, dt=torch.bfloat16),
                "txt_masks": meta(B, L, dt=torch.bool),
                "gmap_img_embeds": meta(B, N, D), "gmap_step_ids": meta(B, N, dt=torch.long),
                "gmap_pos_fts": meta(B, N, m.angle_feat_size + 3),
                "gmap_masks": meta(B, N, dt=torch.bool), "gmap_pair_dists": meta(B, N, N),
                "gmap_visited_masks": meta(B, N, dt=torch.bool),
                "bev_fts": meta(B, C, m.bev_grid_feat_size),
                "bev_pos_fts": meta(B, C, m.angle_feat_size + 6),
                "bev_masks": meta(B, C, dt=torch.bool), "bev_nav_masks": meta(B, C, dt=torch.bool),
                "bev_cand_idxs": meta(B, K, dt=torch.long), "local_masks": meta(B, K, dt=torch.bool),
                "fuse_map": meta(B, N, K)}

    def measure(key, fn, train):
        if key not in cache:
            model.train(train)
            cache[key] = counts.count(model, fn, train)
        return cache[key]

    flops = dropout_bytes = 0.0
    for mode, shapes in traced["forwards"]:
        if mode == "language":
            B, L = shapes["txt_ids"]
            f, _ = measure(("lang", B, L), lambda: model.bert.encode_text(
                meta(B, L, dt=torch.long), meta(B, L, dt=torch.bool)), False)
        elif mode == "panorama":
            B, V = shapes["view_fts"][:2]
            f, _ = measure(("pano", B, V), lambda: model.bert.encode_pano_rows(
                meta(B, V, m.image_feat_size), meta(B, V, m.angle_feat_size + 3),
                meta(B, V, dt=torch.long), meta(B, dt=torch.long))[0], False)
        else:
            B, N = shapes["gmap_masks"]
            K = shapes["local_masks"][1]
            L = shapes["txt_masks"][1]
            f, _ = measure(("nav", B, L, N, K),
                           lambda: model.navigation(nav_batch(B, L, N, K)), False)
        flops += f
    for (B, L), (T, B2, V, F), live in traced["updates"]:
        N, K = s.max_gmap_len, s.max_local_len

        def replay():
            txt = model.bert.encode_text(meta(B, L, dt=torch.long), meta(B, L, dt=torch.bool))
            pano, _ = model.bert.encode_pano_rows(
                meta(T * B, V, F),
                meta(T * B, V, m.angle_feat_size + 3), meta(T * B, V, dt=torch.long),
                meta(T * B, dt=torch.long))
            tokens = pano.reshape(B, T * V, D).float()
            loss = tokens.sum() * 0
            for _ in range(live):
                batch = nav_batch(B, L, N, K)
                batch["txt_embeds"] = txt
                batch["gmap_img_embeds"] = torch.matmul(meta(B, N, T * V), tokens)
                loss = loss + model.navigation(batch).sum()
            return loss

        f, moved = measure(("update", B, L, T, V, live), replay, True)
        flops += f
        dropout_bytes += moved
    splat_bytes = 0.0
    for n_valid, n_points, feat_dim, feat_bytes in traced["gathers"]:
        for v in n_valid.tolist():
            splat_bytes += counts.splat_bytes(v, n_points, feat_dim, feat_bytes, C,
                                              feat_dim + 1, False)
    return {"flops": flops, "dropout_bytes": dropout_bytes, "splat_bytes": splat_bytes}


# -------------------------------------------------------------------- run
def program(cell: Cell, seed: int, world, device):
    from vln_bevbert_tpu_torch.configs import FinetuneConfig, load_config
    from vln_bevbert_tpu_torch.data.feature_db import DictFeatureDB
    from vln_bevbert_tpu_torch.data.nav_graph import NavGraph, build_scanvp_cands
    from vln_bevbert_tpu_torch.nav.agent import GMapNavAgent
    from vln_bevbert_tpu_torch.nav.env import R2RNavBatch

    # as cli/finetune.py builds it: bf16 GEMMs accumulate in float32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = load_config(FinetuneConfig, None, **cell.config["run"])
    cfg.seed = seed
    graphs = {s: NavGraph(*g) for s, g in world.scans.items()}
    env = R2RNavBatch(world.annotations, graphs, build_scanvp_cands(graphs),
                      view_db=DictFeatureDB(world.views), grid_db=DictFeatureDB(world.grids),
                      depth_db=DictFeatureDB(world.depths), batch_size=cfg.batch_size,
                      image_feat_size=cfg.model.image_feat_size, seed=seed, name="train")
    return cfg, GMapNavAgent(cfg, env, seed=seed, device=device)


def reference_checks(cell: Cell, seed: int, rollouts: List[dict], prog: rtrain.Readings,
                     device, num: rmodel.Numerics = rmodel.Numerics()):
    """The reference over the checked rollouts, in the program's order: each
    rollout's BEV and fused logits (eval mode, the parameters as they were
    when it ran), then its update. Returns (the gaps to the program's, the
    reference's readings)."""
    run = cell.config["run"]
    m, s = settings(run)
    out = reference_outputs(cell, seed, rollouts, device, num)
    gaps = output_gaps(program_outputs(rollouts, prog), out)
    return gaps, out.readings


class Outputs:
    """One side's outputs over the checked rollouts: each rollout's per-step
    BEV (n, B, cells, F) and fused logits, and the updates' readings."""

    def __init__(self, bevs: List[torch.Tensor], logits: List[List[torch.Tensor]],
                 readings: rtrain.Readings):
        self.bevs, self.logits, self.readings = bevs, logits, readings


def program_outputs(rollouts: List[dict], prog: rtrain.Readings) -> Outputs:
    return Outputs([ro["bundle"]["bev_fts"][:len(ro["gathers"])] for ro in rollouts],
                   [ro["logits"] for ro in rollouts], prog)


def reference_outputs(cell: Cell, seed: int, rollouts: List[dict], device,
                      num: rmodel.Numerics = rmodel.Numerics(), rows=None) -> Outputs:
    """The reference over the checked rollouts, in the program's order: each
    rollout's BEV and fused logits (eval mode, the parameters as they were
    when it ran), then its update. With ``rows`` each update sees only those
    rows of its episodes (a planted fault)."""
    run = cell.config["run"]
    m, s = settings(run)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = nav_model(cell, num, device)
    model.load_state_dict(weights(cell, seed, device))
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(dropout_seed(seed))
    rmodel.set_generator(model, gen)
    projector = rbev.Projector(s.grid_hw, s.num_views, m.bev_dim, m.bev_res, device=device)
    # the agent's AdamW: optax's defaults, decay on every parameter (mask=None)
    optim = {"learning_rate": run["learning_rate"], "lr_schedule": "constant",
             "betas": (0.9, 0.999), "weight_decay": run["weight_decay"]}
    stepper = rtrain.Stepper(model, optim, run["grad_norm"], decay_all=True)
    bevs, logits = [], []
    for ro in rollouts:
        rb = ro["bundle"]
        steps = torch.stack([rnav.rollout_bev(projector, ro["obs"], sel, ok, t, device,
                                              fp8=num.fp8)
                             for t, (sel, ok) in enumerate(ro["gathers"])])
        bev = torch.zeros(rb["bev_fts"].shape, device=device)
        bev[:len(steps)] = steps
        model.eval()
        logits.append([x.cpu() for x in rnav.rollout_logits(model, rb, bev, len(ro["logits"]),
                                                             device)])
        bevs.append(steps.cpu())
        model.train()
        if rows is not None:
            rb, bev = rnav.rows_of(rb, rows), bev[:, rows]
        stepper.step(lambda: rnav.episode_loss(model, rb, bev, run["ml_weight"], device))
    return Outputs(bevs, logits, stepper.readings())


def output_gaps(got: Outputs, ref: Outputs) -> Dict[str, tuple]:
    """``compare``'s numbers; the widest BEV gap (relative to the step's
    largest reference value); over the rollout steps, the median relative
    gap of the fused logits of the candidates the reference does not mask
    (``logit_gap``); and the widest gap of the policy's action
    probabilities, the softmax the rollout samples from (``prob_gap``)."""
    gaps = rtrain.compare(got.readings, ref.readings)
    gaps["bev_gap"] = gaps["prob_gap"] = (0.0, "")
    for r, (a, b) in enumerate(zip(got.bevs, ref.bevs)):
        for t in range(len(b)):
            gap = float((a[t] - b[t]).abs().max() / b[t].abs().max().clamp_min(1e-30))
            if gap > gaps["bev_gap"][0]:
                gaps["bev_gap"] = (gap, f"rollout {r + 1} step {t + 1}")
    steps = []
    for r, (a, b) in enumerate(zip(got.logits, ref.logits)):
        for t, (x, y) in enumerate(zip(a, b)):
            live = y > -1000.0
            steps.append((float((x[live] - y[live]).norm() / y[live].norm().clamp_min(1e-30)),
                          f"rollout {r + 1} step {t + 1}"))
            gap = float((torch.softmax(x, -1) - torch.softmax(y, -1)).abs().max())
            if gap > gaps["prob_gap"][0]:
                gaps["prob_gap"] = (gap, f"rollout {r + 1} step {t + 1}")
    gaps["logit_gap"] = sorted(steps)[len(steps) // 2]
    return gaps


class Setup:
    """The program as set-up leaves it: the agent in its env, wrapped by the
    benchmark, after the checked rollouts, and their readings."""

    def __init__(self, cell: Cell, seed: int, device, record: Record, timeline: tr.Timeline,
                 phases: Phases):
        from vln_bevbert_tpu_torch.ops.dropout import set_dropout_generator

        from .pretrain import leaf_change_norms, read_first_gradient

        world = world_of(cell, seed, device)
        phases("start, imports, card and world")
        self.cfg, self.agent = cfg, agent = program(cell, seed, world, device)
        start = weights(cell, seed, device)
        agent.model.load_state_dict(start)
        start = {n: t.cpu() for n, t in start.items()}
        gen = torch.Generator(device=device)
        gen.manual_seed(dropout_seed(seed))
        set_dropout_generator(agent.model, gen)
        self.tap = tap = Tap(agent, record, timeline)
        phases("agent and weights")
        tap.keep = True
        self.prog = prog = rtrain.Readings()
        for i, feedback in enumerate(CHECK_ROLLOUTS):
            _, loss = agent.rollout(feedback=feedback, train=True)
            prog.losses.append(loss)
            if i == 0:
                read_first_gradient(agent.train_state, prog)
        prog.change_norms = leaf_change_norms(agent.model, start)
        tap.keep = False

    def close(self) -> List[dict]:
        """Free the program's state on the card; returns the checked rollouts."""
        rollouts = self.tap.rollouts
        del self.agent, self.tap
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return rollouts


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, log=print) -> Result:
    record, timeline = Record(), tr.Timeline()
    phases = Phases(t_start, log)
    setup = Setup(cell, seed, device, record, timeline, phases)
    cfg, agent, tap, prog = setup.cfg, setup.agent, setup.tap, setup.prog
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    phases("checked rollouts")

    record.spans.clear()
    tap.obs_times.clear()
    trace_left = int(cell.traffic["trace_iterations"]) if trace and device.type == "cuda" else 0
    prof, traced = None, {}
    if trace_left:
        prof = tr.start(device)
        timeline.on = True
        tap.traced = {"forwards": [], "updates": [], "gathers": []}
        t_trace = time.perf_counter()
    t0 = time.perf_counter()
    iters = 0
    while True:
        agent.train_iters(1, feedback="dagger")
        iters += 1
        if trace_left and iters == trace_left:
            torch.cuda.synchronize(device)
            traced_s = time.perf_counter() - t_trace
            prof.stop()
            timeline.on = False
            shapes, tap.traced = tap.traced, None
        if time.perf_counter() - t0 >= seconds:
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    if prof is not None:
        if tap.traced is not None:  # the window closed first
            torch.cuda.synchronize(device)
            traced_s = time.perf_counter() - t_trace
            prof.stop()
            shapes, tap.traced = tap.traced, None
        traced = tr.reduce(prof, timeline, traced_s)
    phases("window")
    losses = agent.logs["IL_loss"][-2 * iters:]
    failed = cfg.batch_size * sum(not math.isfinite(v) for v in losses)
    steps = [b - a for times in tap.obs_times for a, b in zip(times, times[1:])]
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    episodes = 2 * iters * cfg.batch_size
    record.counters.update(nav_steps=len(steps), iterations=iters, window_s=window_s)
    del agent, tap
    rollouts = setup.close()
    if traced:
        traced.update(count_traced(cell, shapes))
        record.traced = traced

    phases("trace and counts")
    gaps, ref = reference_checks(cell, seed, rollouts, prog, device)
    phases("reference")
    log(f"[portbench] update losses program {prog.losses} reference {ref.losses}")
    checks = harness.checks(gaps, cell.limits, log)
    return Result(
        attempted=episodes, failed=failed, checks=checks, memory_peak_bytes=memory_peak,
        end_to_end={"episodes_per_s": episodes / window_s,
                    "nav_step_ms_p95": 1e3 * float(np.percentile(steps, 95)),
                    "setup_s": setup_s},
        record=record, breakdown=traced.get("breakdown") if traced else None)
