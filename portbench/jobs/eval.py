"""Greedy evaluation of the navigation agent as users run it:
``GMapNavAgent.rollout(feedback="argmax", train=False)`` over the program's
``R2RNavBatch``, driven as ``GMapNavAgent.test`` drives it: the env's epoch
reset (``reset_epoch(shuffle=False)``), then the items cycled in their fixed
order, one batch of episodes a rollout. A pass over the items is the
traffic's ``n_items / batch`` rollouts; the next pass starts with another
epoch reset, as the next ``test`` call would.

Set-up (``setup_s``, from process start): the world from the seed, the env,
the agent and the benchmark's weights, then the first two rollouts of a pass
through the same call, which the benchmark's tap records (the checked
rollouts), and the distance probe (``reference/eval.py``).

The window: whole rollouts until ``--seconds`` have passed at the end of
one; ``samples_per_s`` is every row of every rollout step finished in the
window (the batch of episodes each step advances) over the window's wall
time, up to the end of its device work. A sample is a row's step and not an
episode because at random weights how long the greedy agent goes on before
it stops depends on the seed (3 to 15 decisions an episode, the same for
every episode of a run), which would move an episode rate by 3x from seed
to seed; a step's work is nearly the same at every seed. The episodes per
second, mean decisions per episode and the share of episodes that reach
the last step (``max_action_len``) go to standard error. With ``--trace 1`` the job
records the program's spans, device phases and counters
(``profiling.recording``, cleared when the window opens), traces the first
``trace_rollouts`` rollouts of the window, and names the traced window's
idle gaps by the program's spans (``spans.name_gap``).

After the window (the program freed): the reference's stages of the two
checked rollouts, each fed the program's own inputs to it, and their gaps
(``reference/eval.py``).
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from .. import harness, rollout_figures
from .. import spans as pspans
from .. import trace as tr
from ..harness import Cell, Record, Result
from ..reference import bev as rbev
from ..reference import eval as reval
from ..reference import model as rmodel
from ..reference.config import settings
from .dagger import count_traced, nav_model, weights
from .pretrain import Phases, world_of

CHECKED_ROLLOUTS = 2
SPREL = "bert.global_encoder.sprel_linear.weight"


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return np.array(x, copy=True)


class Tap:
    """The benchmark's wrappers around the agent: while ``keep`` is set,
    what the reference needs of each rollout (its observations, gathers,
    and each forward's inputs and outputs, the node contraction's included);
    while ``traced`` is set, the forwards' shapes and each splat's points."""

    def __init__(self, agent, projector: rbev.Projector):
        from vln_bevbert_tpu_torch.nav import agent as agent_mod

        self.agent, self.agent_mod, self.projector = agent, agent_mod, projector
        self.keep = self.resetting = False
        self.rollouts: List[dict] = []
        self.traced = None
        self.moved: List[list] = []        # per step of a rollout: which rows moved
        self.originals = {"gather_and_splat": agent_mod.gather_and_splat}
        env = agent.env
        for name in ("reset", "get_obs"):
            setattr(env, name, self._env_call(getattr(env, name), name))
        agent_mod.gather_and_splat = self._gather(agent_mod.gather_and_splat)
        agent._forward = self._forward(agent._forward)
        agent._policy_node_embeds = self._nodes(agent._policy_node_embeds)
        agent._make_equiv_action = self._moves(agent._make_equiv_action)

    def close(self) -> None:
        self.agent_mod.gather_and_splat = self.originals["gather_and_splat"]

    def _env_call(self, fn, name):
        def call(*args, **kwargs):
            if self.resetting:  # an env whose reset reads its first observation
                return fn(*args, **kwargs)
            self.resetting = name == "reset"
            try:
                out = fn(*args, **kwargs)
            finally:
                self.resetting = False
            if self.keep:
                if name == "reset":
                    self.rollouts.append({"obs": [], "gathers": [], "pano": [], "nav": []})
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
                sel = step_sel.long()
                ok = (valid[rows, sel] & step_ok[:, :, None]).reshape(b, -1)
                _, inside = self.projector.cells(pc[rows, sel].reshape(b, -1, 3), T_w2c, S_w2c)
                self.traced["gathers"].append(((ok & inside).sum(1), s * pc.shape[2],
                                               feats.shape[-1], feats.element_size()))
            return out
        return call

    def _forward(self, fn):
        def call(mode, batch):
            out = fn(mode, batch)
            if self.keep:
                ro = self.rollouts[-1]
                if mode == "language":
                    ro["lang"] = {k: _host(v) for k, v in batch.items()}
                    ro["text"] = out.float().cpu()
                elif mode == "panorama":
                    ro["pano"].append({"in": {k: _host(v) for k, v in batch.items()},
                                       "out": out[0].float().cpu()})
                else:
                    nav = ro["nav"][-1]
                    nav["in"] = {k: _host(v) for k, v in batch.items() if k not in (
                        "txt_embeds", "gmap_img_embeds", "bev_fts")}
                    nav["bev_fts"] = batch["bev_fts"].float().cpu()
                    nav["logits"] = out["fused_logits"].float().cpu()
                    nav["gate"] = torch.as_tensor(out["fuse_weights"]).float().cpu().reshape(-1, 1)
            if self.traced is not None:
                self.traced["forwards"].append((mode, {k: tuple(np.shape(v)) for k, v
                                                       in batch.items()}))
            return out
        return call

    def _moves(self, fn):
        def call(actions, gmaps, obs, traj):
            self.moved.append([a is not None for a in actions])
            return fn(actions, gmaps, obs, traj)
        return call

    def _nodes(self, fn):
        def call(gmap_agg, pano_store, B):
            out = fn(gmap_agg, pano_store, B)
            if self.keep:
                self.rollouts[-1]["nav"].append({"gmap_agg": np.array(gmap_agg, copy=True),
                                                 "embeds": torch.from_numpy(np.array(out))})
            return out
        return call


def probe(agent, rollouts: List[dict], sprel: float) -> None:
    """The program's navigation forward on the last checked step's inputs
    with the distances stretched (``reference/eval.py:stretch``), kept as
    the last rollout's ``probe``."""
    ro = rollouts[-1]
    nav = ro["nav"][-1]
    batch = dict(nav["in"])
    batch["gmap_pair_dists"] = reval.stretch(nav["in"]["gmap_pair_dists"], sprel)
    batch.update(txt_embeds=ro["text"].to(torch.bfloat16), gmap_img_embeds=nav["embeds"],
                 bev_fts=nav["bev_fts"])
    device = agent.device
    with torch.inference_mode():
        out = agent.model("navigation", {k: reval.on_device(v, device) for k, v in batch.items()})
    ro["probe"] = {"in": batch, "logits": out["fused_logits"].float().cpu()}


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
                      image_feat_size=cfg.model.image_feat_size, seed=seed, name="val")
    return cfg, GMapNavAgent(cfg, env, seed=seed, device=device)


class Passes:
    """Rollouts as ``test`` runs them: an epoch reset before the first
    rollout of each pass over the items. Counts the rollout steps and each
    episode's moves."""

    def __init__(self, agent, tap: Tap, per_pass: int):
        self.agent, self.tap, self.per_pass, self.done = agent, tap, max(per_pass, 1), 0
        self.steps = 0
        self.moves: List[int] = []

    def rollout(self) -> list:
        if self.done % self.per_pass == 0:
            self.agent.env.reset_epoch(shuffle=False)
        self.tap.moved = []
        trajs, _ = self.agent.rollout(feedback="argmax", train=False)
        self.done += 1
        self.steps += len(self.tap.moved)
        self.moves.extend(np.sum(self.tap.moved, axis=0).astype(int).tolist())
        return trajs


class Setup:
    """The program as set-up leaves it: the agent in its env, wrapped by the
    benchmark, after the checked rollouts and the probe."""

    def __init__(self, cell: Cell, seed: int, device, phases: Phases):
        m, s = settings(cell.config["run"])
        world = world_of(cell, seed, device)
        phases("start, imports, card and world")
        self.cfg, self.agent = cfg, agent = program(cell, seed, world, device)
        start = weights(cell, seed, device)
        agent.model.load_state_dict(start)
        self.sprel = float(start[SPREL].reshape(-1)[0])
        del start
        self.tap = tap = Tap(agent, rbev.Projector(s.grid_hw, s.num_views, m.bev_dim,
                                                   m.bev_res, device=device))
        phases("agent and weights")
        self.passes = Passes(agent, tap, len(agent.env.data) // cfg.batch_size)
        tap.keep = True
        for _ in range(CHECKED_ROLLOUTS):
            self.passes.rollout()
        tap.keep = False
        probe(agent, tap.rollouts, self.sprel)

    def close(self) -> List[dict]:
        """Free the program's state on the card; returns the checked rollouts."""
        rollouts = self.tap.rollouts
        self.tap.close()
        del self.agent, self.tap, self.passes
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return rollouts


# ---------------------------------------------------------------- reference
def reference_model(cell: Cell, seed: int, device, num: rmodel.Numerics = rmodel.Numerics()):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = nav_model(cell, num, device)
    model.load_state_dict(weights(cell, seed, device))
    return model.eval()


def projector_of(cell: Cell, device) -> rbev.Projector:
    m, s = settings(cell.config["run"])
    return rbev.Projector(s.grid_hw, s.num_views, m.bev_dim, m.bev_res, device=device)


def reference_checks(cell: Cell, seed: int, rollouts: List[dict], device) -> Dict[str, tuple]:
    """The program's stage gaps to the float32 reference, and the chained
    ``logit_gap`` and ``prob_gap``."""
    steps = int(cell.config["run"]["max_action_len"])
    model, projector = reference_model(cell, seed, device), projector_of(cell, device)
    ref = reval.reference_stages(model, projector, rollouts, steps, device)
    chained = reval.reference_stages(model, projector, rollouts, steps, device, chained=True)
    return reval.gaps(reval.program_stages(rollouts), ref, rollouts, chained)


# ---------------------------------------------------------------------- run
def _counters(agent) -> Dict[str, float]:
    """The agent's counters, where the program has them."""
    read = getattr(agent, "counters", None)
    return dict(read()) if read is not None else {}


def name_gaps(prof, rec, thread: str) -> List[list]:
    """The traced window's ten longest idle gaps, named by the program's
    spans on the rollout's thread: [name (``name`` rule), seconds, the
    ``span`` rule's name]."""
    events = tr._device_events(prof)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    _, gaps = tr._union([(e.time_range.start, e.time_range.end) for e in events])
    out = []
    for a, b in sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:10]:
        t0, t1 = start_ns + int(a * 1e3), start_ns + int(b * 1e3)
        named = pspans.name_gap(t0, t1, rec.spans, thread) if rec is not None else {
            "name": "no host span", "span": "no host span"}
        out.append([named["name"], (b - a) * 1e-6, named["span"]])
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, log=print) -> Result:
    from vln_bevbert_tpu_torch.utils import profiling

    record = Record()
    phases = Phases(t_start, log)
    recording = profiling.recording(device) if trace else contextlib.nullcontext()
    with recording as rec:
        setup = Setup(cell, seed, device, phases)
        cfg, agent, tap, passes = setup.cfg, setup.agent, setup.tap, setup.passes
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t_start
        phases("checked rollouts")

        before = _counters(agent)
        if rec is not None:
            rec.clear()
        trace_left = int(cell.traffic["trace_rollouts"]) if trace and device.type == "cuda" else 0
        prof, traced = None, {}
        passes.moves.clear()
        passes.steps = 0
        if trace_left:
            prof = tr.start(device)
            tap.traced = {"forwards": [], "updates": [], "gathers": []}
        t0 = time.perf_counter()
        rollouts = 0
        while True:
            passes.rollout()
            rollouts += 1
            if prof is not None and tap.traced is not None and rollouts == trace_left:
                torch.cuda.synchronize(device)
                traced_s = time.perf_counter() - t0
                prof.stop()
                shapes, tap.traced = tap.traced, None
            if time.perf_counter() - t0 >= seconds:
                break
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
        if prof is not None:
            if tap.traced is not None:  # the window closed first
                traced_s = time.perf_counter() - t0
                prof.stop()
                shapes, tap.traced = tap.traced, None
            traced = tr.reduce(prof, tr.Timeline(), traced_s)
            traced["breakdown"]["idle_gaps"] = name_gaps(prof, rec,
                                                        threading.current_thread().name)
        after = _counters(agent)
        if rec is not None:
            rec.harvest()
            rollout_figures.reduce_recording(rec, record)
    phases("window")
    record.counters.update({k: after[k] - before.get(k, 0) for k in after})
    record.counters.update(rollouts=rollouts, window_s=window_s)
    steps = record.counters.get("rollout_steps")
    if steps and rec is not None:
        for kind in ("span_s", "self_s", "phase_s"):
            figures = {k.split(":", 1)[1]: round(1e3 * v / steps, 3)
                       for k, v in record.counters.items() if k.startswith(kind + ":")}
            log(f"[portbench] {kind} ms per rollout step over {steps} steps: {figures}")
    # an episode decides once a step up to the step it ends at
    decisions = np.asarray(passes.moves) + 1
    episodes = rollouts * cfg.batch_size
    samples = passes.steps * cfg.batch_size
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(f"[portbench] {episodes} episodes ({episodes / window_s:.4f} a second) in {rollouts} "
        f"rollouts of {passes.steps} steps: {decisions.mean():.4f} decisions per episode; "
        f"{(decisions >= cfg.max_action_len).mean():.4f} of them reach step "
        f"{cfg.max_action_len}")
    del agent, tap, passes
    checked = setup.close()
    if traced:
        traced.update(count_traced(cell, shapes))
        record.traced = traced
    phases("trace and counts")
    gaps = reference_checks(cell, seed, checked, device)
    phases("reference")
    checks = harness.checks(gaps, cell.limits, log)
    return Result(
        attempted=episodes, failed=0, checks=checks, memory_peak_bytes=memory_peak,
        end_to_end={"samples_per_s": samples / window_s, "setup_s": setup_s},
        record=record, breakdown=traced.get("breakdown") if traced else None)
