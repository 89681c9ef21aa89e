"""Data-parallel ranks for the port's tests: gloo ranks on the CPU, spawned
by ``torch.multiprocessing.spawn`` and joined over a ``file://`` store in a
directory of the test's own, so that concurrent test processes share no
port. This module imports torch and the port only: the spawned ranks load
no JAX.

``run(scenario, world, work_dir, spec)`` runs ``scenario(rank, world,
spec)`` in ``world`` ranks and returns their results in rank order
(``Ranks`` starts them and joins them later); every
scenario can also run in the calling process as ``scenario(0, 1, spec)``,
the one process at the global batch that the ranks are held to.
"""

from __future__ import annotations

import os
import sys
import time

import torch
import torch.multiprocessing as mp

from vln_bevbert_tpu_torch.parallel import distributed
from vln_bevbert_tpu_torch.parallel.mesh import shard_batch, shard_replay_bundle

COLLECTIVE_TIMEOUT_S = 60.0
JAX_MODULES = ("vln_bevbert_tpu", "jax", "jaxlib", "flax", "optax", "orbax")


def _rank_main(rank: int, scenario, world: int, work_dir: str, spec, device: str) -> None:
    torch.set_num_threads(1)  # tiny models; the suite's files share the cores
    distributed.initialize(device, backend="gloo", rank=rank, world_size=world,
                           init_method=f"file://{os.path.join(work_dir, 'store')}",
                           timeout_s=COLLECTIVE_TIMEOUT_S)
    try:
        result = scenario(rank, world, spec)
        result["jax_modules"] = sorted(m for m in sys.modules
                                       if m.split(".")[0] in JAX_MODULES)
        torch.save(result, os.path.join(work_dir, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()


class Ranks:
    """``scenario`` started in ``world`` spawned gloo ranks; ``results()``
    joins them. The caller may work meanwhile (the one process's reference
    run, say)."""

    def __init__(self, scenario, world: int, work_dir: str, spec,
                 timeout_s: float = 240.0, device: str = "cpu"):
        os.makedirs(work_dir, exist_ok=True)
        self.name, self.world, self.work_dir = scenario.__name__, world, work_dir
        self.deadline = time.monotonic() + timeout_s
        self.ctx = mp.spawn(_rank_main, args=(scenario, world, work_dir, spec, device),
                            nprocs=world, join=False)

    def results(self) -> list:
        """The ranks' results, rank order. A rank that raises fails the call
        with its traceback; ranks still running at the deadline are killed
        and the call fails."""
        try:
            while not self.ctx.join(timeout=1.0):
                if time.monotonic() > self.deadline:
                    raise TimeoutError(f"{self.name}: ranks still running at the deadline")
        finally:
            for proc in self.ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join(5.0)
        return [torch.load(os.path.join(self.work_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(self.world)]


def run(scenario, world: int, work_dir: str, spec, timeout_s: float = 240.0,
        device: str = "cpu") -> list:
    """``Ranks(...).results()``; ``device`` "cuda:0" puts every rank's gloo
    group and tensors on the one card."""
    return Ranks(scenario, world, work_dir, spec, timeout_s, device).results()


def _launches(device: torch.device) -> dict:
    """The operators' launch counts of this process (on a card), else {}."""
    if device.type != "cuda":
        return {}
    from vln_bevbert_tpu_torch import _build

    return {k: _build.launches(k) for k in ("splat", "dropout")}


# ---------------------------------------------------------------- scenarios
def chain(rank: int, world: int, spec) -> dict:
    """Several scenarios in one group: ``spec`` is a list of (scenario,
    spec) pairs; their results in order."""
    return {"results": [fn(rank, world, s) for fn, s in spec]}


def gather(rank: int, world: int, spec) -> dict:
    """``all_gather_objects`` and ``merge_results`` of the rank's share of
    ``spec["preds"]`` (a list of per-rank prediction lists)."""
    mine = spec["preds"][rank] if world > 1 else [p for ps in spec["preds"] for p in ps]
    gathered = distributed.all_gather_objects({"rank": rank, "preds": mine})
    return {"gathered": gathered,
            "merged": distributed.merge_results([g["preds"] for g in gathered])}


def pretrain_steps(rank: int, world: int, spec) -> dict:
    """``spec["tasks"]`` pretraining steps of ``spec["cfg"]`` on the rank's
    rows of ``spec["batch"]`` (numpy, the global batch); parameters random
    from ``spec["seed"]`` or ``spec["params"]`` (a state dict). Per step
    the metrics, then the parameters."""
    from vln_bevbert_tpu_torch.parallel.mesh import replicate_module
    from vln_bevbert_tpu_torch.parallel.train_step import (
        init_pretrain_state,
        make_pretrain_step,
        upload,
    )

    device = torch.device(spec.get("device", "cpu"))
    model, projector, state = init_pretrain_state(spec["cfg"], spec["seed"], device)
    if spec.get("params") is not None:
        model.load_state_dict(spec["params"])
    replicate_module(model)
    step = make_pretrain_step(model, projector)
    batch = upload(shard_batch(spec["batch"], rank, world), device)
    metrics = []
    for task in spec["tasks"]:
        m = step(state, batch, task)
        metrics.append({k: float(v.detach()) for k, v in m.items()})
    return {"metrics": metrics, "launches": _launches(device),
            "params": {n: p.detach().to("cpu", copy=True)
                       for n, p in model.named_parameters()}}


def _loss_and_grads(agent, rb) -> tuple:
    """The episode loss of ``rb`` in training mode, its gradients summed
    over the ranks (then cleared)."""
    state = agent.train_state
    with agent._training():
        loss = agent._episode_loss(rb)
    loss.backward()
    state.all_reduce_grads()
    loss = float(distributed.all_reduce_(loss.detach()))
    grads = {n: p.grad.to("cpu", copy=True) for n, p in agent.model.named_parameters()}
    for flat in state.flat_grads:
        flat.zero_()
    return loss, grads


def replay(rank: int, world: int, spec) -> dict:
    """The episode loss of the rank's rows of the replay bundle
    ``spec["rb"]`` in training mode, its gradients summed over the ranks,
    then one ``learn_from_bundle`` update from the same rows."""
    import numpy as np

    from vln_bevbert_tpu_torch.nav.agent import make_replay_agent

    rb = spec["rb"]
    batch = rb["targets"].shape[1]
    agent = make_replay_agent(spec["cfg"], batch // world, seed=spec["seed"],
                              device=spec.get("device", "cpu"))
    if spec.get("params") is not None:
        agent.model.load_state_dict(spec["params"])
    local = shard_replay_bundle(rb, rank, world)
    loss, grads = _loss_and_grads(agent, local)
    update_loss = agent.learn_from_bundle(local)
    return {"loss": loss, "grads": grads, "update_loss": update_loss,
            "launches": _launches(torch.device(spec.get("device", "cpu"))),
            "grad_norm": agent.logs["grad_norm"][-1],
            "params": {n: p.detach().to("cpu", copy=True)
                       for n, p in agent.model.named_parameters()},
            "finite": bool(np.isfinite(update_loss))}


def cli(rank: int, world: int, spec) -> dict:
    """``vln_bevbert_tpu_torch.cli.<spec["module"]>.main`` on ``spec["argv"]``
    plus ``--output_dir spec["out"][rank]``: a directory per rank, so that
    a test can see which rank wrote what."""
    import importlib

    module = importlib.import_module(f"vln_bevbert_tpu_torch.cli.{spec['module']}")
    return {"res": module.main([*spec["argv"], "--output_dir", spec["out"][rank]])}


def pick(rank: int, world: int, spec) -> dict:
    """The sampled and the exploring actions of the rank's rows of global
    policy outputs (``spec["logits"]``, ``probs``, ``masks``, ``visited``),
    and the state of ``np_rng`` after them."""
    from vln_bevbert_tpu_torch.nav.agent import make_replay_agent

    b = len(spec["probs"]) // world
    rows = slice(rank * b, (rank + 1) * b)
    agent = make_replay_agent(spec["cfg"], b, seed=spec["seed"], device="cpu")
    nav_g = {"gmap_masks": spec["masks"][rows], "gmap_visited_masks": spec["visited"][rows]}
    out = {fb: agent._pick_actions(fb, None, spec["logits"][rows], spec["probs"][rows],
                                   nav_g, None)
           for fb in ("sample", "expl_sample", "argmax")}
    return {**out, "entropy": agent.logs["entropy"],
            "rng": agent.np_rng.bit_generator.state}


# ------------------------------------------------------- CE scenarios
def _ce_agent(rank: int, world: int, spec):
    """A ``CEAgent`` of ``spec["cfg"]`` (its batch the global one) in the
    rank's share of a synthetic continuous env, parameters from
    ``spec["params"]`` and ``spec["wp_params"]``, ``np_rng`` seeded
    ``spec["rng_seed"]``."""
    import numpy as np

    from vln_bevbert_tpu_torch.ce.agent import CEAgent
    from vln_bevbert_tpu_torch.ce.env import SyntheticContinuousEnv, make_synthetic_ce_episodes

    cfg = spec["cfg"]
    episodes = make_synthetic_ce_episodes(np.random.default_rng(3), n=spec["n_episodes"])
    env = SyntheticContinuousEnv(episodes, batch_size=cfg.batch_size, rank=rank, world=world,
                                 **spec["env"])
    agent = CEAgent(cfg, env, ghost_aug=spec.get("ghost_aug", 0.0), device="cpu")
    agent.init_params(wp_params=spec["wp_params"])
    agent.model.load_state_dict(spec["params"])
    agent.np_rng = np.random.default_rng(spec["rng_seed"])
    return agent


def _paths(trajs) -> list:
    import numpy as np

    return [(tr["instr_id"], np.stack(tr["positions"]), list(tr["headings"])) for tr in trajs]


def _captured_rollout(agent, **kw):
    """A training rollout whose replay bundle is kept, not trained on."""
    bundles = []
    agent.learn_from_bundle = lambda rb: bundles.append(rb) or 0.0
    try:
        trajs, _ = agent.rollout(train=True, **kw)
    finally:
        del agent.learn_from_bundle
    return trajs, bundles[0]


def ce_train(rank: int, world: int, spec) -> dict:
    """A sampled training rollout (``spec["sample_ratio"]``, waypoint
    sampling, ghost noise) whose bundle is kept: its trajectories and the
    ``np_rng`` state after it; with ``spec["replay"]`` then that bundle's
    loss and summed gradients, and one ``learn_from_bundle`` update."""
    agent = _ce_agent(rank, world, spec)
    trajs, rb = _captured_rollout(agent, feedback="sample", sample_ratio=spec["sample_ratio"])
    out = {"paths": _paths(trajs), "rng": agent.np_rng.bit_generator.state,
           "steps": int(rb["step_idx"].shape[0])}
    if spec.get("replay"):
        out["loss"], out["grads"] = _loss_and_grads(agent, rb)
        out["update_loss"] = agent.learn_from_bundle(rb)
        out["grad_norm"] = agent.logs["grad_norm"][-1]
        out["params"] = {n: p.detach().to("cpu", copy=True)
                         for n, p in agent.model.named_parameters()}
    return out


def ce_teacher(rank: int, world: int, spec) -> dict:
    """A teacher training rollout's replay loss and summed gradients."""
    agent = _ce_agent(rank, world, spec)
    trajs, rb = _captured_rollout(agent, feedback="teacher")
    loss, grads = _loss_and_grads(agent, rb)
    return {"paths": _paths(trajs), "loss": loss, "grads": grads}


def ce_eval(rank: int, world: int, spec) -> dict:
    """``evaluate`` (low-level control with tryout) and
    ``collect_predictions`` over the split, and ``np_rng``'s state after
    each."""
    from vln_bevbert_tpu_torch.ce.inference import collect_predictions

    agent = _ce_agent(rank, world, spec)
    metrics = agent.evaluate(num_batches=2)
    rng = agent.np_rng.bit_generator.state
    path_eps = collect_predictions(agent)
    return {"metrics": metrics, "rng": rng, "path_eps": path_eps,
            "rng_after_predictions": agent.np_rng.bit_generator.state}


def ce_dagger(rank: int, world: int, spec) -> dict:
    """``run_dagger`` with the glocal BEV policy (one iteration) into a
    store under ``spec["store"]``: its history and the store's spill dir."""
    from vln_bevbert_tpu_torch.ce.dagger import run_dagger

    agent = _ce_agent(rank, world, spec)
    history = run_dagger(agent, spec["store"], policy="bev", dagger_iters=1,
                         update_size=spec["update_size"], p=0.75, epochs=1)
    return {"history": history, "store": sorted(os.listdir(spec["store"])),
            "rng": agent.np_rng.bit_generator.state}


def refusal(rank: int, world: int, spec) -> dict:
    """The error of ``cli.<spec["module"]>.main(spec["argv"])`` and of a
    ``PrevalentDaggerAgent`` built in this process group, if any."""
    import importlib

    from vln_bevbert_tpu_torch.ce.dagger import PrevalentDaggerAgent

    module = importlib.import_module(f"vln_bevbert_tpu_torch.cli.{spec['module']}")
    out = {"cli": None, "agent": None}
    try:
        module.main(spec["argv"])
    except SystemExit as e:
        out["cli"] = str(e)
    try:
        PrevalentDaggerAgent(spec["cfg"], None, device="cpu")
    except RuntimeError as e:
        out["agent"] = str(e)
    return out
