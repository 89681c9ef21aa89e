"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths (eval, pretraining, fine-tuning, their object
grounding variants, and continuous-environment pretraining, training, eval,
inference and DAgger with its stores and env pool, CE training over the
Habitat sensor stack with the frozen CLIP and DDPPO towers, and
data-parallel pretraining, fine-tuning and CE training) at full
bert-base width with random seeded
weights, through the hand-written CUDA kernels, in phases; each phase prints
one line and a failing phase raises, so the script exits non-zero:

1. device  - a CUDA card must be present; its name and power limit;
2. build   - compile ``csrc/ops.cpp`` (the ``torch.ops.bevbert`` operators),
             ``csrc/splat.cu`` and ``csrc/dropout.cu`` with nvcc (sm_90a),
             one nvcc per source, started together, and link them into one
             library under ``build/``; seconds per source;
3. kernel  - the fused splat kernel against its plain PyTorch version (the
             gather, the payload concat, ``index_add_``) on the card at the
             navigation (rows read in place from the rollout's point-cloud
             store), pretraining (float16 features and semantic labels), CE
             rollout (B=8, 8 steps read in place, 121 cells) and CE
             pretraining (121 cells, float16, labels) shapes and at edge
             cases; per shape its time, its byte bound
             and the share reached, the library calls ``index_add_`` and
             one-hot ``torch.bmm``; the navigation BEV step's device time,
             fused against the parent's gather, concat and splat;
4. dropout - the dropout operator against its plain version, bitwise, at the
             pretraining step's and the replay update's largest sites, at
             object pretraining's object-feature and 64-slot panorama sites
             and at edge cases, beside ``F.dropout``; P(keep); host us per launch;
             the backward's mask; seed-only saved tensors; C++ launch counts
             of the backward;
5. slice   - the navigation eval (``cli.finetune --synthetic --test``); the
             splat kernel's launch count must equal the number of
             gather-and-splat calls, and the first step's BEV features and
             action must match the plain version's;
6. train   - the pretraining path (``cli.pretrain --synthetic --seed 16``),
             B=16, then its checkpoint; seed 16's schedule runs each of mlm,
             sap and masksem eight times in 24 steps, as three blocks
             (``task_block_size`` 8): every step a replay of a CUDA graph
             of the whole step (lift-splat, forward, backward, clip, AdamW),
             one graph captured per task; the kernels' launch counts (kept
             by the kernels on the device, so they count what ran) must
             equal the dropout calls (forward and backward) and the
             ``prepare_bev`` calls, a replay counting the calls its capture
             made and a capture's warm-up its own; losses and gradient norms
             finite; the blocks, graphs, capture seconds and replays; ms/step
             per task (CUDA events around each replay), samples/s weighted by
             the configured task mix, peak memory; then one more block traced
             (``utils/profiling.trace``): the device's busy share;
   block   - from one state (two such trainers from seed 16), one 8-step
             block of each task as graph replays and the same steps run
             eagerly (``make_pretrain_step``): the dropout generators end equal (the
             same seeds drawn), every step's loss within 1e-3 relative, the
             parameters within 1e-9 relative L2 and their movement from the
             start within 1e-4 of the eager movement; a cached block
             launches the splat and dropout kernels as often as the same
             steps run eagerly; wall ms per step in arms eager / graphed / graphed /
             eager; a graphed and an eager block traced: busy shares;
   validate - that checkpoint restored at ``PretrainConfig()`` defaults,
             ``validate(24, num_batches=8)`` over mlm, sap and masksem: splat
             launches = 24 ``eval_step`` + 8 ``sem_predictions``, no dropout
             launch, the dropout generator's state unchanged, every metric
             finite, AUC and F1 in [0, 1]; ms per eval batch per task;
   optim   - from that checkpoint, 7 B=16 sap steps of adamw and of each
             optimizer of ``OPTIMIZERS`` and 14 of adamw with gradient
             accumulation 2 (odd
             steps must move nothing); finite losses, every parameter with a
             gradient moved; each update's device ms (CUDA events around the
             update alone) against its state bytes at 3.35 TB/s;
   r4r_train, rxr_train - ``cli.pretrain --config`` of
             ``configs/r4r_pretrain.json`` (16 steps, seed 1: mlm and sap 8
             each) and ``configs/rxr_pretrain.json`` (XLM-R's 250002-row
             vocabulary; 24 steps, seed 16: 8 of each task), with
             ``valid_steps`` set so that validation and its checkpoint run
             twice, after the blocks that crossed ``valid_steps``; checked as
             ``train`` is, the validations' splat launches included;
7. finetune - DAgger fine-tuning (``cli.finetune --synthetic --pretrain_ckpt
             <the train phase's checkpoint> --iters 3 --log_every 3``) at the
             ``FinetuneConfig()`` defaults, B=4: 6 training rollouts and 6
             replay updates, then val_unseen; every navigation parameter
             must transfer from the checkpoint; splat launches must equal the
             gather-and-splat calls, dropout launches the replays' dropout
             calls (forward and backward); losses and gradient norms finite
             and > 0, every parameter moved; ``--test --pretrain_ckpt
             ckpt_latest`` must predict the trained agent's trajectories; ms
             per replay update and per training-rollout step, peak memory;
   replay_block - at ``FinetuneConfig()``'s full width, B=4, over a
             teacher rollout's bundle: ``make_replay_block`` (4 updates as
             graph replays) against the same updates eagerly by an agent
             from the same seed, held as ``block`` holds its steps (splat
             launches 0: the bundle carries ``bev_fts``); ms per update in
             arms eager / graphed / graphed / eager, the busy share of a
             traced block;
8. obj_train - object pretraining at ``configs/reverie_pretrain.json``'s
             widths and mix (image and object features 768, object
             probabilities 1000, 20 objects, B=16, mlm 5 / mrc 2 / sap 5 /
             og 2 / masksem 1) through ``PretrainTrainer`` over the synthetic
             REVERIE world with an ``ObjectDB``, seed 39 (each task 8 of 40
             steps), then its checkpoint; the same launch, loss and timing
             checks as ``train``, and og_acc in [0, 1];
9. obj_finetune - REVERIE DAgger fine-tuning (``cli.finetune --synthetic
             --dataset reverie``) from that checkpoint with a config of the
             same model widths (every navigation parameter transfers,
             ``og_head`` included), checked as ``finetune`` is, with SR, SPL,
             RGS and RGSPL in [0, 100]; ``--test`` from ``ckpt_latest`` must
             predict the same trajectories and ``predObjId``; then one SOON
             evaluation (``--dataset soon --test``);
10. small  - a small configuration evaluated on the card and on the CPU with
             the same parameters: equal trajectories, close logits; the same
             for a small CE configuration (float32, low-level control), whose
             heatmaps must be close too;
11. ce_pretrain - CE pretraining (``cli.pretrain --synthetic --config
             configs/ce_pretrain.json``: mlm 5 / sap 5, B=16, text 100, 11x11
             BEV at 1 m, the depth embedding flag), 16 steps with seed 2 (8
             of each task), then its checkpoint, checked as ``train`` is;
12. ce     - SS-BEV CE training (``cli.ce_train --trainer ss-bev --batch_size
             8 --allow_random_frozen --pretrain_ckpt <ce_pretrain's
             checkpoint> --iters 4 --log_every 2 --n_episodes 16``) at
             ``FinetuneConfig()``'s widths with the 11x11 CE map: 4 training
             rollouts with their replay updates, 2 evaluations; every
             navigation parameter must transfer; splat launches must equal
             the gather-and-splat calls, dropout launches the replays'
             dropout calls; losses finite and > 0, every parameter moved;
             SR, SPL, nDTW in [0, 100]; then ``--run_type eval`` over the two
             checkpoint files (control back-tracking) and ``--run_type
             inference`` from the last, which must cover every episode; ms
             per training iteration, per training-rollout and eval step, the
             waypoint predictor's device ms per call, peak memory; then one
             sampled training rollout and one replay update, each traced by
             ``utils/profiling.trace`` (host and CUDA activities, a
             ``span``): wall ms and the device's busy share;
13. ce_etp - the same with ``--trainer ss-etp --iters 2 --log_every 2``: the
             topo-only model, so the splat must launch 0 times;
    habitat - the Habitat sensor stack over a stand-in ``habitat`` module
             (this script's: seeded pose-dependent 224x224 RGB and 256x256
             depth, round obstacles; the simulator only) with checkpoint
             files written from seeds: the full-width CLIP ViT-B/16 and
             DDPPO ResNet-50 on the card against the CPU on one 12-view
             ring (pooled, grid, the DDPPO map within rtol 1e-3 atol 1e-3);
             then ``cli.ce_train --trainer ss-bev --habitat_config
             --clip_ckpt --ddppo_ckpt --batch_size 8 --iters 2 --log_every 2``
             from ce_pretrain's checkpoint, checked as ``ce`` is, its
             evaluation walking with low-level control; the towers' calls
             per step, CLIP ms per 12-view call and DDPPO ms per 12-frame
             call, an env's render and preprocess host ms, the grid's round
             trip to the host and back;
    precompute - the precompute pipeline's towers at full width over
             ``SyntheticImageSource`` frames: ms per viewpoint for the 36
             views, the 12-view ring and the 36 depth views;
14. dagger_prevalent - CE DAgger with the PREVALENT policy (``cli.ce_train
             --trainer dagger --policy prevalent --batch_size 8
             --dagger_iters 2 --update_size 16 --dagger_epochs 2 --dagger_p
             0.75``): bert-base with 9 language and 4 cross-modal layers,
             B=8, T=15, 5 candidates and the stop slot; betas 1 and 0.75,
             16 episodes a collection into the episode store, BPTT updates
             from it; dropout launches must equal the dropout calls, the
             splat launches none; losses finite, every parameter moved;
             ``ckpt_dagger`` restored into an agent of another seed gives
             the trained agent's action scores; ms per collection step, ms
             per BPTT update (CUDA events, without the first), the store's
             size on disk, peak memory;
    dagger_bev, dagger_etp - the same with ``--policy bev`` (and ``etp``,
             1 iteration of 8 episodes) from ce_pretrain's checkpoint: one
             replay bundle per collection rollout spilled to the
             recollection store, updates from the store; splat launches must
             equal the gather-and-splat calls (none for etp); ms per spilled
             bundle written and read, ms per update from the store;
15. ce_pool - three SS-BEV training rollouts (B=8, sampled) in process and
             through the CLI's env pool of 2 and 4 spawned workers, from one
             seed: equal trajectories; no worker holds the card open; ms per
             rollout step (all three, and the range of one) and the env's
             host ms per step.
16. dp_pretrain - data parallelism (under gloo every step runs eagerly:
             a CUDA graph cannot capture gloo's collectives; the pretraining
             phase draws a task per step, ``task_block_size`` 1):
             full-width pretraining in two gloo
             ranks sharing the one card (spawned; a ``file://`` store), 16
             rows each, 4 steps at the first seed whose per-step task draws
             include mlm, sap and masksem, against one process at 32 rows
             from the same seed: per-step losses and gradient norms within
             ``DP_PRETRAIN_RTOL``; on every rank the splat launches equal
             its ``prepare_bev`` calls and the dropout launches its dropout
             calls; per rank ms per step and the gradient all-reduce's ms
             (gloo stages the 955.3 MB of float32 gradients through the
             host: not a multi-card time), peak memory;
    dp_replay - one full-width replay update from a teacher bundle of 8
             rows (``cli.finetune --synthetic --batch_size 8``'s rollout,
             whose splat launches must equal its gather-and-splat calls) in
             two gloo ranks of 4 rows against one process of 8: loss,
             gradient norm and the summed gradients within
             ``DP_REPLAY_RTOL``, the dropout launches equal to the calls;
    dp_ce  - CE under data parallelism at full width (``cli.ce_train``'s
             defaults, float32 activations): two gloo ranks of 4 rows
             against one process of 8, from the same seeds: an SS-BEV
             sampled training rollout (waypoint sampling, ghost noise) with
             its replay update, a merged greedy evaluation, an SS-ETP sampled
             rollout; equal trajectories and ``np_rng`` states, the update
             within ``DP_REPLAY_RTOL``, equal eval metrics; on every rank the
             splat launches equal its gather-and-splat calls and the dropout
             launches its dropout calls;
    dp_nccl - the CLIs as users launch them, under ``torch.distributed.run
             --standalone --nproc_per_node 1`` on NCCL at world size 1:
             pretraining ``--synthetic --device cuda --num_steps 8`` (one
             block of 8 graph replays, NCCL's all-reduces captured in the
             graph; instrumented through this script's ``--torchrun-pretrain``
             entry) writes ``ckpt_8``, then ``cli.finetune --iters 1`` from
             it (through ``--torchrun-finetune``), then ``cli.ce_train
             --iters 1`` at B=8 (through ``--torchrun-ce``); in every run the
             splat and dropout launches must equal their calls; ms per step
             against the ``train`` phase's for the same task, the
             all-reduce's ms per step.

The kernel phase also holds the splat at the dp one-process shapes: (32,
2352, 441, 809) float16 (dp_pretrain) and dp_replay's teacher rollout at
(8, <=18816, 441, 769) bf16, and at a dp_ce rank's rollout step (4,
<=18816, 121, 769) bf16; the dropout phase the attention probabilities
at (32, 12, 441, 441) and (8, 12, 441, 441) bf16, the replay panorama at
(120, 44, 768) bf16, and dp_ce's float32 replay sites, a rank's (4, 12,
121, 121) and (60, 44, 768) and the one process's (8, 12, 121, 121) and
(120, 44, 768).

The dropout phase also holds the kernel to its plain version, forward and
backward bitwise, at the PREVALENT update's sites (B=8, language bucket 32,
7 [state; vision] rows), and at the ``Critic``'s two sites ((8, 768) and
(8, 512) float32, rate 0.5), and the full-width ``Critic`` in training mode
bitwise against its plain version on the seeds it draws.

Launch counts are the kernels' own (a device counter each kernel adds one
to per launch, read through ``_build.launches``), set to 0 just before each
path and read just after it: a graph replay counts its launches where they
run, and a capture counts none. The second-to-last line is a
JSON record of the kernels; the last line is ``{"ok": true, "device": {...}}``.
The port imports neither JAX nor the JAX package ``vln_bevbert_tpu``, and
the run checks that none of their modules was loaded.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

SPLAT = {"name": "splat_sums", "route": "cuda",
         "source": "vln_bevbert_tpu_torch/csrc/splat.cu",
         "replaces": "vln_bevbert_tpu/ops/pallas_splat.py:47"}
DROPOUT = {"name": "seeded_dropout", "route": "cuda",
           "source": "vln_bevbert_tpu_torch/csrc/dropout.cu",
           "replaces": "vln_bevbert_tpu/ops/dropout.py:122"}
# The count and one-hot columns are integer-valued and must match exactly;
# feature sums of bf16 values accumulate in float32 in another order
# (atomics), hence:
RTOL, ATOL = 1e-5, 1e-3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
PREVALENT_SITES = {
    "prev_lang_hidden": ((8, 32, 768), torch.bfloat16, 0.1),
    "prev_lang_attn_probs": ((8, 12, 32, 32), torch.bfloat16, 0.1),
    "prev_cand": ((8, 6, 768), torch.float32, 0.1),
    "prev_cross_attn_probs": ((8, 12, 7, 31), torch.bfloat16, 0.1),
    "prev_self_attn_probs": ((8, 12, 7, 7), torch.bfloat16, 0.1),
    "prev_x_hidden": ((8, 7, 768), torch.bfloat16, 0.1),
}
OG_SHIFT_INVARIANT = ("og_head.fc2.bias", "og_head.ln.bias")
CRITIC_SITES = {
    "critic_state": ((8, 768), torch.float32, 0.5),
    "critic_hidden": ((8, 512), torch.float32, 0.5),
}
DROPOUT_COPIES = 64  # the most input copies a dropout site is timed over
H100_L2_BYTES = 50 << 20  # where the device properties lack the L2's size


def free_memory() -> None:
    """Release what the previous phase left: objects held only by reference
    cycles (an instrumented method that refers to its own object) and the
    allocator's cache, so that each phase's peak memory is its own."""
    gc.collect()
    torch.cuda.empty_cache()


def phase(tag: str, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def with_device_events(session):
    """``session()`` (a profiled run returning its profiler and a result)
    until its profiler holds device events, at most six times: the tracer
    has returned sessions without them. Returns (device events, result)."""
    for attempt in range(6):
        if attempt:
            time.sleep(0.2)
        prof, out = session()
        # kernels and copies; not the device-side spans of record_function
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        if events:
            return events, out
    raise RuntimeError("torch.profiler recorded no device time in six sessions")


def device_ms_by_kernel(fn, iters: int = 10) -> dict:
    """Mean device milliseconds per call of each kernel (and copy) that
    ``fn`` runs, by torch.profiler: their own time, without the gaps in
    which the host is still launching (which CUDA events around a short
    kernel measure instead)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()

    def session():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return prof, None

    by_name = {}
    for e in with_device_events(session)[0]:
        r = e.time_range
        by_name[e.name] = by_name.get(e.name, 0.0) + (r.end - r.start) / 1e3 / iters
    return by_name


def traced_busy(fn, label: str, log_dir: str) -> tuple:
    """``fn()`` under ``utils.profiling.trace`` (host and CUDA activities,
    a Chrome trace into ``log_dir``) inside a ``span(label)``:
    (its result, {wall ms to the end of its device work, the device's busy
    ms (the union of the kernel and copy intervals) and share of the
    wall}). A retried session runs ``fn`` again."""
    from vln_bevbert_tpu_torch.cli.profile_eval import device_busy_us
    from vln_bevbert_tpu_torch.utils import profiling

    def session():
        torch.cuda.synchronize()
        with profiling.trace(log_dir) as prof:
            t0 = time.perf_counter()
            with profiling.span(label):
                out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return prof, (out, wall)

    events, (out, wall) = with_device_events(session)
    busy_s = device_busy_us(events) / 1e6
    return out, {"wall_ms": 1e3 * wall, "busy_ms": 1e3 * busy_s, "busy_share": busy_s / wall}


def dropout_device_share(fn) -> dict:
    """The dropout kernel's device ms in one call of ``fn`` (a graphed
    block), all the call's device ms (kernels and copies) and the dropout's
    share of them, by ``device_ms_by_kernel``."""
    by_kernel = device_ms_by_kernel(fn, iters=1)
    drop = sum(ms for name, ms in by_kernel.items() if "dropout_kernel" in name)
    if drop == 0:
        raise AssertionError("the traced block ran no dropout kernel")
    total = sum(by_kernel.values())
    return {"dropout_device_ms": drop, "device_ms": total, "dropout_share": drop / total}


def device_ms(fn, iters: int = 10) -> float:
    """Mean device milliseconds per call of all the kernels ``fn`` runs."""
    return sum(device_ms_by_kernel(fn, iters).values())


# ------------------------------------------------------ habitat stand-in
# The card machine has no habitat-sim. The habitat phase drives the port's
# binding (``ce/habitat_binding.py``) over this stand-in of the simulator's
# surface: the one ``tests/test_binding_mocks.py`` fakes, plus
# ``get_config`` and ``make_dataset``. It renders seeded, pose-dependent
# frames; the towers, the splat and the dropout all run on the card.
class _Node(dict):
    """A habitat config node: attribute access, ``defrost``/``freeze``."""

    __getattr__ = dict.get

    def __setattr__(self, key, value):
        self[key] = value

    def defrost(self):
        pass

    def freeze(self):
        pass


def _node(tree):
    return _Node({k: _node(v) for k, v in tree.items()}) if isinstance(tree, dict) else tree


class _Quat:
    """habitat-sim's quaternion: coefficients as attributes."""

    def __init__(self, q):
        self.x, self.y, self.z, self.w = ((q.x, q.y, q.z, q.w) if hasattr(q, "x")
                                          else (float(v) for v in q))


class StandInSim:
    """Agent state, a renderer, a navmesh step filter and a geodesic oracle
    over an open plane with round obstacles (motion into one stops at the
    start). A view is a window of a seeded panoramic texture, shifted by
    the agent's heading and position, RGB ``rgb_hw`` square uint8 and depth
    ``depth_hw`` square in [0, 1] with some zero (no-return) pixels."""

    def __init__(self, config):
        import numpy as np

        sim = config.SIMULATOR
        self.rgb_hw, self.depth_hw = sim.RGB_SENSOR.WIDTH, sim.DEPTH_SENSOR.WIDTH
        rng = np.random.default_rng(config.SEED)
        self.rgb_tex = rng.integers(0, 256, (self.rgb_hw, 4 * self.rgb_hw, 3), dtype=np.uint8)
        depth = rng.uniform(0.05, 1.0, (self.depth_hw, 4 * self.depth_hw)).astype(np.float32)
        depth[rng.random(depth.shape) < 0.03] = 0.0
        self.depth_tex = depth
        self.obstacles = np.asarray(config.OBSTACLES, np.float64).reshape(-1, 3)
        self.position = np.zeros(3)
        self.rotation = _Quat([0.0, 0.0, 0.0, 1.0])

    def get_agent_state(self):
        from types import SimpleNamespace

        return SimpleNamespace(position=self.position.copy(), rotation=self.rotation)

    def set_agent_state(self, position, rotation, reset_sensors=True):
        import numpy as np

        self.position = np.asarray(position, np.float64).copy()
        self.rotation = _Quat(rotation)
        return True

    def get_sensor_observations(self):
        import math

        import numpy as np

        q = self.rotation
        heading = 2.0 * math.atan2(q.y, q.w)
        shift = heading / (2 * math.pi) + 0.37 * self.position[0] + 0.61 * self.position[2]
        rgb_cols = (np.arange(self.rgb_hw) + int(shift * 4 * self.rgb_hw)) % (4 * self.rgb_hw)
        d_cols = (np.arange(self.depth_hw) + int(shift * 4 * self.depth_hw)) % (4 * self.depth_hw)
        scale = 0.6 + 0.4 * abs(math.sin(self.position[0] + 2.0 * self.position[2]))
        return {"rgb": self.rgb_tex[:, rgb_cols], "depth": self.depth_tex[:, d_cols] * scale}

    def step_filter(self, start, target):
        import numpy as np

        target = np.asarray(target, np.float64)
        d = np.hypot(target[0] - self.obstacles[:, 0], target[2] - self.obstacles[:, 1])
        return np.asarray(start, np.float64) if (d < self.obstacles[:, 2]).any() else target

    def geodesic_distance(self, a, b):
        import numpy as np

        return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64)))


class StandInEnv:
    def __init__(self, config):
        self.sim = StandInSim(config)
        self.current_episode = None

    def reset(self):
        ep = self.current_episode
        self.sim.set_agent_state(ep.start_position, ep.start_rotation)


def stand_in_episodes(config):
    """``make_dataset``: seeded R2R-CE-like episodes on the open plane."""
    import math
    from types import SimpleNamespace as NS

    import numpy as np

    rng = np.random.default_rng(config.SEED)
    episodes = []
    for i in range(config.NUM_EPISODES):
        start = np.array([rng.uniform(-2, 2), 0.0, rng.uniform(-2, 2)])
        path = [start]
        for _ in range(int(rng.integers(3, 6))):
            ang = rng.uniform(0, 2 * math.pi)
            path.append(path[-1] + rng.uniform(1.5, 3.0) * np.array([-math.sin(ang), 0.0,
                                                                      -math.cos(ang)]))
        heading = float(rng.uniform(0, 2 * math.pi))
        episodes.append(NS(
            episode_id=f"{config.SPLIT}_{i}", scene_id="stand_in",
            instruction=NS(instruction_tokens=rng.integers(
                1000, 2000, int(rng.integers(12, 40))).tolist()),
            reference_path=[p.tolist() for p in path], goals=[NS(position=path[-1].tolist())],
            start_position=start.tolist(),
            start_rotation=[0.0, math.sin(heading / 2), 0.0, math.cos(heading / 2)]))
    return NS(episodes=episodes)


def habitat_stand_in():
    """The stand-in ``habitat`` module, for ``sys.modules["habitat"]``."""
    import types

    def get_config(path):
        with open(path) as f:
            return _node(json.load(f))  # JSON is YAML

    def make_dataset(kind, config):
        if kind != "StandIn-v1":
            raise ValueError(f"unknown dataset type {kind}")
        return stand_in_episodes(config)

    mod = types.ModuleType("habitat")
    mod.Env, mod.get_config, mod.make_dataset = StandInEnv, get_config, make_dataset
    return mod


def write_habitat_config(path: str, rgb_hw: int = 224, depth_hw: int = 256,
                         episodes: int = 16, seed: int = 0) -> str:
    """A stand-in habitat config: the sensors, the dataset, the obstacles."""
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    obstacles = [[float(rng.uniform(-6, 6)), float(rng.uniform(-6, 6)), 0.5] for _ in range(6)]
    cfg = {"SEED": seed, "OBSTACLES": obstacles,
           "SIMULATOR": {"RGB_SENSOR": {"WIDTH": rgb_hw, "HEIGHT": rgb_hw},
                         "DEPTH_SENSOR": {"WIDTH": depth_hw, "HEIGHT": depth_hw}},
           "DATASET": {"TYPE": "StandIn-v1", "SPLIT": "train", "DATA_PATH": "stand_in",
                       "NUM_EPISODES": episodes, "SEED": seed}}
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def hf_clip_state_dict(hidden=768, inter=3072, layers=12, patch=16, image=224, seed=0):
    """A random state dict in HF ``CLIPVisionModel`` layout (names and
    shapes of openai/clip-vit-base-patch16 at the defaults), from a seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shapes = {"embeddings.class_embedding": (hidden,),
              "embeddings.patch_embedding.weight": (hidden, 3, patch, patch),
              "embeddings.position_embedding.weight": ((image // patch) ** 2 + 1, hidden)}
    norms = ["pre_layrnorm", "post_layernorm"]
    for i in range(layers):
        p = f"encoder.layers.{i}"
        for n in ("q", "k", "v", "out"):
            shapes[f"{p}.self_attn.{n}_proj.weight"] = (hidden, hidden)
            shapes[f"{p}.self_attn.{n}_proj.bias"] = (hidden,)
        shapes.update({f"{p}.mlp.fc1.weight": (inter, hidden), f"{p}.mlp.fc1.bias": (inter,),
                       f"{p}.mlp.fc2.weight": (hidden, inter), f"{p}.mlp.fc2.bias": (hidden,)})
        norms += [f"{p}.layer_norm1", f"{p}.layer_norm2"]
    for n in norms:
        shapes[f"{n}.weight"] = shapes[f"{n}.bias"] = (hidden,)
    out = {}
    for name, shape in shapes.items():
        mean = 1.0 if name.endswith(".weight") and len(shape) == 1 else 0.0
        out["vision_model." + name] = torch.from_numpy(
            rng.normal(mean, 0.02, shape).astype(np.float32))
    return out


def ddppo_checkpoint(baseplanes=32, layers=(3, 4, 6, 3), channels=128, seed=0):
    """A random DDPPO point-nav checkpoint: ``state_dict`` holding the
    visual encoder under ``actor_critic.net.visual_encoder.`` (the
    published gibson-2plus-resnet50.pth layout) beside a policy head the
    surgery leaves out, from a seed. Convolutions He-scaled, GroupNorm
    scales near 1."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shapes, inplanes, planes = {}, baseplanes, baseplanes

    def conv(name, o, i, k):
        shapes[f"{name}.weight"] = (o, i, k, k)

    def gn(name, c):
        shapes[f"{name}.weight"] = shapes[f"{name}.bias"] = (c,)

    conv("backbone.conv1", baseplanes, 1, 7)
    gn("backbone.bn1", baseplanes)
    for stage, blocks in enumerate(layers):
        for b in range(blocks):
            p, stride = f"backbone.layer{stage + 1}.{b}", 2 if (b == 0 and stage > 0) else 1
            conv(f"{p}.convs.0", planes, inplanes, 1)
            gn(f"{p}.convs.1", planes)
            conv(f"{p}.convs.3", planes, planes, 3)
            gn(f"{p}.convs.4", planes)
            conv(f"{p}.convs.6", 4 * planes, planes, 1)
            gn(f"{p}.convs.7", 4 * planes)
            if inplanes != 4 * planes or stride != 1:
                conv(f"{p}.downsample.0", 4 * planes, inplanes, 1)
                gn(f"{p}.downsample.1", 4 * planes)
            inplanes = 4 * planes
        if stage < len(layers) - 1:
            planes *= 2
    conv("compression.0", channels, inplanes, 3)
    gn("compression.1", channels)
    sd = {}
    for name, shape in shapes.items():
        if len(shape) == 4:
            val = rng.normal(0.0, (2.0 / np.prod(shape[1:])) ** 0.5, shape)
        else:
            val = rng.normal(1.0 if name.endswith(".weight") else 0.0, 0.1, shape)
        sd["actor_critic.net.visual_encoder." + name] = torch.from_numpy(val.astype(np.float32))
    sd["actor_critic.action_distribution.linear.weight"] = torch.zeros(4, 512)
    return {"state_dict": sd}


# ------------------------------------------------------------------ phases
def device_phase() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs one card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    phase("device", name=repr(name), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)
    print(smi.splitlines()[0], flush=True)
    return name


def host_us(fn, iters: int = 200) -> float:
    """Host microseconds per call: the enqueue, without waiting for the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * secs / iters


def bound_ms(n_bytes: int) -> float:
    """The least time the card takes to move ``n_bytes`` of device memory."""
    return 1e3 * n_bytes / HBM_BYTES_PER_S


def build_phase() -> None:
    from vln_bevbert_tpu_torch import _build

    t0 = time.perf_counter()
    path, logs = _build.build()
    secs = time.perf_counter() - t0
    _build.load()
    for source, (src_s, log) in logs.items():
        ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "smem" in ln]
        phase("build", source=source, seconds=f"{src_s:.2f}", ptxas=repr(" | ".join(ptxas)))
    phase("build", library=path.name, wall_seconds=f"{secs:.2f}", built=bool(logs))


def splat_case(g, b, t, p, s, c, f, num_sem, dtype):
    """Inputs of the fused splat: a (B, T, P, F) store read through a (B, S)
    step_sel of distinct steps (T > 1) or (B, S * P, F) rows (T == 1);
    int32 cells, a third of them invalid (-1); labels when num_sem > 0."""
    store = torch.randn(b, t, p, f, generator=g, device="cuda").to(dtype)
    step_sel = None
    if t > 1:
        step_sel = torch.stack([torch.randperm(t, generator=g, device="cuda")[:s]
                                for _ in range(b)]).int()
    else:
        store = store[:, 0]
    n = s * p
    cell = torch.randint(0, c, (b, n), generator=g, device="cuda", dtype=torch.int32)
    cell[torch.rand(b, n, generator=g, device="cuda") > 2 / 3] = -1
    sem = (torch.randint(0, num_sem, (b, n), generator=g, device="cuda", dtype=torch.int32)
           if num_sem else None)
    return cell, store, dict(step_sel=step_sel, sem_labels=sem, num_sem=num_sem)


def check_sums(label: str, out: torch.Tensor, ref: torch.Tensor, f: int) -> float:
    if not torch.equal(out[..., f:], ref[..., f:]):
        raise AssertionError(f"{label}: count / one-hot columns differ from the plain version")
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL, msg=lambda m: f"{label}: {m}")
    return (out - ref).abs().max().item()


def kernel_phase() -> dict:
    from vln_bevbert_tpu_torch.nav.agent import gather_and_splat
    from vln_bevbert_tpu_torch.ops import bev as bev_mod
    from vln_bevbert_tpu_torch.ops.bev import BevProjector
    from vln_bevbert_tpu_torch.ops.splat import gather_rows, splat_sums, splat_sums_plain

    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = {  # (B, T, P, S, C, F, num_sem, feature dtype)
        "nav": (4, 15, 2352, 8, 441, 768, 0, torch.bfloat16),     # gather_and_splat
        # dp_replay's teacher rollout at B=8
        "nav_b8": (8, 15, 2352, 8, 441, 768, 0, torch.bfloat16),
        "pretrain": (16, 1, 2352, 1, 441, 768, 40, torch.float16),  # prepare_bev
        # dp_pretrain's one process at the two ranks' global batch
        "pretrain_b32": (32, 1, 2352, 1, 441, 768, 40, torch.float16),
        # the 11x11 CE map: a rollout step's gather_and_splat at B=8, and CE
        # pretraining's prepare_bev
        "ce_rollout": (8, 15, 2352, 8, 121, 768, 0, torch.bfloat16),
        "ce_pretrain": (16, 1, 2352, 1, 121, 768, 40, torch.float16),
        # a dp_ce rank's rollout step, 4 of the 8 rows (the one process's
        # is ce_rollout)
        "ce_rollout_b4": (4, 15, 2352, 8, 121, 768, 0, torch.bfloat16),
    }
    record = {"max_abs_err": 0.0}
    for label, (b, t, p, s, c, f, num_sem, dtype) in shapes.items():
        cell, store, kw = splat_case(g, b, t, p, s, c, f, num_sem, dtype)
        out, ref = splat_sums(cell, store, c, **kw), splat_sums_plain(cell, store, c, **kw)
        err = check_sums(label, out, ref, f)
        ms = cuda_ms(lambda: splat_sums(cell, store, c, **kw), iters=20)
        by_kernel = device_ms_by_kernel(lambda: splat_sums(cell, store, c, **kw))
        dev_ms = sum(by_kernel.values())
        part_us = {part: 1e3 * sum(v for k, v in by_kernel.items() if f"splat_{part}" in k)
                   for part in ("hist", "scatter", "reduce")}
        plain_ms = cuda_ms(lambda: splat_sums_plain(cell, store, c, **kw), iters=5)
        # the library calls on the payload the parent built (not timed here)
        rows = gather_rows(store, kw["step_sel"])
        cols = [rows.to(torch.bfloat16)]
        if num_sem:
            cols.append(torch.nn.functional.one_hot(kw["sem_labels"].long(), num_sem)
                        .to(torch.bfloat16))
        cols.append(torch.ones(b, s * p, 1, dtype=torch.bfloat16, device="cuda"))
        payload = torch.cat(cols, dim=-1)
        d = payload.shape[-1]
        valid = (cell >= 0) & (cell < c)
        dump = torch.arange(b, device="cuda")[:, None] * c + cell.long()
        index = torch.where(valid, dump, torch.full_like(dump, b * c)).reshape(-1)
        acc = torch.zeros(b * c + 1, d, device="cuda")
        source = payload.reshape(-1, d).float()
        index_add_ms = cuda_ms(lambda: acc.index_add_(0, index, source), iters=10)
        one_hot = (cell[:, None, :] == torch.arange(c, device="cuda", dtype=torch.int32)[:, None]
                   ).to(torch.bfloat16)  # (B, C, N)
        bmm_ms = cuda_ms(lambda: torch.bmm(one_hot, payload), iters=10)
        # bytes the function must move: cells, labels, each valid point's
        # feature row once, the step index, the (B, C, D) float32 sums
        n_valid = int(valid.sum())
        fixed = (cell.numel() * 4 + (cell.numel() * 4 if num_sem else 0)
                 + (kw["step_sel"].numel() * 4 if t > 1 else 0) + b * c * d * 4)
        bound = bound_ms(fixed + n_valid * f * store.element_size())
        bound_all = bound_ms(fixed + cell.numel() * f * store.element_size())
        # reference for random-row bandwidth: PyTorch's gather of the same
        # valid rows (it reads them and writes them once)
        flat = store.reshape(-1, f)
        row_ids = torch.arange(flat.shape[0], device="cuda").reshape(*store.shape[:-1], 1)
        valid_rows = gather_rows(row_ids, kw["step_sel"]).reshape(b, -1)[valid]
        gather_us = 1e3 * cuda_ms(lambda: flat.index_select(0, valid_rows), iters=20)
        del one_hot, payload, source, acc
        phase("kernel", shape=label, B=b, N=s * p, C=c, D=d, feats=str(dtype).split(".")[-1],
              valid_points=n_valid, max_abs_err=f"{err:.3e}", ms=f"{ms:.4f}",
              device_ms=f"{dev_ms:.4f}", bound_us=f"{1e3 * bound:.1f}",
              bound_share=f"{bound / dev_ms:.1%}", bound_all_points_us=f"{1e3 * bound_all:.1f}",
              bound_all_points_share=f"{bound_all / dev_ms:.1%}", plain_ms=f"{plain_ms:.4f}",
              index_add_ms=f"{index_add_ms:.4f}", onehot_bmm_ms=f"{bmm_ms:.4f}",
              **{f"{part}_us": f"{us:.2f}" for part, us in part_us.items()},
              index_select_valid_rows_us=f"{gather_us:.2f}",
              index_select_GBps=f"{2 * n_valid * f * store.element_size() / gather_us / 1e3:.0f}")
        record["max_abs_err"] = max(record["max_abs_err"], err)
        record[label] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                         "bound_ms": bound, "bound_all_points_ms": bound_all,
                         "library_ms": index_add_ms, "onehot_bmm_ms": bmm_ms,
                         "kernel_us": part_us, "index_select_us": gather_us}
        if label == "nav":
            record.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_us=1e3 * bound,
                          library_ms=index_add_ms, device_ms=dev_ms)

    # the navigation BEV step: fused, against the parent's composition (the
    # feature gather, the payload concat and the splat, by the plain pieces)
    b, t, p, s, c, f = 4, 15, 2352, 8, 441, 768
    proj = BevProjector(grid_hw=14, num_views=12, map_dim=21, map_res=0.5, device="cuda")
    pc = torch.randn(b, t, p, 3, generator=g, device="cuda") * 4.0
    valid_buf = torch.rand(b, t, p, generator=g, device="cuda") < 0.9
    feat_buf = torch.randn(b, t, p, f, generator=g, device="cuda").bfloat16()
    step_sel = torch.stack([torch.randperm(t, generator=g, device="cuda")[:s]
                            for _ in range(b)]).int()
    step_ok = torch.ones(b, s, dtype=torch.bool, device="cuda")
    step_ok[0, 5:] = False
    T_w2c = torch.eye(4, device="cuda").expand(b, 4, 4).contiguous()
    S_w2c = torch.zeros(b, 3, device="cuda")
    args = (proj, pc, valid_buf, feat_buf, step_sel, step_ok, T_w2c, S_w2c)
    fused = gather_and_splat(*args)
    fused_ms = device_ms(lambda: gather_and_splat(*args))
    bev_mod.splat_sums = splat_sums_plain
    try:
        parent = gather_and_splat(*args)
        parent_ms = device_ms(lambda: gather_and_splat(*args))
    finally:
        bev_mod.splat_sums = splat_sums
    torch.testing.assert_close(fused, parent, rtol=RTOL, atol=ATOL)
    phase("kernel", step="nav_bev", device_ms_fused=f"{fused_ms:.4f}",
          device_ms_parent_composition=f"{parent_ms:.4f}", speedup=f"{parent_ms / fused_ms:.2f}x")
    record.update(nav_bev_device_ms=fused_ms, nav_bev_parent_device_ms=parent_ms)

    # edges: an all-invalid row, cells out of range, a step_sel that repeats
    # a step, float32 features, zero depth (through the projector)
    cell, store, kw = splat_case(g, 3, 6, 700, 3, 441, 768, 0, torch.bfloat16)
    kw["step_sel"] = torch.tensor([[2, 2, 5], [0, 1, 0], [4, 4, 4]], dtype=torch.int32,
                                  device="cuda")
    cell[0] = -1
    cell[1, ::3] = 441 + 7
    out = splat_sums(cell, store, 441, **kw)
    if out[0].abs().max().item() != 0.0:
        raise AssertionError("edge: an all-invalid row must splat to zeros")
    err = check_sums("edge", out, splat_sums_plain(cell, store, 441, **kw), 768)
    cell, store, kw = splat_case(g, 2, 1, 3000, 1, 441, 768, 0, torch.float32)
    err = max(err, check_sums("edge f32", splat_sums(cell, store, 441, **kw),
                              splat_sums_plain(cell, store, 441, **kw), 768))
    record["max_abs_err"] = max(record["max_abs_err"], err)
    proj = BevProjector(grid_hw=14, num_views=12, map_dim=21, map_res=0.5, device="cuda")
    depths = torch.rand(2, 12, 14, 14, generator=g, device="cuda") * 4.0
    depths[0] = 0.0
    eye = torch.eye(4, device="cuda")
    T_c2w = eye.expand(2, 12, 4, 4).contiguous()
    T_w2c = eye.expand(2, 4, 4).contiguous()
    S_w2c = torch.zeros(2, 3, device="cuda")
    feats = torch.randn(2, 12 * 196, 768, generator=g, device="cuda")
    sem = torch.randint(0, 40, (2, 12 * 196), generator=g, device="cuda")
    args = (depths, T_c2w, T_w2c, S_w2c, feats, sem)
    ours = proj.lift_splat(*args)
    bev_mod.splat_sums = splat_sums_plain
    try:
        plain = proj.lift_splat(*args)
    finally:
        bev_mod.splat_sums = splat_sums
    if ours[1][0].any() or not ours[1][1].any():
        raise AssertionError("edge: zero depth must leave its row empty")
    torch.testing.assert_close(ours[0], plain[0], rtol=RTOL, atol=ATOL)
    for a, b in zip(ours[1:], plain[1:]):
        if not torch.equal(a, b):
            raise AssertionError("edge: occupancy / semantics differ from the plain version")
    phase("kernel", shape="edges", all_invalid_row="ok", out_of_range_cells="ok",
          repeated_step="ok", f32_feats="ok", zero_depth="ok",
          occupied_cells=int(ours[1][1].sum()))
    return record


def dropout_phase() -> dict:
    import math

    import torch.nn.functional as F

    from vln_bevbert_tpu_torch import _build
    from vln_bevbert_tpu_torch.ops.dropout import draw_seeds, dropout, dropout_ref

    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = {  # the pretraining step's largest sites: (shape, dtype, rate)
        "attn_probs": ((16, 12, 441, 441), torch.bfloat16, 0.1),
        # dp_pretrain's one process at the two ranks' global batch
        "attn_probs_b32": ((32, 12, 441, 441), torch.bfloat16, 0.1),
        "hidden": ((16, 200, 768), torch.bfloat16, 0.1),
        "feat": ((16, 441, 768), torch.float32, 0.4),
        # the replay update's: a step's BEV attention at B=4, the panorama
        # encoder over T*B = 60 step-rows of 44 view slots
        "ft_attn_probs": ((4, 12, 441, 441), torch.bfloat16, 0.1),
        "ft_pano_hidden": ((60, 44, 768), torch.bfloat16, 0.1),
        # dp_replay's one process at the two ranks' 8 rows (a rank's are
        # the two above: the bundle is padded to T = max_action_len = 15)
        "ft_attn_probs_b8": ((8, 12, 441, 441), torch.bfloat16, 0.1),
        "ft_pano_hidden_b8": ((120, 44, 768), torch.bfloat16, 0.1),
        # object pretraining's: the object features (B, T = 8 steps, 20
        # objects, 768), and the panorama encoder over B*T step-rows of
        # P = 44 views + 20 objects
        "obj_feat": ((16, 8, 20, 768), torch.float32, 0.4),
        "obj_pano_hidden": ((128, 64, 768), torch.bfloat16, 0.1),
        # CE's: pretraining's 11x11 BEV attention and BEV features at B=16,
        # the replay update's BEV attention at B=8 and its panorama encoder
        # over T*B = 120 step-rows of 44 slots
        "ce_attn_probs": ((16, 12, 121, 121), torch.bfloat16, 0.1),
        "ce_feat": ((16, 121, 768), torch.float32, 0.4),
        "ce_replay_attn_probs": ((8, 12, 121, 121), torch.bfloat16, 0.1),
        "ce_replay_pano_hidden": ((120, 44, 768), torch.bfloat16, 0.1),
        # dp_ce's float32 replay: a rank's 4 rows (T*b = 60 panorama rows)
        # and the one process's 8
        "dp_ce_attn_probs_b4": ((4, 12, 121, 121), torch.float32, 0.1),
        "dp_ce_pano_hidden_b4": ((60, 44, 768), torch.float32, 0.1),
        "dp_ce_attn_probs_b8": ((8, 12, 121, 121), torch.float32, 0.1),
        "dp_ce_pano_hidden_b8": ((120, 44, 768), torch.float32, 0.1),
        # the PREVALENT BPTT update's at B=8 and the language bucket L=32:
        # the embeddings and the 9 language layers' outputs and attention
        # probabilities, then per recurrent step the candidate embeddings
        # (float32 after visn_ln), and in each cross-modal layer over the
        # K+1 = 7 [state; vision] rows the cross-attention probabilities
        # into the L-1 language keys, the self-attention probabilities and
        # the cross, self and FFN outputs
        **PREVALENT_SITES,
        # the Critic's two sites (B=8, float32, rate 0.5): the state and
        # fc1's ReLU output
        **CRITIC_SITES,
    }
    # the timed calls cycle over copies of the input and keep as many
    # outputs alive, enough that the other calls move twice the L2 between
    # two uses of a block (a site that one copy keeps in L2 would be timed
    # cache-warm); at most DROPOUT_COPIES copies, so sites under ~1.6 MB
    # stay warm (they are bound by their launch)
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", H100_L2_BYTES)
    record = {"max_abs_err": 0.0, "sites": {}, "l2_bytes": l2}
    for label, (shape, dtype, rate) in shapes.items():
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        seeds = draw_seeds(shape[0], g, "cuda")
        y, ref = dropout(x, seeds, rate), dropout_ref(x, seeds, rate)
        if not torch.equal(y, ref):
            raise AssertionError(f"dropout {label}: kernel differs from the plain version")
        err = (y.float() - ref.float()).abs().max().item()
        keep = (y != 0).float().mean().item()
        sd = math.sqrt(rate * (1 - rate) / x.numel())
        if abs(keep - (1 - rate)) > 5 * sd:
            raise AssertionError(f"dropout {label}: P(keep) {keep} vs {1 - rate}")
        moved = 2 * x.numel() * x.element_size()
        n_copies = min(DROPOUT_COPIES, 2 + -(-2 * l2 // moved))
        # between two uses of a block the other calls move twice the L2
        cold = (n_copies - 1) * moved >= 2 * l2
        xs = [x] + [x.clone() for _ in range(n_copies - 1)]
        turn, outs = itertools.count(), collections.deque(maxlen=n_copies)

        def cycled(fn, xs=xs, turn=turn, outs=outs):
            return lambda: outs.append(fn(xs[next(turn) % len(xs)]))

        ms = cuda_ms(cycled(lambda v: dropout(v, seeds, rate)), iters=20)
        lib_ms = cuda_ms(cycled(lambda v: F.dropout(v, rate)), iters=20)
        plain_ms = cuda_ms(lambda: dropout_ref(x, seeds, rate), iters=3, warmup=1)
        dev_ms = device_ms(cycled(lambda v: dropout(v, seeds, rate)))
        lib_dev_ms = device_ms(cycled(lambda v: F.dropout(v, rate)))
        # the card's own copy of the same bytes (read once, written once)
        copy_dev_ms = device_ms(cycled(torch.clone))
        del xs, outs
        bound = bound_ms(moved + seeds.numel() * 4)
        row = {"ms": ms, "device_ms": dev_ms, "F_dropout_ms": lib_ms,
               "F_dropout_device_ms": lib_dev_ms, "F_dropout_ratio": dev_ms / lib_dev_ms,
               "copy_device_ms": copy_dev_ms,
               "plain_ms": plain_ms, "bound_ms": bound, "copies": n_copies,
               "cache": "cold" if cold else "warm"}
        extra = {}
        if label in ("hidden", "ft_pano_hidden", "obj_pano_hidden", "ce_replay_pano_hidden",
                     "prev_x_hidden"):
            row["host_us"] = host_us(lambda: dropout(x, seeds, rate))
            row["F_dropout_host_us"] = host_us(lambda: F.dropout(x, rate))
            extra = dict(host_us_per_launch=f"{row['host_us']:.2f}",
                         F_dropout_host_us=f"{row['F_dropout_host_us']:.2f}")
        phase("dropout", site=label, shape=tuple(shape), dtype=str(dtype).split(".")[-1],
              rate=rate, bitwise="equal", keep=f"{keep:.6f}", ms=f"{ms:.4f}",
              F_dropout_ms=f"{lib_ms:.4f}", device_ms=f"{dev_ms:.4f}",
              F_dropout_device_ms=f"{lib_dev_ms:.4f}",
              F_dropout_ratio=f"{row['F_dropout_ratio']:.3f}",
              copy_device_ms=f"{copy_dev_ms:.4f}", bound_us=f"{1e3 * bound:.1f}",
              bound_share=f"{bound / dev_ms:.1%}" if cold else "n/a", copies=n_copies,
              cache=row["cache"], plain_ms=f"{plain_ms:.4f}", **extra)
        record["max_abs_err"] = max(record["max_abs_err"], err)
        record["sites"][label] = row
        if label == "attn_probs":
            record.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_us=1e3 * bound,
                          library_ms=lib_ms, device_ms=dev_ms)

    # edges, forward and backward (the kernel on a fresh dy), one per access
    # path and its limits: rate 0 and a rate near 1; 16-byte accesses over
    # rows of 12 bf16 (half of them straddle two rows); 8-byte accesses
    # (rows of 588 bf16 in an odd count, a view 8 bytes in); single
    # elements (ragged rows, views one element in); one row; many short rows
    x = torch.randn(1, 1000, generator=g, device="cuda").bfloat16()
    one = draw_seeds(1, g, "cuda")
    if not torch.equal(dropout(x, one, 0.0), x):
        raise AssertionError("dropout edge: rate 0 must be the identity")
    base = torch.randn(4 + 6 * 40, generator=g, device="cuda")
    edges = {  # (x, rate)
        "rate0": (x, 0.0), "rate_near_1": (x, 0.999), "single_row": (x, 0.3),
        "short_rows_16B": (torch.randn(4096, 12, generator=g, device="cuda").bfloat16(), 0.5),
        "short_rows_f32": (torch.randn(3000, 8, generator=g, device="cuda"), 0.5),
        "odd_rows_8B": (torch.randn(3, 12, 7, 7, generator=g, device="cuda").bfloat16(), 0.1),
        "offset_8B": (base.bfloat16()[4:].view(6, 40), 0.2),
        "ragged_rows": (base[1:106].view(5, 3, 7).bfloat16().contiguous(), 0.3),
        "misaligned": (base[1:241].view(6, 40), 0.3),
        "misaligned_bf16": (base.bfloat16()[1:241].view(6, 40), 0.2),
    }
    for label, (t, rate) in edges.items():
        seeds = draw_seeds(t.shape[0], g, "cuda")
        leaf = t.detach().requires_grad_()
        y = dropout(leaf, seeds, rate)
        dy = torch.randn(t.shape, generator=g, device="cuda").to(t.dtype)
        y.backward(dy)
        if not (torch.equal(y, dropout_ref(t, seeds, rate))
                and torch.equal(leaf.grad, dropout_ref(dy, seeds, rate))):
            raise AssertionError(f"dropout edge {label}: kernel differs from the plain version")

    # autograd: the C++ backward relaunches the kernel on dy with the saved
    # seeds, and the C++ counter counts that launch
    x = torch.randn(16, 200, 768, generator=g, device="cuda").bfloat16().requires_grad_()
    seeds = draw_seeds(16, g, "cuda")
    packed = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: packed.append(t) or t,
                                                  lambda t: t):
        y = dropout(x, seeds, 0.1)
    if len(packed) != 1 or packed[0].data_ptr() != seeds.data_ptr():
        raise AssertionError(f"dropout: saved {len(packed)} tensors, expected the seeds only")
    dy = torch.randn_like(y)
    before = _build.launches("dropout")
    y.backward(dy)
    if _build.launches("dropout") != before + 1:
        raise AssertionError("dropout: the backward did not launch the kernel")
    # the kept elements, as the plain version draws them (x may hold zeros)
    kept = dropout_ref(torch.ones_like(dy), seeds, 0.1) != 0
    ref_grad = dropout_ref(dy, seeds, 0.1)
    if not (torch.equal(x.grad, ref_grad) and torch.equal(y != 0, kept & (x != 0))
            and torch.equal(x.grad != 0, kept & (dy != 0))):
        raise AssertionError(
            "dropout: the backward's mask differs from the forward's: "
            f"{int((x.grad != ref_grad).sum())} elements differ from the plain version, "
            f"{int((x.grad != 0).ne(kept & (dy != 0)).sum())} from the forward's mask")
    phase("dropout", edges=" ".join(edges), edges_forward_backward="bitwise",
          backward_mask="equal",
          saved="seeds only", backward_launch="counted")

    # the PREVALENT sites, backward: the kernel on dy with the saved seeds,
    # bitwise against the plain version, with the forward's mask
    for label, (shape, dtype, rate) in PREVALENT_SITES.items():
        x = torch.randn(shape, generator=g, device="cuda").to(dtype).requires_grad_()
        seeds = draw_seeds(shape[0], g, "cuda")
        y = dropout(x, seeds, rate)
        dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
        y.backward(dy)
        kept = dropout_ref(torch.ones_like(dy), seeds, rate) != 0
        if not (torch.equal(x.grad, dropout_ref(dy, seeds, rate))
                and torch.equal(x.grad != 0, kept & (dy != 0))):
            raise AssertionError(f"dropout {label}: the backward differs from the plain version")
    phase("dropout", prevalent_sites=",".join(PREVALENT_SITES), forward="bitwise",
          backward="bitwise")

    # the Critic module in training mode at full width: both of its sites
    # through the kernel, against its plain version on the seeds the
    # module draws (a copy of its generator)
    from vln_bevbert_tpu_torch.configs import ModelConfig
    from vln_bevbert_tpu_torch.models import Critic
    from vln_bevbert_tpu_torch.models.bert import init_params
    from vln_bevbert_tpu_torch.ops.dropout import set_dropout_generator

    cfg = ModelConfig(dtype="float32")
    critic = Critic(cfg, device="cuda").train()
    init_params(critic, torch.Generator(device="cuda").manual_seed(1))
    set_dropout_generator(critic, g)
    (b, width), _, rate = CRITIC_SITES["critic_state"]
    state = torch.randn(b, width, generator=g, device="cuda").requires_grad_()
    replay = torch.Generator(device="cuda")
    replay.set_state(g.get_state())
    before = _build.launches("dropout")
    value = critic(state)
    value.sum().backward()
    launches = _build.launches("dropout") - before
    with torch.no_grad():
        x = dropout_ref(state, draw_seeds(b, replay, "cuda"), rate)
        h = torch.relu(critic.fc1(x))
        want = critic.fc2(dropout_ref(h, draw_seeds(b, replay, "cuda"), rate))[..., 0]
    if not torch.equal(value.detach(), want) or launches != 4 or state.grad is None:
        raise AssertionError(f"dropout critic: {launches} launches, value differs from the "
                             f"plain version by {(value.detach() - want).abs().max().item()}")
    phase("dropout", critic_sites=",".join(CRITIC_SITES), module="Critic(train)",
          value="bitwise", launches=f"{launches} (2 forward + 2 backward)")
    return record


def seen_count(seen: dict, key: str):
    """A ``utils.graphs.CallCount`` whose value is ``seen[key]``: a call
    counted while a CUDA graph is captured counts once per replay of it,
    as the kernels' own launch counts count the replay's launches."""
    from vln_bevbert_tpu_torch.utils import graphs

    class SeenCount(graphs.CallCount):
        def __init__(self):
            seen.setdefault(key, 0)

        value = property(lambda self: seen[key], lambda self, v: seen.__setitem__(key, v))

    return SeenCount()


def counting_dropout(seen: dict):
    """A Dropout.forward that counts the kernel's forward and backward calls
    into ``seen`` (``seen_count``: per replay of a graph that captured them).
    A backward is counted when the gradient reaches the output, by a hook:
    the kernel's backward launches only where the loss depends on the output
    (the last recurrent step's last self-attention and FFN of PREVALENT feed
    nothing)."""
    from vln_bevbert_tpu_torch.ops import dropout as drop_mod

    forward = drop_mod.Dropout.forward
    fwd, bwd = seen_count(seen, "drop_fwd"), seen_count(seen, "drop_bwd")

    def counted(self, x):
        y = forward(self, x)
        if self.training and self.rate > 0 and x.dim() >= 2:
            fwd.add()
            if y.requires_grad:
                y.register_hook(lambda g: bwd.add())
        return y

    return forward, counted


@contextlib.contextmanager
def instrumented_training(trainer, seen: dict, timed_reduce: bool = False):
    """Instrument ``trainer`` (a ``PretrainTrainer``) for the block: the
    dropout calls, the ``prepare_bev`` calls of training (``seen["bev"]``)
    and of validation (``seen["val_bev"]``), the validations (step, seconds,
    results), the blocks (task, length) and every step: (task, CUDA events
    around it, its loss and gradient norm), from each graph replay, or, for
    a block that ran eagerly (under a gloo group), from the block as a
    whole: one step at ``task_block_size`` 1. With ``timed_reduce`` the
    eager steps' gradient all-reduces are timed (``seen["reduce"]``); a
    graph's are counted (``seen["reduces"]``)."""
    from vln_bevbert_tpu_torch.ops import dropout as drop_mod
    from vln_bevbert_tpu_torch.parallel import train_step as ts_mod
    from vln_bevbert_tpu_torch.utils import graphs

    seen.update(bev=0, val_bev=0, steps=[], blocks=[], validations=[], reduce=[], reduces=0,
                in_val=False)
    forward, counted_forward = counting_dropout(seen)
    train_bev, val_bev, reduces = (seen_count(seen, k) for k in ("bev", "val_bev", "reduces"))
    prepare, reduce, replay = ts_mod.prepare_bev, ts_mod.TrainState.all_reduce_grads, \
        graphs.Graph.replay
    block_fn, validate = trainer.block_fn, trainer.validate

    def counted_prepare(projector, batch):
        if "depths" in batch:
            (val_bev if seen["in_val"] else train_bev).add()
        return prepare(projector, batch)

    def events():
        return [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed_replay(graph):
        start, end = events()
        start.record()
        out = replay(graph)
        end.record()
        if isinstance(out, dict) and "grad_norm" in out:  # a pretraining step
            seen["steps"].append((graph.key[0], start, end,
                                  {"loss": out["loss"].clone(),
                                   "grad_norm": out["grad_norm"].clone()}))
        return out

    def counted_block(state, batch, task, length, stacked=False):
        seen["blocks"].append((task, length))
        n, (start, end) = len(seen["steps"]), events()
        start.record()
        metrics = block_fn(state, batch, task, length, stacked)
        end.record()
        if len(seen["steps"]) == n:  # no replay: the block ran eager steps
            seen["steps"].append((task, start, end, metrics))
        return metrics

    def counted_reduce(state):
        reduces.add()
        if timed_reduce and not torch.cuda.is_current_stream_capturing():
            start, end = events()
            start.record()
            reduce(state)
            end.record()
            seen["reduce"].append((start, end))
        else:
            reduce(state)

    def timed_validate(step, num_batches=8):
        torch.cuda.synchronize()
        seen["in_val"], t0 = True, time.perf_counter()
        try:
            results = validate(step, num_batches)
        finally:
            seen["in_val"] = False
        seen["validations"].append((step, time.perf_counter() - t0, results))
        return results

    drop_mod.Dropout.forward, ts_mod.prepare_bev = counted_forward, counted_prepare
    ts_mod.TrainState.all_reduce_grads, graphs.Graph.replay = counted_reduce, timed_replay
    trainer.block_fn, trainer.validate = counted_block, timed_validate
    try:
        yield seen
    finally:
        drop_mod.Dropout.forward, ts_mod.prepare_bev = forward, prepare
        ts_mod.TrainState.all_reduce_grads, graphs.Graph.replay = reduce, replay
        trainer.block_fn, trainer.validate = block_fn, validate


def crossings(blocks, every: int) -> list:
    """The end steps of ``blocks`` ((task, length) in order) that crossed a
    multiple of ``every``: where the trainer validates and saves."""
    out, step = [], 0
    for _, length in blocks:
        if every and (step + length) // every > step // every:
            out.append(step + length)
        step += length
    return out


def counted_gathers(seen: dict, module):
    """(``module.gather_and_splat``, a stand-in that counts its calls into
    ``seen["gathers"]``); ``module`` is the agent module that calls it."""
    gather = module.gather_and_splat

    def counted(*args):
        seen["gathers"] += 1
        return gather(*args)

    return gather, counted


def run_lengths(items):
    """[(item, length of its run)] of consecutive equal items."""
    out = []
    for item in items:
        if out and out[-1][0] == item:
            out[-1][1] += 1
        else:
            out.append([item, 1])
    return out


def val_prepare_calls(cfg, num_batches: int = 8) -> int:
    """``prepare_bev`` calls of one ``validate``: each task's batches, and
    for sem/masksem each batch's ``sem_predictions`` too."""
    bases = [t.split("_")[0] for t in cfg.tasks]
    return num_batches * (len(bases) + sum(b in ("sem", "masksem") for b in bases))


def run_trainer(trainer, label: str, min_each: int, build_s: float) -> dict:
    """Train ``trainer`` to its configured step count, instrumented
    (``instrumented_training``): in blocks of ``task_block_size`` (8), each
    step a replay of the step's CUDA graph. The kernels' launch counts
    against the dropout calls (forward and backward) and the ``prepare_bev``
    calls of training and of the validations after every block that crossed
    ``valid_steps`` (``val_prepare_calls`` each, no dropout): a replay
    counts the calls its capture made, a capture's warm-up its own; CUDA
    events around every replay; then save its checkpoint. Every task of the
    mix must run ``min_each`` steps."""
    from vln_bevbert_tpu_torch import _build

    cfg = trainer.cfg
    steps = cfg.optim.num_train_steps
    graphs = trainer.block_fn.graphs
    before = graphs.counters()
    with instrumented_training(trainer, {}) as seen:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        meters = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"dropout": _build.launches("dropout"), "splat": _build.launches("splat")}
    after = graphs.counters()
    captures, replays = after["captures"] - before["captures"], after["replays"] - before["replays"]
    peak = torch.cuda.max_memory_allocated()
    ckpt = trainer.save(trainer.state.step)
    n_params = sum(p.numel() for p in trainer.state.params)

    schedule = [t for t, *_ in seen["steps"]]
    mix = {t.split("_")[0]: r for t, r in zip(cfg.tasks, cfg.mix_ratio)}
    if len(schedule) != steps or any(schedule.count(t) < min_each for t in mix):
        raise AssertionError(f"{label}: ran {schedule}; every task of {sorted(mix)} needs "
                             f"{min_each} of {steps} steps")
    blocks = seen["blocks"]
    if (cfg.task_block_size < 2 or replays != steps or sum(k for _, k in blocks) != steps
            or any(k > cfg.task_block_size for _, k in blocks)):
        raise AssertionError(f"{label}: {replays} graph replays in blocks {blocks} of "
                             f"{steps} steps")
    n_val = len(crossings(blocks, cfg.valid_steps))
    if [v[0] for v in seen["validations"]] != crossings(blocks, cfg.valid_steps):
        raise AssertionError(f"{label}: validated at {[v[0] for v in seen['validations']]}")
    if (launches["splat"] != seen["bev"] + seen["val_bev"] or seen["bev"] != steps + captures
            or seen["val_bev"] != n_val * val_prepare_calls(cfg)):
        raise AssertionError(f"{label}: {launches['splat']} splat launches for "
                             f"{seen['bev']} training and {seen['val_bev']} validation "
                             f"prepare_bev calls in {steps} replays and {captures} warm-ups")
    for _, _, results in seen["validations"]:
        check_validation(label, results)
    if launches["dropout"] != seen["drop_fwd"] + seen["drop_bwd"] or seen["drop_bwd"] == 0:
        raise AssertionError(
            f"{label}: {launches['dropout']} dropout launches for {seen['drop_fwd']} "
            f"forward and {seen['drop_bwd']} backward dropout calls")
    values = torch.stack([torch.stack([m["loss"], m["grad_norm"]]) for *_, m in seen["steps"]])
    if not torch.isfinite(values).all() or not (values[:, 1] > 0).all():
        raise AssertionError(f"{label}: non-finite or zero loss / grad_norm {values.tolist()}")
    per_task, first = {}, set()
    for task, start, end, _ in seen["steps"]:
        if task in first:
            per_task.setdefault(task, []).append(start.elapsed_time(end))
        first.add(task)
    ms_per_task = {t: sum(v) / len(v) for t, v in per_task.items()}
    # the configured traffic: mean ms/step weighted by the task mix
    mix_ms = sum(mix[t] * ms_per_task[t] for t in mix) / sum(mix.values())
    return {
        "ckpt": ckpt, "pretrain_names": set(trainer.model.state_dict()),
        "seed": cfg.seed, "steps": steps, "schedule": schedule, "launches": launches,
        "drop_fwd": seen["drop_fwd"], "drop_bwd": seen["drop_bwd"], "bev": seen["bev"],
        "blocks": blocks, "captures": captures, "replays": replays,
        "capture_s": (after["capture_ms"] - before["capture_ms"]) / 1e3,
        "ms_per_task": ms_per_task, "mix": mix,
        "samples_per_s": cfg.train_batch_size * 1e3 / mix_ms,
        "wall_samples_per_s": cfg.train_batch_size * steps / wall,
        "wall_s": wall, "build_s": build_s,
        "peak_bytes": peak, "n_params": n_params, "meters": meters,
        "validations": seen["validations"], "val_bev": seen["val_bev"],
        "first_ms": {t: next(s.elapsed_time(e) for tt, s, e, _ in seen["steps"] if tt == t)
                     for t in per_task},
    }


def block_fields(run: dict) -> dict:
    """A trained path's blocks, graphs and launches against its calls, for
    its printed line."""
    return {"blocks": ",".join(f"{t}x{k}" for t, k in run["blocks"]),
            "graphs_captured": run["captures"], "capture_s": f"{run['capture_s']:.2f}",
            "replays": run["replays"],
            "splat_launches_vs_calls": f"{run['launches']['splat']}={run['replays']}replays+"
                                       f"{run['captures']}warm-ups+{run['val_bev']}validation",
            "dropout_launches_vs_calls": f"{run['launches']['dropout']}="
                                         f"{run['drop_fwd']}fwd+{run['drop_bwd']}bwd"}


def train_phase(out_dir: str, steps: int = 24, seed: int = 16, min_each: int = 3) -> dict:
    """Run the CLI's synthetic pretraining at full width, instrumented, and
    save its checkpoint into ``out_dir`` as the CLI does. ``seed`` 16
    schedules every task at least ``min_each`` times in the first 24 steps
    (the MetaLoader draws tasks in blocks of 8)."""
    from vln_bevbert_tpu_torch.cli import pretrain

    t0 = time.perf_counter()
    trainer = pretrain.build(pretrain.parse_args([
        "--synthetic", "--device", "cuda", "--num_steps", str(steps),
        "--batch_size", "16", "--seed", str(seed), "--output_dir", out_dir]))
    run = run_trainer(trainer, "train", min_each, time.perf_counter() - t0)
    run["traced"] = traced_block(trainer, run["schedule"][-1], os.path.join(out_dir, "trace"))
    return run


def pretrain_block_batches(trainer, task: str, k: int = 8, offset: int = 0) -> list:
    """``k`` host batches of ``task`` from ``trainer``'s loader, padded to
    the block's largest shape as the trainer pads them."""
    from vln_bevbert_tpu_torch.pretrain.trainer import pad_block

    return pad_block([trainer.train_loader.build_batch(offset + i, task=task)[1]
                      for i in range(k)])


def traced_block(trainer, task: str, log_dir: str, k: int = 8) -> dict:
    """One more block of ``k`` steps of ``task``, after one untraced block
    over the same batches (any capture lies outside the trace), under
    ``traced_busy``: wall ms and the device's busy share; then one more,
    its device ms by kernel: the dropout kernel's and its share."""
    batches = pretrain_block_batches(trainer, task, k)
    block = lambda: trainer.block_fn(trainer.state, batches, task, k, stacked=True)  # noqa: E731
    block()
    _, busy = traced_busy(block, "block", log_dir)
    return {"task": task, "k": k, **busy, **dropout_device_share(block)}


# Graphed against eager from one state: each step's loss within
# BLOCK_LOSS_RTOL; the parameters' L2 difference within BLOCK_PARAM_REL_L2 of
# their norm and within BLOCK_MOVE_REL_L2 of the eager run's movement from the
# start, which must be non-zero. A block moves the parameters by ~1e-4 of
# their norm at pretraining's warm-up, so the first bound alone would pass a
# graph that froze the learning rate at its capture value or dropped the
# update; the second fails it (a difference of the movement's order).
BLOCK_LOSS_RTOL, BLOCK_PARAM_REL_L2, BLOCK_MOVE_REL_L2 = 1e-3, 1e-9, 1e-4


@torch.no_grad()
def params_agreement(graphed, eager, start) -> dict:
    """The L2 difference of two parameter lists that ran from ``start``,
    relative to the parameters' norm (``params_rel_l2``) and to the eager
    run's movement from ``start`` (``move_rel_l2``, inf if it did not move),
    and that movement relative to the norm (``moved_rel``)."""
    sq = lambda xs, ys: sum(float((x.float() - y.float()).pow(2).sum())  # noqa: E731
                            for x, y in zip(xs, ys))
    diff, moved = sq(graphed, eager) ** 0.5, sq(eager, start) ** 0.5
    norm = sum(float(y.float().pow(2).sum()) for y in eager) ** 0.5
    return {"params_rel_l2": diff / norm, "moved_rel": moved / norm,
            "move_rel_l2": diff / moved if moved else float("inf")}


def check_agreement(label: str, loss_rel: list, agree: dict) -> None:
    if (max(loss_rel) > BLOCK_LOSS_RTOL or agree["params_rel_l2"] > BLOCK_PARAM_REL_L2
            or agree["move_rel_l2"] > BLOCK_MOVE_REL_L2):
        raise AssertionError(
            f"{label}: losses differ by {loss_rel} (rtol {BLOCK_LOSS_RTOL}), parameters by "
            f"{agree['params_rel_l2']:.3e} of their norm ({BLOCK_PARAM_REL_L2}) and "
            f"{agree['move_rel_l2']:.3e} of the eager movement ({BLOCK_MOVE_REL_L2}), "
            f"which is {agree['moved_rel']:.3e} of their norm")


def arms(fns: dict) -> dict:
    """Wall seconds of each of ``fns`` "eager" and "graphed" (ending in a
    synchronise), in turns eager / graphed / graphed / eager: {name:
    [seconds, ...]}."""
    out = {}
    for name in ("eager", "graphed", "graphed", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns[name]()
        torch.cuda.synchronize()
        out.setdefault(name, []).append(time.perf_counter() - t0)
    return out


def agreement_fields(run: dict) -> dict:
    """A block phase's parameter agreement and its bounds, for its line."""
    return {"params_rel_l2": f"{run['params_rel_l2']:.3e}", "params_bound": BLOCK_PARAM_REL_L2,
            "move_rel_l2": f"{run['move_rel_l2']:.3e}", "move_bound": BLOCK_MOVE_REL_L2,
            "moved_rel": f"{run['moved_rel']:.3e}"}


def block_phase(out_dir: str, k: int = 8) -> dict:
    """From one state (two trainers of the CLI's full-width synthetic
    pretraining, B=16, seed 16, over one loader: the same parameters and
    dropout generator), one ``k``-step block of each task graphed (replays of a
    CUDA graph of the step) and the same steps eagerly (``make_pretrain_step``): equal
    generator states afterwards (the same seeds drawn), every step's loss
    within ``BLOCK_LOSS_RTOL``, the parameters as ``check_agreement``
    holds them; a cached block launches each kernel as often as the same
    steps run eagerly (counted on the device). Then wall ms per step in arms eager /
    graphed / graphed / eager over the same blocks, and one graphed and one
    eager block traced: the device's busy share."""
    from vln_bevbert_tpu_torch import _build
    from vln_bevbert_tpu_torch.cli import pretrain
    from vln_bevbert_tpu_torch.parallel.train_step import (
        dropout_generators,
        make_pretrain_step,
        upload,
    )
    from vln_bevbert_tpu_torch.pretrain.trainer import PretrainTrainer
    from vln_bevbert_tpu_torch.utils import graphs

    eager = pretrain.build(pretrain.parse_args([
        "--synthetic", "--device", "cuda", "--batch_size", "16", "--seed", "16",
        "--output_dir", os.path.join(out_dir, "eager")]))
    graphed = PretrainTrainer(eager.cfg, eager.train_loader, "cuda",
                              output_dir=os.path.join(out_dir, "graphed"))
    device = torch.device("cuda")
    step_fn = make_pretrain_step(eager.model, eager.projector)
    tasks = [t.split("_")[0] for t in eager.cfg.tasks]
    blocks = {t: pretrain_block_batches(eager, t, k, offset=10 * i) for i, t in enumerate(tasks)}
    losses, replay = [], graphs.Graph.replay
    start = [p.detach().clone() for p in eager.state.params]

    def recorded(graph):
        out = replay(graph)
        losses.append(out["loss"].clone())
        return out

    want = []
    graphs.Graph.replay = recorded
    try:
        for task, batches in blocks.items():
            for b in batches:
                want.append(step_fn(eager.state, upload(b, device), task)["loss"])
            graphed.block_fn(graphed.state, batches, task, k, stacked=True)
    finally:
        graphs.Graph.replay = replay
    gen = lambda t: dropout_generators(t.model)[0].get_state()  # noqa: E731
    if not torch.equal(gen(eager), gen(graphed)):
        raise AssertionError("block: the graphed and eager runs drew other dropout seeds")
    got, want = torch.stack(losses), torch.stack(want)
    loss_rel = ((got - want).abs() / want.abs()).tolist()
    agree = params_agreement(graphed.state.params, eager.state.params, start)
    del start
    check_agreement("block", loss_rel, agree)
    cache = graphed.block_fn.graphs

    def run_eager():
        for task, batches in blocks.items():
            for b in batches:
                step_fn(eager.state, upload(b, device), task)

    def run_graphed():
        for task, batches in blocks.items():
            graphed.block_fn(graphed.state, batches, task, k, stacked=True)

    counted = {}
    for arm, run in (("graphed", run_graphed), ("eager", run_eager)):
        _build.reset_launches()
        run()
        counted[arm] = {n: _build.launches(n) for n in ("splat", "dropout")}
    launches = counted["graphed"]
    if (launches != counted["eager"] or launches["splat"] != k * len(tasks)
            or cache.captures != len(tasks)):
        raise AssertionError(f"block: a cached block launched {launches}, the same steps "
                             f"eagerly {counted['eager']}; {cache.captures} captures")

    timed = arms({"eager": run_eager, "graphed": run_graphed})
    n = k * len(tasks)
    task = tasks[0]
    _, busy_graphed = traced_busy(lambda: graphed.block_fn(graphed.state, blocks[task], task, k,
                                                           stacked=True),
                                  "graphed block", os.path.join(out_dir, "trace"))
    _, busy_eager = traced_busy(lambda: [step_fn(eager.state, upload(b, device), task)
                                         for b in blocks[task]],
                                "eager block", os.path.join(out_dir, "trace"))
    return {"k": k, "tasks": tasks, "loss_rel": loss_rel, **agree,
            "captures": cache.captures, "capture_s": cache.capture_ms / 1e3,
            "launches": launches, "eager_launches": counted["eager"],
            "ms_per_step": {a: [1e3 * t / n for t in v] for a, v in timed.items()},
            "busy_graphed": busy_graphed, "busy_eager": busy_eager, "busy_task": task,
            "samples_per_s": {a: 16 * n / min(v) for a, v in timed.items()}}


def replay_bundle(out_dir: str, batch: int = 4):
    """(config, bundle): a teacher rollout of the full-width fine-tuning
    agent (``cli.finetune --synthetic --batch_size <batch>``) packed as the
    replay bundle it trains from; its splat launches equal its
    gather-and-splat calls."""
    from vln_bevbert_tpu_torch import _build
    from vln_bevbert_tpu_torch.cli import finetune
    from vln_bevbert_tpu_torch.nav import agent as agent_mod
    from vln_bevbert_tpu_torch.nav.recollection import agent_build_bundle

    cfg, _, _, agent = finetune.build(finetune.parse_args([
        "--synthetic", "--device", "cuda", "--batch_size", str(batch), "--output_dir",
        os.path.join(out_dir, "teacher")]))
    teacher = {"gathers": 0}
    gather, counted_gather = counted_gathers(teacher, agent_mod)
    agent_mod.gather_and_splat = counted_gather
    try:
        _build.reset_launches()
        with torch.no_grad():
            _, lang, records = agent._rollout("teacher", True)
        teacher["launches"] = _build.launches("splat")
    finally:
        agent_mod.gather_and_splat = gather
    if teacher["launches"] != teacher["gathers"] or teacher["gathers"] == 0:
        raise AssertionError(f"teacher rollout: {teacher['launches']} splat launches for "
                             f"{teacher['gathers']} gather-and-splat calls")
    return cfg, agent_build_bundle(agent, lang, records), teacher


def nav_block_phase(out_dir: str, length: int = 4) -> dict:
    """``make_replay_block`` at ``FinetuneConfig()``'s full width, B=4, over
    a teacher rollout's bundle: two agents from one seed (the same
    parameters and dropout generator), ``length`` replay updates graphed
    against the same updates eagerly (``block.eager``): equal generator
    states, every loss within ``BLOCK_LOSS_RTOL``, the parameters as
    ``check_agreement`` holds them; a cached block's dropout launches
    (counted on the device) equal the eager updates' dropout calls, forward
    and backward, and the splat launches none. Wall ms per update in arms
    eager / graphed / graphed / eager; the graphed block traced once: the
    device's busy share."""
    from vln_bevbert_tpu_torch import _build
    from vln_bevbert_tpu_torch.nav.agent import make_replay_agent, make_replay_block
    from vln_bevbert_tpu_torch.parallel.train_step import dropout_generators

    cfg, rb, teacher = replay_bundle(out_dir)
    free_memory()
    eager, graphed = (make_replay_agent(cfg, 4, seed=cfg.seed, device="cuda") for _ in range(2))
    replay_e, replay_g = make_replay_block(eager, length), make_replay_block(graphed, length)
    seen = {}
    forward, counted = counting_dropout(seen)
    from vln_bevbert_tpu_torch.ops import dropout as drop_mod

    drop_mod.Dropout.forward = counted
    start = [p.detach().clone() for p in eager.train_state.params]
    try:
        want = replay_e.eager(rb)
        eager_calls = seen["drop_fwd"] + seen["drop_bwd"]
        got = replay_g(rb)
    finally:
        drop_mod.Dropout.forward = forward
    gen = lambda a: dropout_generators(a.model)[0].get_state()  # noqa: E731
    if not torch.equal(gen(eager), gen(graphed)):
        raise AssertionError("replay_block: the graphed and eager updates drew other seeds")
    loss_rel = ((got - want).abs() / want.abs()).tolist()
    agree = params_agreement(graphed.train_state.params, eager.train_state.params, start)
    del start
    check_agreement("replay_block", loss_rel, agree)
    _build.reset_launches()
    replay_g(rb)
    launches = {n: _build.launches(n) for n in ("splat", "dropout")}
    if (launches["splat"], launches["dropout"]) != (0, eager_calls) or eager_calls == 0 or (
            replay_g.graphs.captures != 1):
        raise AssertionError(f"replay_block: a cached block launched {launches}; the eager "
                             f"updates made {eager_calls} dropout calls in {length} updates; "
                             f"{replay_g.graphs.captures} captures")
    timed = arms({"eager": lambda: replay_e.eager(rb), "graphed": lambda: replay_g(rb)})
    _, busy = traced_busy(lambda: replay_g(rb), "graphed replay block",
                          os.path.join(out_dir, "trace"))
    drop = dropout_device_share(lambda: replay_g(rb))
    steps = int((rb["targets"] != -100).any(axis=1).sum())
    return {"length": length, "loss_rel": loss_rel, **agree,
            "launches": launches, "eager_calls": eager_calls,
            "capture_s": replay_g.graphs.capture_ms / 1e3, "teacher": teacher, "steps": steps,
            "T": rb["targets"].shape[0],
            "ms_per_update": {a: [1e3 * t / length for t in v] for a, v in timed.items()},
            "busy": busy, "dropout": drop}


def check_validation(label: str, results: dict) -> None:
    """Every validation metric finite; the semantic macro AUC and F1 in [0, 1]."""
    if not results or not all(v == v and abs(v) != float("inf") for v in results.values()):
        raise AssertionError(f"{label}: validation gave {results}")
    for key, val in results.items():
        if key.endswith(("auc_macro", "f1_macro")) and not 0.0 <= val <= 1.0:
            raise AssertionError(f"{label}: {key}={val} outside [0, 1]")


def validate_phase(ckpt: str, out_dir: str, step: int = 24, num_batches: int = 8) -> dict:
    """Validation at full width: the CLI's trainer at ``PretrainConfig()``
    defaults (B=16; mlm, sap, masksem) restored from ``train``'s checkpoint,
    then ``validate(24, num_batches=8)`` over val_unseen (the synthetic
    world, as the CLI reads it). Splat launches must equal the
    ``prepare_bev`` calls (24 ``eval_step`` + 8 ``sem_predictions``), the
    dropout must launch 0 times and its generator keep its state; CUDA
    events around each ``eval_step`` and ``sem_predictions``."""
    from vln_bevbert_tpu_torch import _build
    from vln_bevbert_tpu_torch.cli import pretrain
    from vln_bevbert_tpu_torch.parallel import train_step as ts_mod

    trainer = pretrain.build(pretrain.parse_args([
        "--synthetic", "--device", "cuda", "--batch_size", "16", "--seed", "16",
        "--resume", ckpt, "--output_dir", out_dir]))
    seen = {"bev": 0, "eval": {}, "sem": []}
    prepare, eval_step, sem_pred = ts_mod.prepare_bev, trainer.eval_step, trainer.sem_predictions

    def counted_prepare(projector, batch):
        seen["bev"] += "depths" in batch
        return prepare(projector, batch)

    def timed(fn, record):
        def call(batch, task):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(batch, task)
            end.record()
            record(task).append((start, end))
            return out
        return call

    ts_mod.prepare_bev = counted_prepare
    trainer.eval_step = timed(eval_step, lambda t: seen["eval"].setdefault(t, []))
    trainer.sem_predictions = timed(sem_pred, lambda t: seen["sem"])
    gen = trainer.model.feat_dropout.generator
    gen_state = gen.get_state()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        results = trainer.validate(step, num_batches=num_batches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"splat": _build.launches("splat"), "dropout": _build.launches("dropout")}
    finally:
        ts_mod.prepare_bev = prepare
    peak = torch.cuda.max_memory_allocated()
    calls = val_prepare_calls(trainer.cfg, num_batches)
    if launches["splat"] != seen["bev"] or seen["bev"] != calls:
        raise AssertionError(f"validate: {launches['splat']} splat launches for {seen['bev']} "
                             f"prepare_bev calls, expected {calls}")
    if launches["dropout"] != 0 or not torch.equal(gen.get_state(), gen_state):
        raise AssertionError(f"validate: {launches['dropout']} dropout launches, generator "
                             f"state changed: {not torch.equal(gen.get_state(), gen_state)}")
    if not trainer.model.training:
        raise AssertionError("validate: the model was left in eval mode")
    check_validation("validate", results)
    if "val_unseen/sem/auc_macro" not in results:
        raise AssertionError(f"validate: no semantic AUC in {sorted(results)}")
    ms = {t: sum(s.elapsed_time(e) for s, e in ev[1:]) / len(ev[1:])
          for t, ev in seen["eval"].items()}
    sem_ms = sum(s.elapsed_time(e) for s, e in seen["sem"][1:]) / len(seen["sem"][1:])
    return {"results": results, "launches": launches, "bev": seen["bev"], "wall_s": wall,
            "ms_per_eval_batch": ms, "ms_per_sem_batch": sem_ms, "peak_bytes": peak,
            "n_params": sum(p.numel() for p in trainer.model.parameters())}


OPTIMIZERS = ("radam", "lamb", "ralamb", "rangerlars", "adam", "adamax", "adamw+ema",
              "adamw+lookahead", "ralamb+lookahead")
# a constant learning rate at which 7 updates move every float32 parameter
# that has a gradient (the config's 10000-step warmup gives 3.5e-8 at the 7th
# update, below half a unit in the last place of a LayerNorm scale of 1)
LR_CHECK = 1e-3


def update_bytes(state, syncs: int, calls: int) -> float:
    """Bytes an update call must move, averaged over ``calls``: the gradients
    read once, the parameters and every state tensor read and written once,
    a lookahead's slow copy only at its ``syncs``."""
    tx = state.tx
    n = sum(p.numel() for p in state.params)
    total = 3 * 4 * n * calls  # gradients, parameters in and out
    for key, bufs in tx.buffers().items():
        moved = 2 * sum(b.numel() * b.element_size() for b in bufs)
        total += moved * (syncs if key.startswith("lookahead") else calls)
    return total / calls


def optim_phase(ckpt: str, out_dir: str, updates: int = 7, task: str = "sap") -> dict:
    """The optimizer family at full width: from ``train``'s checkpoint, adamw
    and each optimizer of ``OPTIMIZERS`` take 7 updates (lookahead syncs at the 6th)
    of B=16 ``sap`` steps, then adamw with ``gradient_accumulation_steps``
    2 takes 14 steps, whose odd steps must leave every parameter as it was,
    all at a constant learning rate ``LR_CHECK``. Losses and gradient norms
    finite; every parameter that got a nonzero gradient moved. CUDA events
    around each update alone."""
    import dataclasses

    from vln_bevbert_tpu_torch import _build
    from vln_bevbert_tpu_torch.cli import pretrain
    from vln_bevbert_tpu_torch.parallel.train_step import (
        TrainState,
        make_pretrain_step,
        upload,
    )

    trainer = pretrain.build(pretrain.parse_args([
        "--synthetic", "--device", "cuda", "--batch_size", "16", "--seed", "16",
        "--resume", ckpt, "--output_dir", out_dir]))
    model, device = trainer.model, trainer.device
    step_fn = make_pretrain_step(model, trainer.projector)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    batches = [upload(trainer.train_loader.build_batch(i, task=task)[1], device)
               for i in range(2 * updates)]
    runs = [(name, 1, updates) for name in ("adamw",) + OPTIMIZERS] + [("adamw", 2, 2 * updates)]
    out, total_launches = {}, {"splat": 0, "dropout": 0}
    for name, k, calls in runs:
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(start[n])
        cfg = dataclasses.replace(trainer.cfg.optim, optim=name, gradient_accumulation_steps=k,
                                  lr_schedule="constant", learning_rate=LR_CHECK)
        free_memory()  # the previous optimizer's state (its timed update is a cycle)
        torch.cuda.reset_peak_memory_stats()
        state = TrainState(model, cfg)
        update, events, nonzero = state.tx.update, [], torch.zeros(
            len(state.params), dtype=torch.bool, device=device)

        def timed_update(grads, moves=None, update=update, events=events, nonzero=nonzero):
            nonzero |= torch.stack(torch._foreach_norm(grads)) > 0
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            moved = update(grads, moves)
            t1.record()
            events.append((t0, t1, moved))
            return moved

        state.tx.update = timed_update
        metrics, unchanged = [], []
        _build.reset_launches()
        for i in range(calls):
            before = ([p.detach().clone() for p in state.params] if (i + 1) % k else None)
            metrics.append(step_fn(state, batches[i], task))
            if before is not None:
                unchanged.append(all(torch.equal(a, b) for a, b in zip(before, state.params)))
                del before
        torch.cuda.synchronize()
        for key in total_launches:
            total_launches[key] += _build.launches(key)
        values = torch.stack([torch.stack([m["loss"], m["grad_norm"]]) for m in metrics])
        label = f"{name}x{k}" if k > 1 else name
        if not torch.isfinite(values).all():
            raise AssertionError(f"optim {label}: loss / grad_norm {values.tolist()}")
        if not all(unchanged) or len(unchanged) != calls - calls // k:
            raise AssertionError(f"optim {label}: parameters moved on an accumulating step")
        if state.tx.count != updates or state.step != calls:
            raise AssertionError(f"optim {label}: {state.tx.count} updates in {state.step} steps")
        still = [n for (n, p), nz in zip(model.named_parameters(), nonzero.tolist())
                 if nz and torch.equal(p.detach(), start[n])]
        if still:
            raise AssertionError(f"optim {label}: {len(still)} parameters with a gradient did "
                                 f"not move: {still[:3]}")
        upd_ms = [a.elapsed_time(b) for a, b, moved in events if moved]
        acc_ms = [a.elapsed_time(b) for a, b, moved in events if not moved]
        syncs = calls // k // 6 if ("lookahead" in name or name == "rangerlars") else 0
        n_bytes = update_bytes(state, syncs, updates)
        out[label] = {"update_ms": sum(upd_ms) / len(upd_ms),
                      "first_update_ms": upd_ms[0],
                      "accumulate_ms": sum(acc_ms) / len(acc_ms) if acc_ms else None,
                      "bound_ms": bound_ms(n_bytes), "state_bytes": n_bytes,
                      "peak_bytes": torch.cuda.max_memory_allocated(),
                      "loss": values[:, 0].tolist(), "grad_norm": values[:, 1].tolist()}
        del state, update, timed_update
    return {"runs": out, "launches": total_launches, "updates": updates, "task": task}


def config_train_phase(label: str, config: str, out_dir: str, steps: int, seed: int,
                       valid_steps: int, min_each: int) -> dict:
    """Pretraining through the CLI at ``config``'s widths and mix
    (``cli.pretrain --synthetic --config <config + valid_steps>``), so that
    validation and its checkpoint run twice, instrumented as ``train`` is."""
    from vln_bevbert_tpu_torch.cli import pretrain

    t0 = time.perf_counter()
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), config)) as f:
        merged = {**json.load(f), "valid_steps": valid_steps}
    path = out_dir + "_config.json"
    with open(path, "w") as f:
        json.dump(merged, f)
    trainer = pretrain.build(pretrain.parse_args([
        "--synthetic", "--device", "cuda", "--config", path, "--num_steps", str(steps),
        "--seed", str(seed), "--output_dir", out_dir]))
    return run_trainer(trainer, label, min_each, time.perf_counter() - t0)


REVERIE_PRETRAIN = "configs/reverie_pretrain.json"
R4R_PRETRAIN, RXR_PRETRAIN = "configs/r4r_pretrain.json", "configs/rxr_pretrain.json"


def obj_train_phase(out_dir: str, steps: int = 40, seed: int = 39, min_each: int = 8) -> dict:
    """Object pretraining at the widths and mix of ``configs/reverie_pretrain.json``
    (image and object features 768, object probabilities 1000, 20 objects,
    B=16, mlm 5 / mrc 2 / sap 5 / og 2 / masksem 1), through the library as
    the JAX package's object pretraining test runs it: ``PretrainTrainer``
    over a ``TextPathData`` with an ``ObjectDB`` of the synthetic REVERIE
    world (``make_synthetic_object_world``). ``seed`` 39 schedules each of
    the five tasks in one block of 8 of the 40 steps."""
    import numpy as np

    from vln_bevbert_tpu_torch.cli.finetune import synthetic_feature_dbs
    from vln_bevbert_tpu_torch.configs import PretrainConfig, load_config
    from vln_bevbert_tpu_torch.data.loader import PretrainLoader, make_synthetic_object_world
    from vln_bevbert_tpu_torch.data.nav_graph import (
        build_scanvp_cands,
        load_nav_graphs,
        write_synthetic_connectivity,
    )
    from vln_bevbert_tpu_torch.data.pathdata import TextPathData
    from vln_bevbert_tpu_torch.nav.obj_env import ObjectDB
    from vln_bevbert_tpu_torch.pretrain.trainer import PretrainTrainer

    t0 = time.perf_counter()
    cfg = load_config(PretrainConfig, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                   REVERIE_PRETRAIN),
                      seed=seed, output_dir=out_dir, **{"optim.num_train_steps": steps})
    m, sh = cfg.model, cfg.shapes
    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory() as conn:
        write_synthetic_connectivity(conn, rng, n_scans=4, n_nodes=20)
        graphs = load_nav_graphs(conn)
    dbs = synthetic_feature_dbs(rng, {s: g.node_ids for s, g in graphs.items()},
                                image_feat_size=m.image_feat_size,
                                grid_feat_size=m.bev_grid_feat_size, grid_hw=sh.grid_hw,
                                num_views=sh.num_views, num_sem=m.num_sem_classes)
    annos, obj_data, _ = make_synthetic_object_world(
        graphs, rng, n_items=256, obj_feat_size=m.obj_feat_size, obj_prob_size=m.obj_prob_size)
    db = TextPathData(annos, graphs, build_scanvp_cands(graphs), **dbs,
                      obj_db=ObjectDB(obj_data), image_feat_size=m.image_feat_size,
                      obj_feat_size=m.obj_feat_size, obj_prob_size=m.obj_prob_size,
                      max_objects=sh.max_objects, max_txt_len=sh.max_txt_len,
                      bev_dim=m.bev_dim, bev_res=m.bev_res, num_views=sh.num_views,
                      dataset="reverie")
    trainer = PretrainTrainer(cfg, PretrainLoader(db, cfg, seed=cfg.seed), "cuda")
    run = run_trainer(trainer, "obj_train", min_each, time.perf_counter() - t0)
    og_acc = run["meters"]["og/og_acc"]
    if not 0.0 <= og_acc <= 1.0 or run["meters"]["mrc/mrc_n"] <= 0:
        raise AssertionError(f"obj_train: og_acc {og_acc}, mrc_n {run['meters']['mrc/mrc_n']}")
    return run


def slice_phase(device: str, extra_args: list) -> dict:
    """Run the CLI's synthetic eval, instrumented; returns its measurements."""
    from vln_bevbert_tpu_torch import _build
    from vln_bevbert_tpu_torch.cli import finetune
    from vln_bevbert_tpu_torch.nav import agent as agent_mod
    from vln_bevbert_tpu_torch.ops import bev as bev_mod
    from vln_bevbert_tpu_torch.ops.splat import splat_sums, splat_sums_plain

    seen = {"gathers": 0, "rollouts": [], "steps": 0, "agent": None,
            "first_gather": None, "first_nav": None}
    gather, rollout, forward = (agent_mod.gather_and_splat,
                                agent_mod.GMapNavAgent.rollout,
                                agent_mod.GMapNavAgent._forward)

    def counted_gather(*args):
        seen["gathers"] += 1
        bev = gather(*args)
        if seen["first_gather"] is None:
            seen["first_gather"] = (args, bev.clone())
        return bev

    def timed_rollout(self, *args, **kw):
        seen["agent"] = self
        steps0, t0 = seen["steps"], time.perf_counter()
        out = rollout(self, *args, **kw)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seen["rollouts"].append((time.perf_counter() - t0, seen["steps"] - steps0))
        return out

    def recorded_forward(self, mode, batch):
        out = forward(self, mode, batch)
        if mode == "navigation":
            seen["steps"] += 1
            if seen["first_nav"] is None:
                seen["first_nav"] = (dict(batch), out["fused_logits"].clone())
        return out

    agent_mod.gather_and_splat = counted_gather
    agent_mod.GMapNavAgent.rollout = timed_rollout
    agent_mod.GMapNavAgent._forward = recorded_forward
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            argv = ["--synthetic", "--test", "--device", device, "--output_dir", out_dir,
                    *extra_args]
            if device == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            t0 = time.perf_counter()
            results = finetune.main(argv)
            wall = time.perf_counter() - t0
            launches = _build.launches("splat")
            with open(f"{out_dir}/preds_val_unseen_0.json") as f:
                n_preds = len(json.load(f))
    finally:
        agent_mod.gather_and_splat = gather
        agent_mod.GMapNavAgent.rollout = rollout
        agent_mod.GMapNavAgent._forward = forward
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    # the first step again, with the plain splat on the same device buffers
    agent = seen["agent"]
    args, bev_kernel = seen["first_gather"]
    bev_mod.splat_sums = splat_sums_plain
    try:
        with torch.inference_mode():
            bev_plain = gather(*args)
    finally:
        bev_mod.splat_sums = splat_sums
    nav_in, logits_kernel = seen["first_nav"]
    nav_in["bev_fts"] = bev_plain
    logits_plain = forward(agent, "navigation", nav_in)["fused_logits"]
    return {
        "results": results, "wall_s": wall, "rollouts": seen["rollouts"],
        "steps": seen["steps"], "gathers": seen["gathers"], "launches": launches,
        "peak_bytes": peak, "n_preds": n_preds, "bev_kernel": bev_kernel,
        "bev_plain": bev_plain, "logits_kernel": logits_kernel,
        "logits_plain": logits_plain,
    }


def check_slice(run: dict, expect_kernel: bool) -> float:
    metrics = run["results"]["val_unseen"]
    for key in ("sr", "spl", "nDTW"):
        if not (0.0 <= metrics[key] <= 100.0):
            raise AssertionError(f"slice: {key}={metrics[key]} outside [0, 100]")
    if run["n_preds"] != 16:
        raise AssertionError(f"slice: {run['n_preds']} predictions, expected 16")
    if run["gathers"] <= 0 or run["steps"] != run["gathers"]:
        raise AssertionError(f"slice: {run['gathers']} gathers for {run['steps']} steps")
    if expect_kernel and run["launches"] != run["gathers"]:
        raise AssertionError(
            f"slice: {run['launches']} splat kernel launches for {run['gathers']} "
            "gather-and-splat calls"
        )
    bev_k, bev_p = run["bev_kernel"], run["bev_plain"]
    if not torch.isfinite(bev_k).all():
        raise AssertionError("slice: non-finite BEV features")
    torch.testing.assert_close(bev_k, bev_p, rtol=RTOL, atol=ATOL)
    lk, lp = run["logits_kernel"], run["logits_plain"]
    if not torch.isfinite(lk).all() or not torch.equal(lk.argmax(-1), lp.argmax(-1)):
        raise AssertionError("slice: first-step action differs with the plain splat")
    return (bev_k - bev_p).abs().max().item()


def finetune_phase(pretrain_ckpt: str, pretrain_names: set, out_dir: str,
                   iters: int = 3, extra: tuple = (), label: str = "finetune",
                   metric_keys: tuple = ("sr", "spl", "nDTW")) -> dict:
    """DAgger fine-tuning at full width from the pretraining checkpoint,
    through the CLI (``--synthetic --pretrain_ckpt <ckpt> --iters 3
    --log_every 3`` and ``extra``: 6 training rollouts, 6 replay updates, one
    evaluation of val_unseen), instrumented; then ``--test --pretrain_ckpt
    ckpt_latest``, which must predict the same trajectories (and grounded
    objects, ``predObjId``)."""
    from vln_bevbert_tpu_torch import _build
    from vln_bevbert_tpu_torch.cli import finetune
    from vln_bevbert_tpu_torch.nav import agent as agent_mod
    from vln_bevbert_tpu_torch.ops import dropout as drop_mod

    seen = {"gathers": 0, "drop_fwd": 0, "drop_bwd": 0, "rollouts": [], "updates": [],
            "agent": None, "start": None}
    cls = agent_mod.GMapNavAgent
    gather, counted_gather = counted_gathers(seen, agent_mod)
    drop_forward, counted_dropout = counting_dropout(seen)
    rollout, learn, init = cls._rollout, cls.learn_from_bundle, cls.init_params

    def timed_rollout(self, feedback, train):
        t0 = time.perf_counter()
        traj, lang, records = rollout(self, feedback, train)
        torch.cuda.synchronize()
        if train:
            seen["rollouts"].append((feedback, time.perf_counter() - t0, len(records)))
        return traj, lang, records

    def timed_learn(self, rb):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = learn(self, rb)  # ends in the update's one read-back
        seen["updates"].append(time.perf_counter() - t0)
        return loss

    def recorded_init(self, *args, **kw):
        out = init(self, *args, **kw)
        seen["agent"] = self
        seen["start"] = {n: p.detach().cpu().clone() for n, p in self.model.named_parameters()}
        return out

    argv = ["--synthetic", "--device", "cuda", "--output_dir", out_dir, *extra]
    agent_mod.gather_and_splat, drop_mod.Dropout.forward = counted_gather, counted_dropout
    cls._rollout, cls.learn_from_bundle, cls.init_params = timed_rollout, timed_learn, recorded_init
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        results = finetune.main(argv + ["--pretrain_ckpt", pretrain_ckpt, "--iters", str(iters),
                                        "--log_every", str(iters)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"splat": _build.launches("splat"), "dropout": _build.launches("dropout")}
        peak = torch.cuda.max_memory_allocated()
    finally:
        agent_mod.gather_and_splat, drop_mod.Dropout.forward = gather, drop_forward
        cls._rollout, cls.learn_from_bundle, cls.init_params = rollout, learn, init
    agent = seen["agent"]

    nav_names = set(agent.model.state_dict())
    if not nav_names <= pretrain_names or agent.transferred != len(nav_names):
        raise AssertionError(f"{label}: {agent.transferred} entries transferred; the models "
                             f"share {len(nav_names & pretrain_names)} of {len(nav_names)}")
    feedbacks = [fb for fb, *_ in seen["rollouts"]]
    if feedbacks != ["teacher", "sample"] * iters or len(seen["updates"]) != 2 * iters:
        raise AssertionError(f"{label}: rollouts {feedbacks}, {len(seen['updates'])} updates")
    if launches["splat"] != seen["gathers"]:
        raise AssertionError(f"{label}: {launches['splat']} splat launches for "
                             f"{seen['gathers']} gather-and-splat calls")
    if launches["dropout"] != seen["drop_fwd"] + seen["drop_bwd"] or seen["drop_bwd"] == 0:
        raise AssertionError(f"{label}: {launches['dropout']} dropout launches for "
                             f"{seen['drop_fwd']} forward and {seen['drop_bwd']} backward calls")
    losses, norms = agent.logs["IL_loss"], agent.logs["grad_norm"]
    values = torch.tensor(losses + norms)
    if len(losses) != 2 * iters or not torch.isfinite(values).all() or not (values > 0).all():
        raise AssertionError(f"{label}: IL_loss {losses}, grad_norm {norms}")
    # og_head's output bias and LayerNorm shift add alike to every object
    # logit: the grounding softmax gives them a zero gradient, and weight
    # decay keeps them at their initial zeros
    params = dict(agent.model.named_parameters())
    unchanged = [n for n, p in params.items() if torch.equal(p.detach().cpu(), seen["start"][n])]
    if [n for n in unchanged if n not in OG_SHIFT_INVARIANT or params[n].any()]:
        raise AssertionError(f"{label}: {len(unchanged)} parameters unchanged: {unchanged[:3]}")
    metrics = results["val_unseen"]
    for key in metric_keys:
        if not 0.0 <= metrics[key] <= 100.0:
            raise AssertionError(f"{label}: {key}={metrics[key]} outside [0, 100]")

    # the saved agent, evaluated on its own, predicts what the trained one did
    for name in ("ckpt_best", "ckpt_latest"):
        if not os.path.isfile(os.path.join(out_dir, name)):
            raise AssertionError(f"{label}: {name} was not written")
    test_dir = os.path.join(out_dir, "test")
    finetune.main(["--synthetic", "--device", "cuda", "--test", "--output_dir", test_dir,
                   "--pretrain_ckpt", os.path.join(out_dir, "ckpt_latest"), *extra])

    def by_id(path):
        with open(path) as f:
            return {p["instr_id"]: (p["trajectory"], p.get("predObjId")) for p in json.load(f)}

    trained = by_id(os.path.join(out_dir, f"preds_val_unseen_{iters}.json"))
    if by_id(os.path.join(test_dir, "preds_val_unseen_0.json")) != trained or len(trained) != 16:
        raise AssertionError(f"{label}: --test from ckpt_latest predicts other trajectories")
    if agent.with_objects and any(obj is None for _, obj in trained.values()):
        raise AssertionError(f"{label}: a prediction has no predObjId")
    rollouts, updates = seen["rollouts"], seen["updates"]
    return {
        "results": results, "wall_s": wall, "launches": launches, "gathers": seen["gathers"],
        "drop_fwd": seen["drop_fwd"], "drop_bwd": seen["drop_bwd"], "peak_bytes": peak,
        "transferred": agent.transferred, "params": len(nav_names),
        "losses": losses, "grad_norms": norms,
        "rollout_steps": sum(n for *_, n in rollouts),
        "ms_per_rollout_step": 1e3 * sum(s for _, s, _ in rollouts) / sum(n for *_, n in rollouts),
        "ms_per_rollout_step_after_first": (1e3 * sum(s for _, s, _ in rollouts[1:])
                                            / sum(n for *_, n in rollouts[1:])),
        "ms_per_update": 1e3 * sum(updates[1:]) / len(updates[1:]),
        "first_update_ms": 1e3 * updates[0],
    }


def obj_finetune_phase(pretrain_ckpt: str, pretrain_names: set, out_dir: str) -> dict:
    """REVERIE DAgger fine-tuning (``cli.finetune --synthetic --dataset
    reverie``) from the object pretraining checkpoint, with a ``--config``
    that repeats its model widths so that every navigation parameter
    transfers (``og_head`` and ``img_embeddings`` included); then ``--test``
    from ``ckpt_latest``, and one SOON evaluation (``--dataset soon
    --test``) of the same agent."""
    from vln_bevbert_tpu_torch import _build
    from vln_bevbert_tpu_torch.cli import finetune

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, REVERIE_PRETRAIN)) as f:
        model = json.load(f)["model"]
    config = out_dir + "_config.json"
    with open(config, "w") as f:
        json.dump({"model": model, "shapes": {"max_objects": 20}}, f)
    ft = finetune_phase(pretrain_ckpt, pretrain_names, out_dir,
                        extra=("--dataset", "reverie", "--config", config), label="obj_finetune",
                        metric_keys=("sr", "spl", "rgs", "rgspl", "oracle_sr"))

    soon_dir = os.path.join(out_dir, "soon")
    _build.reset_launches()
    soon = finetune.main(["--synthetic", "--device", "cuda", "--test", "--dataset", "soon",
                          "--config", config, "--output_dir", soon_dir,
                          "--pretrain_ckpt", os.path.join(out_dir, "ckpt_latest")])["val_unseen"]
    soon_launches = _build.launches("splat")
    with open(os.path.join(soon_dir, "preds_val_unseen_0.json")) as f:
        dump = json.load(f)
    if (soon_launches <= 0 or len(dump) != 16 or any("predObjId" not in p for p in dump)
            or not all(0.0 <= soon[k] <= 100.0 for k in ("sr", "spl", "rgs", "rgspl"))):
        raise AssertionError(f"obj_finetune: soon --test gave {soon}, {soon_launches} splat "
                             f"launches, {len(dump)} predictions")
    ft.update(soon=soon, soon_splat_launches=soon_launches)
    return ft


def small_phase() -> None:
    """A small configuration on the card and on the CPU, same parameters."""
    import numpy as np

    from vln_bevbert_tpu_torch.cli import finetune

    small = {
        "model": {"hidden_size": 64, "num_attention_heads": 2, "intermediate_size": 128,
                  "num_l_layers": 1, "num_pano_layers": 1, "num_x_layers": 1,
                  "image_feat_size": 32, "bev_grid_feat_size": 24, "dtype": "float32"},
        "shapes": {"max_gmap_len": 32, "max_local_len": 8, "max_pano_len": 40,
                   "num_views": 12, "grid_hw": 4, "max_pc_steps": 4},
        "batch_size": 2, "max_action_len": 6,
    }
    agents, logits = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        config = f"{tmp}/small.json"
        with open(config, "w") as f:
            json.dump(small, f)
        for device in ("cpu", "cuda"):
            args = finetune.parse_args(["--synthetic", "--test", "--device", device,
                                        "--config", config, "--output_dir", tmp])
            _, _, val_envs, agents[device] = finetune.build(args)
            agents[device].env = val_envs["val_unseen"]
            logits[device] = []
    agents["cuda"].model.load_state_dict(agents["cpu"].model.state_dict())
    preds = {}
    for device, agent in agents.items():
        forward = agent._forward

        def rec(mode, batch, forward=forward, out_list=logits[device]):
            out = forward(mode, batch)
            if mode == "navigation":
                out_list.append(out["fused_logits"].float().cpu().numpy())
            return out

        agent._forward = rec
        preds[device] = agent.test(max_batches=2)
    if [p["trajectory"] for p in preds["cuda"]] != [p["trajectory"] for p in preds["cpu"]]:
        raise AssertionError("small: trajectories differ between the card and the CPU")
    err = max(float(np.abs(a - b).max()) for a, b in zip(logits["cuda"], logits["cpu"]))
    if len(logits["cuda"]) != len(logits["cpu"]) or err > 1e-3:
        raise AssertionError(f"small: fused logits differ by {err}")
    phase("small", episodes=len(preds["cuda"]), steps=len(logits["cuda"]),
          max_logit_err=f"{err:.3e}", trajectories="equal")


CE_PRETRAIN = "configs/ce_pretrain.json"


def ce_pretrain_phase(out_dir: str, steps: int = 16, seed: int = 2, min_each: int = 4) -> dict:
    """CE pretraining through the CLI (``cli.pretrain --synthetic --config
    configs/ce_pretrain.json``: mlm 5 / sap 5, B=16, text 100, 11x11 BEV at
    1 m, the depth embedding flag), instrumented as ``train`` is; ``seed`` 2
    schedules mlm then sap, 8 steps each."""
    from vln_bevbert_tpu_torch.cli import pretrain

    t0 = time.perf_counter()
    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), CE_PRETRAIN)
    trainer = pretrain.build(pretrain.parse_args([
        "--synthetic", "--device", "cuda", "--config", config, "--num_steps", str(steps),
        "--seed", str(seed), "--output_dir", out_dir]))
    return run_trainer(trainer, "ce_pretrain", min_each, time.perf_counter() - t0)


def ce_phase(label: str, out_dir: str, argv: list, pretrain_names: set,
             eval_and_infer: bool) -> dict:
    """``cli.ce_train`` training (``argv``), instrumented: each training
    iteration (rollout and replay update), each rollout's steps, the
    gather-and-splat and dropout calls against the kernels' launches, the
    transfer from the pretraining checkpoint, the losses and the parameters
    that moved. With ``eval_and_infer``: then ``--run_type eval`` over the
    saved checkpoint files (control back-tracking) and ``--run_type
    inference`` from the last one, which must cover every episode."""
    from vln_bevbert_tpu_torch import _build
    from vln_bevbert_tpu_torch.ce import agent as ce_mod
    from vln_bevbert_tpu_torch.cli import ce_train
    from vln_bevbert_tpu_torch.nav import agent as nav_mod
    from vln_bevbert_tpu_torch.ops import dropout as drop_mod

    cls, base = ce_mod.CEAgent, nav_mod.GMapNavAgent
    seen = {"gathers": 0, "drop_fwd": 0, "drop_bwd": 0, "iters": [], "rollouts": [],
            "updates": [], "steps": 0, "agent": None, "start": None}
    counted_gather = counted_gathers(seen, ce_mod)[1]
    counted_dropout = counting_dropout(seen)[1]
    rollout, ce_rollout, gmap_var = cls.rollout, cls._ce_rollout, cls._ce_gmap_variable
    learn, init = base.learn_from_bundle, cls.init_params

    def timed_iteration(self, feedback="sample", train=True, sample_ratio=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = rollout(self, feedback, train, sample_ratio)
        torch.cuda.synchronize()
        if train:
            seen["iters"].append(time.perf_counter() - t0)
        return out

    def timed_rollout(self, feedback, train, sample_ratio):
        steps0, t0 = seen["steps"], time.perf_counter()
        out = ce_rollout(self, feedback, train, sample_ratio)
        torch.cuda.synchronize()
        seen["rollouts"].append((train, time.perf_counter() - t0, seen["steps"] - steps0))
        return out

    def counted_step(self, *args):
        seen["steps"] += 1
        return gmap_var(self, *args)

    def timed_learn(self, rb):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = learn(self, rb)  # ends in the update's one read-back
        seen["updates"].append(time.perf_counter() - t0)
        return loss

    def recorded_init(self, *args, **kw):
        out = init(self, *args, **kw)
        seen["agent"] = self
        seen["start"] = {n: p.detach().cpu().clone() for n, p in self.model.named_parameters()}
        return out

    patches = [(ce_mod, "gather_and_splat", counted_gather),
               (drop_mod.Dropout, "forward", counted_dropout), (cls, "rollout", timed_iteration),
               (cls, "_ce_rollout", timed_rollout), (cls, "_ce_gmap_variable", counted_step),
               (base, "learn_from_bundle", timed_learn), (cls, "init_params", recorded_init)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    try:
        for obj, name, fn in patches:
            setattr(obj, name, fn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        metrics = ce_train.main(argv + ["--output_dir", out_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"splat": _build.launches("splat"), "dropout": _build.launches("dropout")}
        peak = torch.cuda.max_memory_allocated()
        gathers, drop_calls = seen["gathers"], (seen["drop_fwd"], seen["drop_bwd"])
        agent, rollouts = seen["agent"], list(seen["rollouts"])
        use_bev = agent.cfg.model.use_bev

        nav_names = set(agent.model.state_dict())
        if not nav_names <= pretrain_names or agent.transferred != len(nav_names):
            raise AssertionError(f"{label}: {agent.transferred} entries transferred; the models "
                                 f"share {len(nav_names & pretrain_names)} of {len(nav_names)}")
        if launches["splat"] != gathers or (gathers > 0) != use_bev:
            raise AssertionError(f"{label}: {launches['splat']} splat launches for {gathers} "
                                 f"gather-and-splat calls (use_bev {use_bev})")
        if launches["dropout"] != sum(drop_calls) or drop_calls[1] == 0:
            raise AssertionError(f"{label}: {launches['dropout']} dropout launches for "
                                 f"{drop_calls[0]} forward and {drop_calls[1]} backward calls")
        losses, norms = agent.logs["IL_loss"], agent.logs["grad_norm"]
        values = torch.tensor(losses + norms)
        if not losses or not torch.isfinite(values).all() or not (values > 0).all():
            raise AssertionError(f"{label}: IL_loss {losses}, grad_norm {norms}")
        unchanged = [n for n, p in agent.model.named_parameters()
                     if torch.equal(p.detach().cpu(), seen["start"][n])]
        if unchanged:
            raise AssertionError(f"{label}: {len(unchanged)} parameters unchanged: {unchanged[:3]}")
        scores = {k: 100 * metrics[k] for k in ("success", "spl", "ndtw")}
        if not all(0.0 <= v <= 100.0 for v in scores.values()):
            raise AssertionError(f"{label}: metrics {scores} outside [0, 100]")
        # the frozen waypoint predictor at this run's batch, device time
        depth = torch.randn(agent.env.batch_size * 12, *agent.env.depth_feat_shape,
                            device=agent.device)
        with torch.inference_mode():
            wp_device_ms = device_ms(lambda: agent.wp_model(depth))
            wp_ms = cuda_ms(lambda: agent.wp_model(depth), iters=20)
        # the synthetic env's sensors for one step of the batch, host clock
        t0 = time.perf_counter()
        for _ in range(3):
            agent.env.observations()
        env_obs_ms = 1e3 * (time.perf_counter() - t0) / 3
        if eval_and_infer:
            # a sampled training rollout (its bundle kept) and a replay
            # update from it, each traced through utils/profiling
            bundles, steps0 = [], seen["steps"]
            agent.learn_from_bundle = lambda rb: bundles.append(rb) or 0.0
            try:
                _, trace_rollout = traced_busy(lambda: agent.rollout("sample", True), "ce_rollout",
                                               os.path.join(out_dir, "trace"))
            finally:
                del agent.learn_from_bundle
            trace_rollout["steps"] = seen["steps"] - steps0
            _, trace_update = traced_busy(lambda: agent.learn_from_bundle(bundles[-1]),
                                          "ce_replay_update", os.path.join(out_dir, "trace"))
        out = {"wall_s": wall, "launches": launches, "gathers": gathers,
               "drop_fwd": drop_calls[0], "drop_bwd": drop_calls[1], "peak_bytes": peak,
               "transferred": agent.transferred, "params": len(nav_names), "losses": losses,
               "grad_norms": norms, "scores": scores, "iters": len(seen["iters"]),
               "ms_per_iter": 1e3 * sum(seen["iters"]) / len(seen["iters"]),
               "ms_per_update": 1e3 * sum(seen["updates"]) / len(seen["updates"]),
               "wp_device_ms": wp_device_ms, "wp_ms": wp_ms, "env_obs_ms": env_obs_ms,
               "n_episodes": agent.env.size()}
        for kind, train in (("train", True), ("eval", False)):
            runs = [(s, n) for t, s, n in rollouts if t == train]
            out[f"{kind}_rollouts"] = len(runs)
            out[f"{kind}_steps"] = sum(n for _, n in runs)
            out[f"ms_per_{kind}_step"] = 1e3 * sum(s for s, _ in runs) / sum(n for _, n in runs)
        if not eval_and_infer:
            return out
        out.update(trace_rollout=trace_rollout, trace_update=trace_update)

        # every checkpoint of the run, evaluated with low-level control
        seen["gathers"] = 0
        _build.reset_launches()
        ckpts = sorted(f for f in os.listdir(out_dir) if f.startswith("ckpt_"))
        results = ce_train.main(argv + ["--output_dir", out_dir, "--run_type", "eval",
                                        "--ckpt_path_dir", out_dir, "--eval_batches", "2"])
        if sorted(results) != ckpts or len(ckpts) < 2:
            raise AssertionError(f"{label}: evaluated {sorted(results)} of {ckpts}")
        if _build.launches("splat") != seen["gathers"] or seen["gathers"] == 0:
            raise AssertionError(f"{label} eval: {_build.launches('splat')} splat launches for "
                                 f"{seen['gathers']} gather-and-splat calls")
        for name, m in results.items():
            if not all(0.0 <= 100 * m[k] <= 100.0 for k in ("success", "spl", "ndtw")):
                raise AssertionError(f"{label} eval: {name} {m}")
        # leaderboard predictions from the last checkpoint
        last = max(ckpts, key=lambda f: int(f.split("_")[1]))
        ce_train.main(argv + ["--output_dir", out_dir, "--run_type", "inference",
                              "--ckpt_path_dir", os.path.join(out_dir, last)])
        with open(os.path.join(out_dir, "preds.json")) as f:
            preds = json.load(f)
        if len(preds) != agent.env.size() or any(not v for v in preds.values()):
            raise AssertionError(f"{label}: {len(preds)} predicted episodes of {agent.env.size()}")
        out.update(eval=results, eval_gathers=seen["gathers"], n_preds=len(preds),
                   ckpt=last)
        return out
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def print_ce(label: str, run: dict) -> None:
    phase(label, iters=run["iters"], transferred=f"{run['transferred']}/{run['params']}",
          gathers=run["gathers"], splat_launches=run["launches"]["splat"],
          dropout_forward_calls=run["drop_fwd"], dropout_backward_calls=run["drop_bwd"],
          dropout_launches=run["launches"]["dropout"],
          ms_per_train_iteration=f"{run['ms_per_iter']:.2f}",
          ms_per_replay_update=f"{run['ms_per_update']:.2f}",
          train_rollout_steps=run["train_steps"],
          ms_per_train_rollout_step=f"{run['ms_per_train_step']:.2f}",
          eval_rollouts=run["eval_rollouts"], eval_steps=run["eval_steps"],
          ms_per_eval_step=f"{run['ms_per_eval_step']:.2f}",
          waypoint_device_ms=f"{run['wp_device_ms']:.4f}", waypoint_ms=f"{run['wp_ms']:.4f}",
          env_observations_host_ms=f"{run['env_obs_ms']:.2f}",
          peak_mem_MiB=f"{run['peak_bytes'] / 2**20:.1f}", wall_s=f"{run['wall_s']:.2f}",
          IL_loss=",".join(f"{v:.4g}" for v in run["losses"]),
          grad_norm=",".join(f"{v:.4g}" for v in run["grad_norms"]),
          **{k: f"{v:.2f}" for k, v in run["scores"].items()})
    if "trace_rollout" in run:
        roll, upd = run["trace_rollout"], run["trace_update"]
        phase(label, traced="utils.profiling.trace", rollout_steps=roll["steps"],
              rollout_ms_per_step=f"{roll['wall_ms'] / roll['steps']:.2f}",
              rollout_device_busy_ms_per_step=f"{roll['busy_ms'] / roll['steps']:.2f}",
              rollout_device_busy_share=f"{roll['busy_share']:.2%}",
              replay_update_ms=f"{upd['wall_ms']:.2f}",
              replay_update_device_busy_ms=f"{upd['busy_ms']:.2f}",
              replay_update_device_busy_share=f"{upd['busy_share']:.2%}")
    if "eval" in run:
        phase(label, run_type="eval", checkpoints=",".join(sorted(run["eval"])),
              splat_launches=run["eval_gathers"], back_algo="control",
              **{f"{name}_sr": f"{100 * m['success']:.2f}" for name, m in run["eval"].items()},
              run_type_inference=run["ckpt"], predicted_episodes=run["n_preds"])


def small_ce_phase() -> None:
    """A small CE configuration (hidden 64, BEV 5, B=2, float32) on the card
    and on the CPU with the same parameters, greedy with low-level control:
    equal trajectories, heatmaps within 1e-4 and fused logits within 1e-3.
    The waypoint head is sharpened (x100) so that its NMS peaks stand far
    apart: the NMS is an argmax over a softmax."""
    import numpy as np

    from vln_bevbert_tpu_torch.cli import ce_train

    small = {
        "model": {"hidden_size": 64, "num_attention_heads": 2, "intermediate_size": 128,
                  "num_l_layers": 1, "num_pano_layers": 1, "num_x_layers": 1,
                  "image_feat_size": 32, "bev_grid_feat_size": 24, "bev_dim": 5,
                  "bev_res": 1.5, "dtype": "float32"},
        "shapes": {"max_gmap_len": 16, "max_local_len": 8, "max_pano_len": 20,
                   "num_views": 12, "grid_hw": 4, "max_pc_steps": 3},
        "batch_size": 2, "max_action_len": 4,
    }
    agents, rec = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        config = f"{tmp}/small_ce.json"
        with open(config, "w") as f:
            json.dump(small, f)
        for device in ("cpu", "cuda"):
            _, agents[device] = ce_train.build(ce_train.parse_args([
                "--device", device, "--config", config, "--allow_random_frozen",
                "--n_episodes", "4", "--output_dir", tmp]))
    cpu = agents["cpu"]
    with torch.no_grad():
        cpu.wp_model.cls_fc2.weight.mul_(100.0)
    agents["cuda"].model.load_state_dict(cpu.model.state_dict())
    agents["cuda"].wp_model.load_state_dict(cpu.wp_model.state_dict())
    trajs = {}
    for device, agent in agents.items():
        rec[device] = {"heat": [], "logits": []}
        waypoints, forward = agent._waypoints, agent._forward

        def wp_rec(obs, train, waypoints=waypoints, out=rec[device]):
            res = waypoints(obs, train)
            out["heat"].append(res[2])
            return res

        def fwd_rec(mode, batch, forward=forward, out=rec[device]):
            res = forward(mode, batch)
            if mode == "navigation":
                out["logits"].append(res["fused_logits"].float().cpu().numpy())
            return res

        agent._waypoints, agent._forward = wp_rec, fwd_rec
        trajs[device] = sum((agent.rollout(feedback="argmax", train=False)[0]
                             for _ in range(2)), [])
    for a, b in zip(trajs["cuda"], trajs["cpu"]):
        if not (np.array_equal(np.stack(a["positions"]), np.stack(b["positions"]))
                and a["headings"] == b["headings"]):
            raise AssertionError("small ce: trajectories differ between the card and the CPU")
    errs = {}
    for key, tol in (("heat", 1e-4), ("logits", 1e-3)):
        if len(rec["cuda"][key]) != len(rec["cpu"][key]):
            raise AssertionError(f"small ce: {key} recorded {len(rec['cuda'][key])} vs "
                                 f"{len(rec['cpu'][key])} times")
        errs[key] = max(float(np.abs(a - b).max()) for a, b in zip(rec["cuda"][key],
                                                                    rec["cpu"][key]))
        if errs[key] > tol:
            raise AssertionError(f"small ce: {key} differ by {errs[key]}")
    phase("small", config="ce", episodes=len(trajs["cuda"]), steps=len(rec["cuda"]["logits"]),
          max_heatmap_err=f"{errs['heat']:.3e}", max_logit_err=f"{errs['logits']:.3e}",
          trajectories="equal", back_algo=agents["cuda"].cfg.ce_back_algo)


# card against CPU for the full-width towers, strict float32 on both: sums
# over K = 768-3072 in another order, through 12 layers
TOWER_RTOL, TOWER_ATOL = 1e-3, 1e-3


def write_tower_files(out_dir: str) -> tuple:
    """The full-width frozen towers' checkpoint files from seeds: CLIP
    ViT-B/16 in HF ``CLIPVisionModel`` layout, the DDPPO ResNet-50 in the
    published ``actor_critic.net.visual_encoder.*`` layout."""
    os.makedirs(out_dir, exist_ok=True)
    clip, ddppo = os.path.join(out_dir, "clip_vit_b16.pt"), os.path.join(out_dir, "ddppo.pth")
    torch.save(hf_clip_state_dict(seed=11), clip)
    torch.save(ddppo_checkpoint(seed=12), ddppo)
    return clip, ddppo


def habitat_phase(out_dir: str, pretrain_ckpt: str, pretrain_names: set) -> dict:
    """The Habitat path over the stand-in simulator: the full-width towers
    on the card against the CPU on one 12-view ring; then ``cli.ce_train
    --trainer ss-bev --habitat_config --clip_ckpt --ddppo_ckpt`` from the CE
    pretraining checkpoint, instrumented as ``ce`` is, with the towers'
    calls and the controller's steps counted; then the low-level control
    of the evaluation's back-tracking on the binding (an argmax evaluation
    after 2 iterations may stop at once): a walk into an obstacle and a free
    one must move and call ``rotate`` and ``forward_step``; the step's parts
    timed alone: an env's render and depth pooling and its frames' CLIP
    preprocessing (host), a 12-view CLIP and a 12-frame DDPPO call (CUDA
    events), an env's grid round trip to the host and back (host clock
    around a sync)."""
    import numpy as np

    from vln_bevbert_tpu_torch.ce import habitat_binding as hb_mod
    from vln_bevbert_tpu_torch.ce.control import LowLevelController
    from vln_bevbert_tpu_torch.ce.frozen import (DeviceDepthEncoder, load_clip_params,
                                                 load_depth_params)
    from vln_bevbert_tpu_torch.models.clip import preprocess
    from vln_bevbert_tpu_torch.precompute.pipeline import DeviceClipEncoder

    clip_path, ddppo_path = write_tower_files(out_dir)
    config = write_habitat_config(os.path.join(out_dir, "stand_in.yaml"))
    saved_habitat = sys.modules.get("habitat")
    sys.modules["habitat"] = habitat_stand_in()
    counts = {"clip": 0, "ddppo": 0, "observations": 0, "forward_step": 0, "rotate": 0}
    patches = [(hb_mod.HabitatContinuousEnv, "observations", "observations"),
               (DeviceClipEncoder, "encode_views", "clip"),
               (DeviceClipEncoder, "encode_grids", "clip"),
               (DeviceDepthEncoder, "spatial", "ddppo"),
               (hb_mod.HabitatContinuousEnv, "forward_step", "forward_step"),
               (hb_mod.HabitatContinuousEnv, "rotate", "rotate")]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    try:
        # 1. one ring of the stand-in's frames through both towers on both devices
        ring_env = hb_mod.make_habitat_env(config, 1)
        ring_env.reset()
        env0 = ring_env.envs[0]
        state = env0.sim.get_agent_state()
        views = [ring_env._render_at(env0.sim, state.position,
                                     ring_env._heading(state) + k * 2 * np.pi / 12)
                 for k in range(12)]
        rgb = np.stack([v["rgb"] for v in views])
        depth = np.stack([v["depth"] for v in views])
        clip_params, ddppo_params = load_clip_params(clip_path), load_depth_params(ddppo_path)
        outs, errs = {}, {}
        for device in ("cpu", "cuda"):
            clip = DeviceClipEncoder(clip_params, device=device)
            ddppo = DeviceDepthEncoder(ddppo_params, device=device)
            outs[device] = {"pooled": clip.encode_views(rgb), "grid": clip.encode_grids(rgb),
                            "ddppo_map": ddppo.spatial(depth)}
        width, n_patches = clip.feat_size, clip.tower.position_embedding.shape[0] - 1
        want_shapes = {"pooled": (12, width), "grid": (12, n_patches, width),
                       "ddppo_map": (12, *ddppo.feat_shape)}
        for key, ref in outs["cpu"].items():
            got = outs["cuda"][key]
            errs[key] = float(np.abs(got - ref).max())
            if got.shape != want_shapes[key] or not np.isfinite(got).all() or not np.allclose(
                    got, ref, rtol=TOWER_RTOL, atol=TOWER_ATOL):
                raise AssertionError(f"habitat: {key} {got.shape}, card vs CPU {errs[key]:.3e}")
        tower_params = {"clip": sum(p.numel() for p in clip.tower.parameters()),
                        "ddppo": sum(p.numel() for p in ddppo.model.parameters())}

        # the step's parts alone
        x = torch.from_numpy(preprocess(rgb)).to("cuda")
        d = torch.from_numpy(depth).to("cuda")
        with torch.inference_mode():
            clip_ms = cuda_ms(lambda: clip.tower(x), iters=10)
            ddppo_ms = cuda_ms(lambda: ddppo.model(d), iters=10)
            grid = clip.tower(x)["grid"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            torch.from_numpy(grid.cpu().numpy()).to("cuda")
        torch.cuda.synchronize()
        round_trip_ms = 1e3 * (time.perf_counter() - t0) / 10
        t0 = time.perf_counter()
        for _ in range(3):
            ring_env._camera_ring(env0.sim, state)  # no towers: render, pool, stack
        render_ms = 1e3 * (time.perf_counter() - t0) / 3
        t0 = time.perf_counter()
        for _ in range(3):
            preprocess(rgb)
            preprocess(rgb)
        preprocess_ms = 1e3 * (time.perf_counter() - t0) / 3
        del clip, ddppo, x, d, grid, outs
        free_memory()

        # 2. the CLI, instrumented
        def counting(fn, key):
            def counted(*args, **kw):
                counts[key] += 1
                return fn(*args, **kw)
            return counted

        for obj, name, key in patches:
            setattr(obj, name, counting(getattr(obj, name), key))
        argv = ["--batch_size", "8", "--allow_random_frozen", "--pretrain_ckpt", pretrain_ckpt,
                "--n_episodes", "16", "--trainer", "ss-bev", "--iters", "2", "--log_every", "2",
                "--habitat_config", config, "--clip_ckpt", clip_path, "--ddppo_ckpt", ddppo_path]
        run = ce_phase("habitat", os.path.join(out_dir, "run"), argv, pretrain_names,
                       eval_and_infer=False)
        cli_counts = dict(counts)

        # 3. the evaluation's back-tracking control on the binding, whatever
        # the policy chose: a walk into an obstacle (a collision, the tryout
        # recovery) and a free one
        ctrl_env = hb_mod.make_habitat_env(config, 2)
        ctrl_env.reset()
        ctrl = LowLevelController(ctrl_env, np.random.default_rng(0))
        cx, cz, r = ctrl_env.envs[0].sim.obstacles[0]
        ctrl_env.teleport(0, [cx, 0.0, cz + r + 0.3], heading=0.0)
        free_start = ctrl_env.positions[1].copy()
        collided, walk_s = [], 0.0
        for slot, ghost in ((0, [cx, 0.0, cz - r - 1.0]), (1, free_start + [1.5, 0.0, -1.5])):
            start = ctrl_env.positions[slot].copy()
            t0 = time.perf_counter()
            ctrl.execute(slot, {"act": 4, "back_path": None, "front_pos": start,
                                "ghost_pos": np.asarray(ghost), "tryout": True})
            walk_s += time.perf_counter() - t0
            collided.append(ctrl_env.previous_step_collided(slot))
        moved = np.linalg.norm(ctrl_env.positions - np.stack([[cx, 0.0, cz + r + 0.3],
                                                              free_start]), axis=1)
        ctrl_counts = {k: counts[k] - cli_counts[k] for k in ("forward_step", "rotate")}
        if not (moved > 0.2).all() or ctrl_counts["forward_step"] < 8 or not ctrl_counts["rotate"]:
            raise AssertionError(f"habitat control: moved {moved}, calls {ctrl_counts}")
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
        if saved_habitat is None:
            sys.modules.pop("habitat", None)
        else:
            sys.modules["habitat"] = saved_habitat
    # each rollout step reads one batch of observations (the last reads none,
    # a reset one; ``ce_phase``'s timing reads three more)
    steps = cli_counts["observations"]
    if run["eval_rollouts"] != 2 or cli_counts["clip"] == 0:
        raise AssertionError(f"habitat: {run['eval_rollouts']} eval rollouts, "
                             f"counts {cli_counts}")
    run.update(errs=errs, tower_params=tower_params, counts=cli_counts, clip_ms=clip_ms,
               control={**ctrl_counts, "moved_m": moved.round(2).tolist(),
                        "last_step_collided": collided,
                        "ms_per_call": 1e3 * walk_s / sum(ctrl_counts.values())},
               ddppo_ms=ddppo_ms, round_trip_ms=round_trip_ms, render_ms=render_ms,
               preprocess_ms=preprocess_ms, clip_path=clip_path, ddppo_path=ddppo_path,
               clip_calls_per_step=cli_counts["clip"] / steps,
               ddppo_calls_per_step=cli_counts["ddppo"] / steps)
    return run


def print_habitat(run: dict) -> None:
    print_ce("habitat", run)
    phase("habitat", card_vs_cpu="within rtol 1e-3 atol 1e-3",
          **{f"max_err_{k}": f"{v:.3e}" for k, v in run["errs"].items()},
          clip_params=run["tower_params"]["clip"], ddppo_params=run["tower_params"]["ddppo"],
          observation_batches=run["counts"]["observations"], clip_calls=run["counts"]["clip"],
          ddppo_calls=run["counts"]["ddppo"],
          clip_calls_per_step=f"{run['clip_calls_per_step']:.2f}",
          ddppo_calls_per_step=f"{run['ddppo_calls_per_step']:.2f}",
          clip_ms_per_12_view_call=f"{run['clip_ms']:.3f}",
          ddppo_ms_per_12_frame_call=f"{run['ddppo_ms']:.3f}",
          grid_round_trip_ms_per_env=f"{run['round_trip_ms']:.3f}",
          env_render_pool_host_ms_per_env=f"{run['render_ms']:.2f}",
          clip_preprocess_host_ms_per_env=f"{run['preprocess_ms']:.2f}",
          eval_control_forward_steps=run["counts"]["forward_step"],
          eval_control_rotations=run["counts"]["rotate"],
          control_check_forward_steps=run["control"]["forward_step"],
          control_check_rotations=run["control"]["rotate"],
          control_check_moved_m=",".join(map(str, run["control"]["moved_m"])),
          control_check_last_step_collided=",".join(map(str, run["control"]["last_step_collided"])),
          control_check_ms_per_sim_call=f"{run['control']['ms_per_call']:.4f}")


def precompute_phase(clip_path: str, ddppo_path: str, viewpoints: int = 4) -> dict:
    """The precompute pipeline's towers at full width over
    ``SyntheticImageSource`` frames (224x224, made before the clock starts):
    per viewpoint the 36 views through ``DeviceClipEncoder.encode_views``,
    the 12-view ring through ``encode_grids`` and the 36 depth views
    through the DDPPO tower (``DeviceDepthEncoder``, pooled), each host ms
    per viewpoint around a sync, the first viewpoint left out."""
    import numpy as np

    from vln_bevbert_tpu_torch.ce.frozen import (DeviceDepthEncoder, load_clip_params,
                                                 load_depth_params)
    from vln_bevbert_tpu_torch.precompute.pipeline import DeviceClipEncoder, SyntheticImageSource

    source = SyntheticImageSource({"scan": [f"vp{i}" for i in range(viewpoints + 1)]},
                                  image_hw=224, grid_hw=14)
    frames = [f for _, _, f in source]
    clip = DeviceClipEncoder(load_clip_params(clip_path), device="cuda")
    ddppo = DeviceDepthEncoder(load_depth_params(ddppo_path), input_size=224, device="cuda")
    jobs = {"views36": lambda f: clip.encode_views(f["views36"]),
            "ring12": lambda f: clip.encode_grids(f["ring12"]),
            "depth36": lambda f: ddppo(f["views36_depth"])}
    width, n_patches = clip.feat_size, clip.tower.position_embedding.shape[0] - 1
    want = {"views36": (36, width), "ring12": (12, n_patches, width),
            "depth36": (36, ddppo.feat_shape[0])}
    out = {}
    for name, job in jobs.items():
        res = job(frames[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in frames[1:]:
            res = job(f)
        out[name] = 1e3 * (time.perf_counter() - t0) / viewpoints
        if res.shape != want[name] or not np.isfinite(res).all():
            raise AssertionError(f"precompute: {name} {res.shape}")
    return out


DAGGER_ARGV = ["--batch_size", "8", "--allow_random_frozen", "--n_episodes", "16",
               "--trainer", "dagger", "--dagger_p", "0.75"]


def dagger_phase(label: str, out_dir: str, argv: list, pretrain_names=None) -> dict:
    """``cli.ce_train --trainer dagger`` (``argv``), instrumented: each
    collection rollout and its steps, each update (the PREVALENT BPTT update
    between CUDA events; the glocal agent's update from a stored bundle on
    the host clock, ending in its read-back), each shard written to and read
    from the store, the gather-and-splat and dropout calls against the
    kernels' launches, the parameters that moved. Then ``ckpt_dagger``
    restored into a fresh agent (another seed) must give the trained
    agent's scores (PREVALENT: the first step's action scores of a stored
    batch; glocal: the episode loss of a stored bundle), in eval mode."""
    import numpy as np

    from vln_bevbert_tpu_torch import _build
    from vln_bevbert_tpu_torch.ce import agent as ce_mod
    from vln_bevbert_tpu_torch.ce import dagger as dagger_mod
    from vln_bevbert_tpu_torch.cli import ce_train
    from vln_bevbert_tpu_torch.nav import agent as nav_mod
    from vln_bevbert_tpu_torch.ops import dropout as drop_mod
    from vln_bevbert_tpu_torch.utils import npz_store

    prev, ce, store = dagger_mod.PrevalentDaggerAgent, ce_mod.CEAgent, npz_store.NpzShardStore
    seen = {"gathers": 0, "drop_fwd": 0, "drop_bwd": 0, "rollouts": [], "events": [],
            "updates": [], "writes": [], "reads": [], "steps": 0, "agent": None, "start": None}
    counted_gather = counted_gathers(seen, ce_mod)[1]
    counted_dropout = counting_dropout(seen)[1]

    def host_timed(fn, key, sync=True):
        def wrapper(*args, **kw):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if sync:
                torch.cuda.synchronize()
            seen[key].append(time.perf_counter() - t0)
            return out
        return wrapper

    def step_counted(fn):
        def wrapper(self, *args):
            seen["steps"] += 1
            return fn(self, *args)
        return wrapper

    def rollout_timed(fn):
        def wrapper(self, *args):
            steps0, t0 = seen["steps"], time.perf_counter()
            out = fn(self, *args)
            torch.cuda.synchronize()
            seen["rollouts"].append((time.perf_counter() - t0, seen["steps"] - steps0))
            return out
        return wrapper

    def evented_update(self, batch):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = update(self, batch)
        end.record()
        seen["events"].append((start, end))
        return out

    def recorded_init(fn):
        def wrapper(self, *args, **kw):
            out = fn(self, *args, **kw)
            seen["agent"] = self
            seen["start"] = {n: p.detach().cpu().clone()
                             for n, p in self.model.named_parameters()}
            return out
        return wrapper

    update = prev._update
    patches = [(ce_mod, "gather_and_splat", counted_gather),
               (drop_mod.Dropout, "forward", counted_dropout),
               (prev, "_candidate_features", step_counted(prev._candidate_features)),
               (prev, "_collect_rollout", rollout_timed(prev._collect_rollout)),
               (prev, "_update", evented_update),
               (prev, "init_params", recorded_init(prev.init_params)),
               (ce, "_ce_gmap_variable", step_counted(ce._ce_gmap_variable)),
               (ce, "_ce_rollout", rollout_timed(ce._ce_rollout)),
               (ce, "init_params", recorded_init(ce.init_params)),
               (nav_mod.GMapNavAgent, "learn_from_bundle",
                host_timed(nav_mod.GMapNavAgent.learn_from_bundle, "updates")),
               (store, "append", host_timed(store.append, "writes", sync=False)),
               (store, "get", host_timed(store.get, "reads", sync=False))]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    argv = ["--device", "cuda", "--output_dir", out_dir, *DAGGER_ARGV, *argv]
    try:
        for obj, name, fn in patches:
            setattr(obj, name, fn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        history = ce_train.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"splat": _build.launches("splat"), "dropout": _build.launches("dropout")}
        peak = torch.cuda.max_memory_allocated()
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    agent = seen["agent"]
    prevalent = isinstance(agent, prev)
    use_bev = not prevalent and agent.cfg.model.use_bev
    gathers, drop_calls = seen["gathers"], (seen["drop_fwd"], seen["drop_bwd"])
    if launches["splat"] != gathers or (gathers > 0) != use_bev:
        raise AssertionError(f"{label}: {launches['splat']} splat launches for {gathers} "
                             f"gather-and-splat calls (BEV branch {use_bev})")
    if launches["dropout"] != sum(drop_calls) or drop_calls[1] == 0:
        raise AssertionError(f"{label}: {launches['dropout']} dropout launches for "
                             f"{drop_calls[0]} forward and {drop_calls[1]} backward calls")
    p = float(argv[argv.index("--dagger_p") + 1])
    iters = int(argv[argv.index("--dagger_iters") + 1])
    if history["betas"] != [p ** it if p else 0.0 for it in range(iters)]:
        raise AssertionError(f"{label}: betas {history['betas']}")
    losses = agent.logs["loss" if prevalent else "IL_loss"]
    norms = agent.logs["grad_norm"]
    values = torch.tensor(losses + norms + history["losses"])
    if not losses or not torch.isfinite(values).all() or not (values > 0).all():
        raise AssertionError(f"{label}: losses {losses}, grad norms {norms}")
    unchanged = [n for n, q in agent.model.named_parameters()
                 if torch.equal(q.detach().cpu(), seen["start"][n])]
    if unchanged:
        raise AssertionError(f"{label}: {len(unchanged)} parameters unchanged: {unchanged[:3]}")
    nav_names = set(agent.model.state_dict())
    if pretrain_names is not None and (not nav_names <= pretrain_names
                                       or agent.transferred != len(nav_names)):
        raise AssertionError(f"{label}: {agent.transferred} entries transferred of "
                             f"{len(nav_names)}")
    store_dir = os.path.join(out_dir, "store")
    shards = sorted(f for f in os.listdir(store_dir) if f.endswith(".npz"))

    # the checkpoint, restored into a fresh agent of another seed
    ckpt = os.path.join(out_dir, "ckpt_dagger")
    _, fresh = ce_train.build(ce_train.parse_args(argv + ["--seed", "1"]))
    try:
        fresh.restore_ckpt(ckpt)
        if prevalent:
            batch = next(dagger_mod.DaggerEpisodeStore(store_dir).iter_batches(
                agent.env.batch_size, np.random.default_rng(0)))
            got, want = (prevalent_first_scores(a, batch) for a in (fresh, agent))
        else:
            bundle = store(store_dir).get(0)
            with torch.inference_mode():
                got, want = (a._episode_loss(bundle) for a in (fresh, agent))
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: the restored agent scores "
                                 f"{(got - want).abs().max().item()} away from the trained one")
    finally:
        ce_train.close_env(fresh.env)
    n_params = sum(q.numel() for q in agent.model.parameters())
    out = {"history": history, "wall_s": wall, "launches": launches, "gathers": gathers,
           "drop_fwd": drop_calls[0], "drop_bwd": drop_calls[1], "peak_bytes": peak,
           "params": n_params, "losses": losses, "grad_norms": norms,
           "store_size": len(shards),
           "store_bytes": sum(os.path.getsize(os.path.join(store_dir, f)) for f in shards),
           "transferred": getattr(agent, "transferred", None),
           "rollouts": len(seen["rollouts"]),
           "steps": sum(n for _, n in seen["rollouts"]),
           "ms_per_collect_step": (1e3 * sum(t for t, _ in seen["rollouts"])
                                   / sum(n for _, n in seen["rollouts"])),
           "writes": len(seen["writes"]), "reads": len(seen["reads"]),
           "ms_per_write": 1e3 * sum(seen["writes"]) / len(seen["writes"]),
           "ms_per_read": 1e3 * sum(seen["reads"]) / len(seen["reads"])}
    if prevalent:
        torch.cuda.synchronize()
        ms = [s.elapsed_time(e) for s, e in seen["events"]]
        out.update(updates=len(ms), first_update_ms=ms[0],
                   ms_per_update=sum(ms[1:]) / len(ms[1:]))
    else:
        ups = seen["updates"]
        out.update(updates=len(ups), first_update_ms=1e3 * ups[0],
                   ms_per_update=1e3 * sum(ups[1:]) / len(ups[1:]))
    return out


def prevalent_first_scores(agent, batch):
    """The first recurrent step's action scores of a stacked batch, eval mode."""
    with torch.inference_mode():
        dev = {k: agent._upload(v) for k, v in batch.items()}
        h_t, lang = agent.model("language", {"txt_ids": dev["txt_ids"],
                                             "txt_masks": dev["txt_masks"]})
        lf = torch.cat([h_t[:, None], lang[:, 1:]], dim=1)
        _, scores = agent.model("visual", {
            "lang_embeds": lf, "txt_masks": dev["txt_masks"],
            **{k: dev[k][:, 0].float() for k in ("cand_rgb", "cand_depth", "cand_dir")},
            "cand_masks": dev["cand_masks"][:, 0]})
    return scores


def print_dagger(label: str, run: dict) -> None:
    h = run["history"]
    extra = {}
    if run["transferred"] is not None:
        extra["transferred"] = run["transferred"]
    phase(label, betas=",".join(f"{b:g}" for b in h["betas"]),
          collected=",".join(str(n) for n in h["collected"]), store_size=run["store_size"],
          store_MB_on_disk=f"{run['store_bytes'] / 1e6:.2f}", params=run["params"], **extra,
          collect_rollouts=run["rollouts"], collect_steps=run["steps"],
          ms_per_collect_step=f"{run['ms_per_collect_step']:.2f}", updates=run["updates"],
          ms_per_update=f"{run['ms_per_update']:.2f}",
          first_update_ms=f"{run['first_update_ms']:.1f}",
          shards_written=run["writes"], ms_per_shard_write=f"{run['ms_per_write']:.2f}",
          shards_read=run["reads"], ms_per_shard_read=f"{run['ms_per_read']:.2f}",
          gathers=run["gathers"], splat_launches=run["launches"]["splat"],
          dropout_forward_calls=run["drop_fwd"], dropout_backward_calls=run["drop_bwd"],
          dropout_launches=run["launches"]["dropout"],
          peak_mem_MiB=f"{run['peak_bytes'] / 2**20:.1f}", wall_s=f"{run['wall_s']:.2f}",
          loss=",".join(f"{v:.4g}" for v in h["losses"]),
          grad_norm_last=f"{run['grad_norms'][-1]:.4g}", moved="every parameter",
          ckpt_dagger_restores="equal scores")


def pool_order(episodes: list, workers: int, slots: int, batches: int) -> list:
    """The episodes in the order a pool of ``workers`` x ``slots`` visits them
    (worker w takes every ``workers``-th episode from w, ``slots`` a batch):
    an in-process env over this list sees the same batches, slot by slot."""
    shares = [episodes[w::workers] for w in range(workers)]
    return [ep for k in range(batches) for w in range(workers)
            for ep in shares[w][k * slots:(k + 1) * slots]]


def opens_the_card(pid) -> bool:
    """Whether a process holds a CUDA device file open (a CUDA context does)."""
    fd_dir = f"/proc/{pid}/fd"
    for fd in os.listdir(fd_dir):
        try:
            if os.readlink(os.path.join(fd_dir, fd)).startswith("/dev/nvidia"):
                return True
        except OSError:
            pass
    return False


def ce_pool_phase(out_dir: str, workers=(2, 4), rollouts: int = 3) -> dict:
    """``rollouts`` SS-BEV training rollouts (sampled, ratio 0.75, B=8, full
    width; the replay update left out, so every run starts from the same
    parameters; 16 episodes, so the third rollout starts the second epoch)
    over the same episodes in process and through ``--num_env_workers`` 2
    and 4 (the CLI's pool), from one ``np_rng`` seed: equal trajectories.
    The in-process env visits the episodes in the pool's slot order. Host ms
    per rollout step over all rollouts and the least and most of one
    rollout, and the env's host ms per step (time blocked in
    ``reset``/``begin_observations``/``observations``). No worker holds a
    CUDA device file open, while the parent does."""
    import numpy as np

    from vln_bevbert_tpu_torch.ce.env import SyntheticContinuousEnv
    from vln_bevbert_tpu_torch.cli import ce_train

    argv = ["--device", "cuda", "--batch_size", "8", "--allow_random_frozen", "--n_episodes",
            "16", "--output_dir", out_dir]
    cfg, agent = ce_train.build(ce_train.parse_args(argv))
    agent._learn = lambda lang, records: None
    episodes, B = agent.env.episodes, cfg.batch_size
    if not opens_the_card(os.getpid()):
        raise AssertionError("ce_pool: the parent holds no CUDA device file: the check is blind")

    def run(env):
        env_s = []
        for name in ("reset", "begin_observations", "observations"):
            if hasattr(env, name):
                fn = getattr(env, name)

                def timed(*a, fn=fn, **kw):
                    t0 = time.perf_counter()
                    out = fn(*a, **kw)
                    env_s.append(time.perf_counter() - t0)
                    return out

                setattr(env, name, timed)
        agent.env = env
        agent.np_rng = np.random.default_rng(cfg.seed)
        env.reset_epoch()
        steps, secs, trajs = [], [], []
        gmap_var = agent._ce_gmap_variable
        agent._ce_gmap_variable = lambda *a: steps.append(1) or gmap_var(*a)
        try:
            for _ in range(rollouts):
                n0 = len(steps)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trajs += agent.rollout(feedback="sample", train=True, sample_ratio=0.75)[0]
                torch.cuda.synchronize()
                secs.append((time.perf_counter() - t0, len(steps) - n0))
        finally:
            del agent._ce_gmap_variable
        per = [1e3 * s / k for s, k in secs]
        return trajs, {"steps": len(steps), "ms_per_step": 1e3 * sum(s for s, _ in secs) / len(steps),
                       "ms_range": (min(per), max(per)),
                       "env_ms_per_step": 1e3 * sum(env_s) / len(steps)}

    out = {}
    for n in workers:
        order = pool_order(episodes, n, B // n, len(episodes) // B)
        inproc = SyntheticContinuousEnv(order, batch_size=B, seed=cfg.seed,
                                        grid_hw=cfg.shapes.grid_hw,
                                        grid_feat_size=cfg.model.bev_grid_feat_size,
                                        view_feat_size=cfg.model.image_feat_size)
        ref, ref_t = run(inproc)
        pool = ce_train.build_env(cfg, ce_train.parse_args(argv + ["--num_env_workers", str(n)]))
        try:
            got, got_t = run(pool)
            pids = [w.proc.pid for w in pool.workers]
            on_card = [pid for pid in pids if opens_the_card(pid)]
        finally:
            ce_train.close_env(pool)
        if on_card:
            raise AssertionError(f"ce_pool: workers {on_card} hold a CUDA device file open")
        if len(got) != len(ref) or len(ref) != rollouts * B:
            raise AssertionError(f"ce_pool: {len(got)} / {len(ref)} trajectories")
        for a, b in zip(got, ref):
            if not (a["instr_id"] == b["instr_id"] and a["headings"] == b["headings"]
                    and np.array_equal(np.stack(a["positions"]), np.stack(b["positions"]))):
                raise AssertionError(f"ce_pool: {n} workers walk {a['instr_id']} otherwise")
        out[n] = {"inproc": ref_t, "pool": got_t, "workers": len(pids), "rollouts": rollouts}
    return out


# ------------------------------------------------------------- data parallel
# Two gloo ranks share the one card: NCCL refuses two ranks on one device,
# and the run needs one card. The parent has started CUDA, so the ranks are
# spawned, not forked; the operator library is built (build_phase) before
# any rank loads it. gloo's all-reduce of CUDA tensors stages them through
# the host, so the ranks' step times are no multi-card number.
DP_WORLD = 2
DP_TIMEOUT_S = 300.0
GLOO_NOTE = "gloo stages the float32 gradients through the host: not a multi-card time"
PER_STEP_NOTE = "eager steps: a CUDA graph cannot capture gloo's collectives"
# ranks against one process at the global batch: the same rows and dropout
# masks, bf16 activations over another batch shape (16 against 32 rows, 4
# against 8). Measured on the H100: pretraining losses within 4.5e-05 and
# gradient norms within 3.7e-04 over 4 steps, the replay's loss equal, its
# gradient norm within 6.7e-05 and its gradients' relative L2 difference
# 1.6e-03; the bounds are ten times that or more. A wrong normaliser or
# other masks move the first loss by far more.
DP_PRETRAIN_RTOL = {"loss": 1e-3, "grad_norm": 5e-3}
DP_REPLAY_RTOL = {"loss": 1e-3, "grad_norm": 1e-3, "grad_rel_l2": 2e-2}


def _dp_rank(rank: int, fn, spec: dict) -> None:
    """Rank ``rank`` of a gloo group on cuda:0 joined over ``spec["store"]``;
    ``fn(spec)``'s result into ``<spec["work"]>/rank<rank>.pt``."""
    from vln_bevbert_tpu_torch.parallel import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize("cuda:0", backend="gloo", init_method="file://" + spec["store"],
                           rank=rank, world_size=DP_WORLD, timeout_s=DP_TIMEOUT_S)
    try:
        torch.save(fn(spec), os.path.join(spec["work"], f"rank{rank}.pt"))
    finally:
        distributed.shutdown()


def dp_spawn(fn, spec: dict) -> list:
    """``fn(spec)`` in DP_WORLD spawned gloo ranks on the one card; their
    results, rank order. A rank that raises fails the call."""
    import torch.multiprocessing as mp

    os.makedirs(spec["work"], exist_ok=True)
    spec = dict(spec, store=os.path.join(spec["work"], "store"))
    mp.spawn(_dp_rank, args=(fn, spec), nprocs=DP_WORLD, join=True)
    return [torch.load(os.path.join(spec["work"], f"rank{r}.pt"), weights_only=False)
            for r in range(DP_WORLD)]


def dp_pretrain_run(spec: dict) -> dict:
    """``cli.pretrain`` built from ``spec["argv"]`` and trained (saved too
    with ``spec["save"]``, as its ``main`` does) in this process, which may
    be a rank, instrumented (``instrumented_training``): per step its task,
    loss, gradient norm and CUDA-event ms (of a graph replay, or of an
    eager block of one step under gloo); the kernels' launches against the
    dropout and ``prepare_bev`` calls; the gradient all-reduce's CUDA-event
    ms, per step where the steps ran eagerly, or (a graph's all-reduce
    cannot be timed apart) over 5 eager all-reduces of the same buffers
    after training where they were replays; peak memory; the process group
    it ran in."""
    import torch.distributed as dist

    from vln_bevbert_tpu_torch import _build
    from vln_bevbert_tpu_torch.cli import pretrain
    from vln_bevbert_tpu_torch.parallel import distributed

    _build.load()
    trainer = pretrain.build(pretrain.parse_args(spec["argv"]))
    with instrumented_training(trainer, {}, timed_reduce=True) as seen:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: _build.launches(k) for k in ("splat", "dropout")}
    graphs = trainer.block_fn.graphs.counters()
    graphed = graphs["replays"] > 0
    reduce_ms = [s.elapsed_time(e) for s, e in seen["reduce"]]
    if graphed:
        reduce_ms = [cuda_ms(trainer.state.all_reduce_grads, iters=1, warmup=0 if i else 1)
                     for i in range(5)]
    values = torch.stack([torch.stack([m["loss"], m["grad_norm"]])
                          for *_, m in seen["steps"]]).tolist()
    out = {"rank": distributed.rank(), "world": distributed.world_size(),
           "backend": dist.get_backend() if distributed.active() else None,
           "rows": trainer.train_loader.cfg.train_batch_size, "graphed": graphed,
           "blocks": seen["blocks"], "captures": graphs["captures"],
           "replays": graphs["replays"], "reduces": seen["reduces"],
           "tasks": [t for t, *_ in seen["steps"]], "loss": [v[0] for v in values],
           "grad_norm": [v[1] for v in values],
           "ms": [s.elapsed_time(e) for _, s, e, _ in seen["steps"]],
           "reduce_ms": reduce_ms,
           "launches": launches, "drop_fwd": seen["drop_fwd"], "drop_bwd": seen["drop_bwd"],
           "bev": seen["bev"], "peak_bytes": torch.cuda.max_memory_allocated(), "wall_s": wall,
           "grad_bytes": sum(f.numel() * f.element_size() for f in trainer.state.flat_grads),
           "n_params": sum(p.numel() for p in trainer.state.params)}
    if spec.get("save"):
        out["ckpt"] = trainer.save(trainer.state.step)
    return out


def check_dp_launches(label: str, run: dict) -> None:
    """Both kernels launched, as often as the path called them."""
    launches = run["launches"]
    if launches["splat"] != run["bev"] or run["bev"] == 0:
        raise AssertionError(f"{label}: {launches['splat']} splat launches for {run['bev']} "
                             "prepare_bev calls")
    if launches["dropout"] != run["drop_fwd"] + run["drop_bwd"] or run["drop_bwd"] == 0:
        raise AssertionError(f"{label}: {launches['dropout']} dropout launches for "
                             f"{run['drop_fwd']} forward and {run['drop_bwd']} backward calls")


def rel_diff(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def dp_pretrain_phase(out_dir: str, steps: int = 4, per_rank: int = 16) -> dict:
    """Full-width pretraining (``PretrainConfig()``, 238,831,719 parameters)
    in two gloo ranks on the one card (eager steps), ``per_rank`` rows
    each, for ``steps`` steps at the first seed whose per-step task draws
    (``task_block_size`` 1) include mlm, sap and masksem; then one process
    at the global batch from the same seed (graph replays, blocks of one
    step). The ranks compute what it computes: the same rows
    and dropout masks; losses and gradient norms agree to bf16 rounding over
    another batch shape (``DP_PRETRAIN_RTOL``)."""
    from vln_bevbert_tpu_torch.configs import PretrainConfig
    from vln_bevbert_tpu_torch.data.loader import MetaLoader

    cfg = PretrainConfig()
    seed = next(s for s in range(1000) if {"mlm", "sap", "masksem"} <= {
        MetaLoader(cfg.tasks, cfg.mix_ratio, s).task_for_step(t) for t in range(steps)})
    config = os.path.join(out_dir, "per_step_tasks.json")
    os.makedirs(out_dir, exist_ok=True)
    with open(config, "w") as f:
        json.dump({"task_block_size": 1}, f)
    argv = ["--synthetic", "--device", "cuda", "--num_steps", str(steps), "--seed", str(seed),
            "--config", config, "--output_dir", os.path.join(out_dir, "out")]
    ranks = dp_spawn(dp_pretrain_run, {"work": os.path.join(out_dir, "ranks"),
                                       "argv": argv + ["--batch_size", str(per_rank)]})
    free_memory()
    one = dp_pretrain_run({"argv": argv + ["--batch_size", str(DP_WORLD * per_rank)]})
    for r in ranks:
        if (r["world"], r["backend"], r["rows"], r["tasks"]) != (
                DP_WORLD, "gloo", per_rank, one["tasks"]):
            raise AssertionError(f"dp_pretrain: rank {r['rank']} ran {r['world']} "
                                 f"{r['backend']} {r['rows']} {r['tasks']}")
        if (r["loss"], r["grad_norm"]) != (ranks[0]["loss"], ranks[0]["grad_norm"]):
            raise AssertionError("dp_pretrain: the ranks report different global numbers")
        check_dp_launches(f"dp_pretrain rank {r['rank']}", r)
    check_dp_launches("dp_pretrain one process", one)
    diffs = {"loss": [rel_diff(a, b) for a, b in zip(ranks[0]["loss"], one["loss"])],
             "grad_norm": [rel_diff(a, b) for a, b in zip(ranks[0]["grad_norm"],
                                                          one["grad_norm"])]}
    for key, tol in DP_PRETRAIN_RTOL.items():
        if max(diffs[key]) > tol:
            raise AssertionError(f"dp_pretrain: {key} differs from one process's by "
                                 f"{diffs[key]} (rtol {tol})")
    return {"seed": seed, "ranks": ranks, "one": one, "diffs": diffs}


def dp_replay_run(spec: dict) -> dict:
    """One replay update of a ``spec["cfg"]`` agent (random parameters from
    ``spec["seed"]``) from this rank's rows of ``spec["rb"]``: the loss, the
    gradient norm, the summed gradients before the clip (rank 0, on the
    host), CUDA-event ms, the dropout launches against its calls."""
    from vln_bevbert_tpu_torch import _build
    from vln_bevbert_tpu_torch.nav.agent import make_replay_agent
    from vln_bevbert_tpu_torch.ops import dropout as drop_mod
    from vln_bevbert_tpu_torch.parallel import distributed
    from vln_bevbert_tpu_torch.parallel.mesh import shard_replay_bundle

    _build.load()
    rank, world = distributed.rank(), distributed.world_size()
    rb = spec["rb"]
    agent = make_replay_agent(spec["cfg"], rb["targets"].shape[1] // world, seed=spec["seed"],
                              device="cuda")
    state = agent.train_state
    seen = {"drop_fwd": 0, "drop_bwd": 0}
    apply = state.apply_gradients

    def snapshot(moves=None):
        if rank == 0:
            seen["grads"] = torch.cat([f.float().cpu() for f in state.flat_grads])
        return apply(moves)

    forward, counted = counting_dropout(seen)
    drop_mod.Dropout.forward, state.apply_gradients = counted, snapshot
    local = shard_replay_bundle(rb, rank, world)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        loss = agent.learn_from_bundle(local)
        end.record()
        torch.cuda.synchronize()
    finally:
        drop_mod.Dropout.forward = forward
    return {"rank": rank, "world": world, "loss": loss, "grad_norm": agent.logs["grad_norm"][-1],
            "grads": seen.get("grads"), "ms": start.elapsed_time(end),
            "launches": {k: _build.launches(k) for k in ("splat", "dropout")},
            "drop_fwd": seen["drop_fwd"], "drop_bwd": seen["drop_bwd"],
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "grad_bytes": sum(f.numel() * f.element_size() for f in state.flat_grads)}


def dp_replay_phase(out_dir: str, batch: int = 8) -> dict:
    """A teacher rollout of the full-width fine-tuning agent (``cli.finetune
    --synthetic --batch_size 8``) packed as the replay bundle it trains from,
    then one replay update from it in two gloo ranks (4 rows each) and in
    one process (8 rows), all from the same random parameters: the same loss
    and gradient up to bf16 rounding over another batch shape."""
    cfg, rb, teacher = replay_bundle(out_dir, batch)
    free_memory()
    spec = {"work": os.path.join(out_dir, "ranks"), "cfg": cfg, "rb": rb, "seed": cfg.seed}
    ranks = dp_spawn(dp_replay_run, spec)
    free_memory()
    one = dp_replay_run(spec)
    for r in ranks:
        if (r["loss"], r["grad_norm"]) != (ranks[0]["loss"], ranks[0]["grad_norm"]):
            raise AssertionError("dp_replay: the ranks report different global numbers")
        launches = r["launches"]
        if (launches["dropout"] != r["drop_fwd"] + r["drop_bwd"] or r["drop_bwd"] == 0
                or launches["splat"] != 0):
            raise AssertionError(f"dp_replay rank {r['rank']}: launches {launches} for "
                                 f"{r['drop_fwd']} + {r['drop_bwd']} dropout calls")
    g, g1 = ranks[0]["grads"], one["grads"]
    diffs = {"loss": rel_diff(ranks[0]["loss"], one["loss"]),
             "grad_norm": rel_diff(ranks[0]["grad_norm"], one["grad_norm"]),
             "grad_rel_l2": float((g - g1).norm() / g1.norm()),
             "grad_max_abs": float((g - g1).abs().max()), "grad_scale": float(g1.abs().max())}
    for key, tol in DP_REPLAY_RTOL.items():
        if diffs[key] > tol:
            raise AssertionError(f"dp_replay: {key} {diffs[key]:.3e} against one process "
                                 f"(tolerance {tol})")
    for r in ranks + [one]:
        r.pop("grads")
    return {"ranks": ranks, "one": one, "diffs": diffs, "teacher": teacher,
            "steps": int((rb["targets"] != -100).any(axis=1).sum())}


# dp_ce runs float32 activations: the ranks' GEMMs run at 4 rows where the
# one process's run at 8, so bf16 rounding would differ between them, and
# the rollout's sampled actions and waypoints are discrete draws from those
# numbers. In float32 (TF32 off) they differ by ~1e-7, far below a draw's
# chance of landing on a boundary. The waypoint head is sharpened (x100),
# as in the small phase, so that its NMS peaks stand far apart.
DP_CE_CONFIG = {"model": {"dtype": "float32"}}
DP_CE_ROWS = 4  # per rank


@contextlib.contextmanager
def eval_moves_timed(moves: dict, env):
    """Within: host ms in ``CEAgent._act`` (the step's moves: this rank's
    low-level control) and in ``_in_rank_turns`` (those moves plus the
    wait for the other ranks' turns and the coin-count gathers), the
    ``_act`` calls, and ``env``'s control steps, added into ``moves``."""
    from vln_bevbert_tpu_torch.ce.agent import CEAgent

    def timed(fn, key, count=None):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                moves[key] += 1e3 * (time.perf_counter() - t0)
                if count:
                    moves[count] += 1
        return wrapper

    def counted(fn, key):
        def wrapper(*args, **kw):
            moves[key] += 1
            return fn(*args, **kw)
        return wrapper

    act, turns = CEAgent._act, CEAgent._in_rank_turns
    CEAgent._act, CEAgent._in_rank_turns = timed(act, "act_ms", "act"), timed(turns, "turns_ms")
    for key in ("forward_step", "rotate"):
        setattr(env, key, counted(getattr(env, key), key))
    try:
        yield
    finally:
        CEAgent._act, CEAgent._in_rank_turns = act, turns
        for key in ("forward_step", "rotate"):
            delattr(env, key)


def dp_ce_run(spec: dict) -> dict:
    """In this process (a rank, or the one process at the global batch):
    ``cli.ce_train``'s SS-BEV and SS-ETP agents built from ``spec["argv"]``
    (the batch per rank), the waypoint heads sharpened, ``np_rng`` seeded
    11; an SS-BEV sampled training rollout (waypoint sampling, ghost noise,
    sample ratio 0.5) with its replay update, a merged greedy evaluation
    (low-level control), then an SS-ETP sampled training rollout (its bundle
    kept, not trained on). Trajectories, ``np_rng`` states, the update's
    loss, gradient norm and summed gradients before the clip (rank 0, on the
    host), the eval metrics; gather-and-splat and dropout calls against the
    kernels' launches over the whole run; ms of each part."""
    import numpy as np

    from vln_bevbert_tpu_torch import _build
    from vln_bevbert_tpu_torch.ce import agent as ce_mod
    from vln_bevbert_tpu_torch.cli import ce_train
    from vln_bevbert_tpu_torch.ops import dropout as drop_mod
    from vln_bevbert_tpu_torch.parallel import distributed
    from vln_bevbert_tpu_torch.parallel.train_step import TrainState

    _build.load()
    rank = distributed.rank()
    agents = {}
    for trainer in ("ss-bev", "ss-etp"):
        _, agent = ce_train.build(ce_train.parse_args(spec["argv"] + ["--trainer", trainer]))
        with torch.no_grad():
            agent.wp_model.cls_fc2.weight.mul_(100.0)
        agent.np_rng = np.random.default_rng(11)
        agents[trainer] = agent
    seen = {"gathers": 0, "drop_fwd": 0, "drop_bwd": 0}
    forward, counted = counting_dropout(seen)
    gather, gathers = counted_gathers(seen, ce_mod)
    apply = TrainState.apply_gradients

    def snapshot(state, moves=None):
        if rank == 0:
            seen["grads"] = torch.cat([f.float().cpu() for f in state.flat_grads])
        return apply(state, moves)

    def paths(trajs):
        return [(tr["instr_id"], np.stack(tr["positions"]).tolist(), list(tr["headings"]))
                for tr in trajs]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    out = {"rank": rank, "world": distributed.world_size()}
    drop_mod.Dropout.forward, ce_mod.gather_and_splat = counted, gathers
    TrainState.apply_gradients = snapshot
    try:
        torch.cuda.synchronize()
        _build.reset_launches()
        bev, etp = agents["ss-bev"], agents["ss-etp"]
        (trajs, loss), out["bev_ms"] = timed(lambda: bev.rollout("sample", True, 0.5))
        out.update(bev_paths=paths(trajs), bev_rng=bev.np_rng.bit_generator.state, loss=loss,
                   grad_norm=bev.logs["grad_norm"][-1], grads=seen.pop("grads", None))
        moves = {"act_ms": 0.0, "turns_ms": 0.0, "act": 0, "forward_step": 0, "rotate": 0}
        with eval_moves_timed(moves, bev.env):
            out["eval"], out["eval_ms"] = timed(lambda: bev.evaluate(num_batches=1))
        out.update(eval_rng=bev.np_rng.bit_generator.state, eval_moves=moves)
        etp.learn_from_bundle = lambda rb: 0.0  # the rollout alone
        (trajs, _), out["etp_ms"] = timed(lambda: etp.rollout("sample", True, 0.5))
        out.update(etp_paths=paths(trajs), etp_rng=etp.np_rng.bit_generator.state)
        torch.cuda.synchronize()
        out["launches"] = {k: _build.launches(k) for k in ("splat", "dropout")}
    finally:
        drop_mod.Dropout.forward, ce_mod.gather_and_splat = forward, gather
        TrainState.apply_gradients = apply
    out.update(gathers=seen["gathers"], drop_fwd=seen["drop_fwd"], drop_bwd=seen["drop_bwd"],
               peak_bytes=torch.cuda.max_memory_allocated())
    return out


def dp_ce_phase(out_dir: str) -> dict:
    """CE under data parallelism at full width (``cli.ce_train``'s defaults
    but float32 activations, ``DP_CE_CONFIG``): two gloo ranks of
    ``DP_CE_ROWS`` rows on the one card against one process at the global
    batch (``dp_ce_run``). The ranks' trajectories, concatenated, equal the
    one process's, every rank's ``np_rng`` ends where its does, the update's
    loss, gradient norm and gradients are within ``DP_REPLAY_RTOL``, the
    merged eval metrics agree to float rounding; on every rank the splat
    launches equal its gather-and-splat calls and the dropout launches its
    dropout calls."""
    os.makedirs(out_dir, exist_ok=True)
    config = os.path.join(out_dir, "dp_ce.json")
    with open(config, "w") as f:
        json.dump(DP_CE_CONFIG, f)
    argv = ["--device", "cuda", "--config", config, "--allow_random_frozen", "--n_episodes",
            "16", "--ghost_aug", "0.3", "--output_dir", os.path.join(out_dir, "out")]
    ranks = dp_spawn(dp_ce_run, {"work": os.path.join(out_dir, "ranks"),
                                 "argv": argv + ["--batch_size", str(DP_CE_ROWS)]})
    free_memory()
    one = dp_ce_run({"argv": argv + ["--batch_size", str(DP_WORLD * DP_CE_ROWS)]})
    for key in ("bev", "etp"):
        if sum((r[f"{key}_paths"] for r in ranks), []) != one[f"{key}_paths"]:
            raise AssertionError(f"dp_ce: the ranks' {key} trajectories differ from one process's")
        if any(r[f"{key}_rng"] != one[f"{key}_rng"] for r in ranks):
            raise AssertionError(f"dp_ce: a rank's np_rng differs after the {key} rollout")
    if any(r["eval_rng"] != one["eval_rng"] for r in ranks):
        raise AssertionError("dp_ce: a rank's np_rng differs after the evaluation")
    for r in ranks:
        if (r["loss"], r["grad_norm"], r["eval"]) != (ranks[0]["loss"], ranks[0]["grad_norm"],
                                                      ranks[0]["eval"]):
            raise AssertionError("dp_ce: the ranks report different global numbers")
    for r in ranks + [one]:
        launches = r["launches"]
        if launches["splat"] != r["gathers"] or r["gathers"] == 0:
            raise AssertionError(f"dp_ce rank {r['rank']}: {launches['splat']} splat launches "
                                 f"for {r['gathers']} gather-and-splat calls")
        if launches["dropout"] != r["drop_fwd"] + r["drop_bwd"] or r["drop_bwd"] == 0:
            raise AssertionError(f"dp_ce rank {r['rank']}: {launches['dropout']} dropout "
                                 f"launches for {r['drop_fwd']} + {r['drop_bwd']} calls")
    g, g1 = ranks[0]["grads"], one["grads"]
    diffs = {"loss": rel_diff(ranks[0]["loss"], one["loss"]),
             "grad_norm": rel_diff(ranks[0]["grad_norm"], one["grad_norm"]),
             "grad_rel_l2": float((g - g1).norm() / g1.norm())}
    for key, tol in DP_REPLAY_RTOL.items():
        if diffs[key] > tol:
            raise AssertionError(f"dp_ce: {key} {diffs[key]:.3e} against one process "
                                 f"(tolerance {tol})")
    diffs["eval"] = max(rel_diff(ranks[0]["eval"][k], v) for k, v in one["eval"].items())
    if diffs["eval"] > 1e-9:
        raise AssertionError(f"dp_ce: merged eval metrics {ranks[0]['eval']} against "
                             f"{one['eval']}")
    for r in ranks + [one]:
        r.pop("grads")
    return {"ranks": ranks, "one": one, "diffs": diffs}


def torchrun_pretrain(out_json: str, argv: list) -> None:
    """The body of ``cli.pretrain``'s ``main`` (build, train, save) under
    ``torch.distributed.run``, instrumented (``dp_pretrain_run``); the record
    into ``out_json``."""
    from vln_bevbert_tpu_torch.parallel import distributed

    try:
        record = dp_pretrain_run({"argv": argv, "save": True})
    finally:
        distributed.shutdown()
    with open(out_json, "w") as f:
        json.dump(record, f)


def torchrun_finetune(out_json: str, argv: list) -> None:
    """``cli.finetune``'s ``main`` under ``torch.distributed.run``, with
    the splat launches counted against the gather-and-splat calls and the
    dropout launches against its forward and backward calls (from 0 just
    before it); the record into ``out_json``."""
    import torch.distributed as dist

    from vln_bevbert_tpu_torch import _build
    from vln_bevbert_tpu_torch.cli import finetune
    from vln_bevbert_tpu_torch.nav import agent as agent_mod
    from vln_bevbert_tpu_torch.ops import dropout as drop_mod
    from vln_bevbert_tpu_torch.parallel import distributed

    _build.load()
    seen = {"gathers": 0, "drop_fwd": 0, "drop_bwd": 0}
    gather, counted_gather = counted_gathers(seen, agent_mod)
    forward, counted = counting_dropout(seen)

    agent_mod.gather_and_splat, drop_mod.Dropout.forward = counted_gather, counted
    try:
        _build.reset_launches()
        results = finetune.main(argv)
        record = {**seen, "results": results, "rank": distributed.rank(),
                  "world": distributed.world_size(),
                  "backend": dist.get_backend() if distributed.active() else None,
                  "launches": {k: _build.launches(k) for k in ("splat", "dropout")}}
    finally:
        agent_mod.gather_and_splat, drop_mod.Dropout.forward = gather, forward
        distributed.shutdown()
    with open(out_json, "w") as f:
        json.dump(record, f)


def torchrun_ce(out_json: str, argv: list) -> None:
    """``cli.ce_train``'s ``main`` under ``torch.distributed.run``, with the
    splat launches counted against the gather-and-splat calls and the
    dropout launches against its forward and backward calls (from 0 just
    before it); the record into ``out_json``."""
    import torch.distributed as dist

    from vln_bevbert_tpu_torch import _build
    from vln_bevbert_tpu_torch.ce import agent as ce_mod
    from vln_bevbert_tpu_torch.cli import ce_train
    from vln_bevbert_tpu_torch.ops import dropout as drop_mod
    from vln_bevbert_tpu_torch.parallel import distributed

    _build.load()
    seen = {"gathers": 0, "drop_fwd": 0, "drop_bwd": 0}
    forward, counted = counting_dropout(seen)
    gather, gathers = counted_gathers(seen, ce_mod)
    ce_mod.gather_and_splat, drop_mod.Dropout.forward = gathers, counted
    try:
        _build.reset_launches()
        t0 = time.perf_counter()
        results = ce_train.main(argv)
        record = {**seen, "results": results, "rank": distributed.rank(),
                  "world": distributed.world_size(), "wall_s": time.perf_counter() - t0,
                  "backend": dist.get_backend() if distributed.active() else None,
                  "launches": {k: _build.launches(k) for k in ("splat", "dropout")}}
    finally:
        ce_mod.gather_and_splat, drop_mod.Dropout.forward = gather, forward
        distributed.shutdown()
    with open(out_json, "w") as f:
        json.dump(record, f)


def dp_nccl_phase(out_dir: str, plain_ms_per_task: dict, timeout_s: float = 300.0) -> dict:
    """The CLIs as users launch them, under ``torch.distributed.run`` at
    world size 1 on NCCL: pretraining (``--synthetic --device cuda
    --num_steps 8``, through ``torchrun_pretrain``: one block of 8 graph
    replays, the NCCL all-reduces captured in the graph), then
    ``cli.finetune --iters 1`` from its checkpoint (through
    ``torchrun_finetune``). Per step ms against the plain run's (the
    ``train`` phase's, same task) and the gradient all-reduce's ms (eager,
    after training); both kernels' launches in both runs."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": here + os.pathsep + os.environ.get("PYTHONPATH", "")}
    launcher = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "1"]
    record = os.path.join(out_dir, "pretrain.json")
    t0 = time.perf_counter()
    subprocess.run(launcher + [os.path.abspath(__file__), "--torchrun-pretrain", record,
                               "--synthetic", "--device", "cuda", "--num_steps", "8",
                               "--output_dir", os.path.join(out_dir, "pretrain")],
                   check=True, timeout=timeout_s, cwd=here, env=env)
    pre_wall = time.perf_counter() - t0
    with open(record) as f:
        pre = json.load(f)
    if (pre["backend"], pre["world"]) != ("nccl", 1) or not os.path.exists(pre["ckpt"]):
        raise AssertionError(f"dp_nccl: ran {pre['backend']} at world {pre['world']}, "
                             f"checkpoint {pre['ckpt']}")
    check_dp_launches("dp_nccl", pre)
    if not pre["graphed"] or pre["replays"] != 8 or pre["reduces"] != 8 + pre["captures"]:
        raise AssertionError(f"dp_nccl: {pre['replays']} graph replays and {pre['reduces']} "
                             f"gradient all-reduces ({pre['captures']} captures) in 8 steps")
    task = pre["tasks"][0]
    ft_dir, ft_record = os.path.join(out_dir, "finetune"), os.path.join(out_dir, "finetune.json")
    t0 = time.perf_counter()
    subprocess.run(launcher + [os.path.abspath(__file__), "--torchrun-finetune", ft_record,
                               "--synthetic", "--device", "cuda", "--pretrain_ckpt", pre["ckpt"],
                               "--iters", "1", "--log_every", "1", "--output_dir", ft_dir],
                   check=True, timeout=timeout_s, cwd=here, env=env)
    ft_wall = time.perf_counter() - t0
    with open(ft_record) as f:
        ft = json.load(f)
    if (ft["backend"], ft["world"]) != ("nccl", 1):
        raise AssertionError(f"dp_nccl: fine-tuning ran {ft['backend']} at world {ft['world']}")
    launches = ft["launches"]
    if launches["splat"] != ft["gathers"] or ft["gathers"] == 0:
        raise AssertionError(f"dp_nccl: fine-tuning made {launches['splat']} splat launches "
                             f"for {ft['gathers']} gather-and-splat calls")
    if launches["dropout"] != ft["drop_fwd"] + ft["drop_bwd"] or ft["drop_bwd"] == 0:
        raise AssertionError(f"dp_nccl: fine-tuning made {launches['dropout']} dropout launches "
                             f"for {ft['drop_fwd']} forward and {ft['drop_bwd']} backward calls")
    with open(os.path.join(ft_dir, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    il = [r["train/IL_loss"] for r in logged if "train/IL_loss" in r]
    transferred = [r["pretrain/transferred"] for r in logged if "pretrain/transferred" in r]
    if not (il and il[0] == il[0] and il[0] > 0 and transferred
            and os.path.exists(os.path.join(ft_dir, "ckpt_latest"))):
        raise AssertionError(f"dp_nccl: fine-tuning logged {logged}")
    ce, ce_loss = dp_nccl_ce(out_dir, timeout_s)
    return {"pre": pre, "task": task, "ms": sum(pre["ms"][1:]) / len(pre["ms"][1:]),
            "reduce_ms": sum(pre["reduce_ms"][1:]) / len(pre["reduce_ms"][1:]),
            "plain_ms": plain_ms_per_task[task], "pre_wall_s": pre_wall,
            "ft_wall_s": ft_wall, "il_loss": il[0], "transferred": transferred[0], "ft": ft,
            "ce": ce, "ce_loss": ce_loss}


def dp_nccl_ce(out_dir: str, timeout_s: float = 300.0) -> tuple:
    """``cli.ce_train`` (SS-BEV at the CLI's defaults, B=8: one iteration,
    its evaluation and ``ckpt_1``) under ``torch.distributed.run`` at world
    size 1 on NCCL, through ``torchrun_ce``: (its record, its loss); both
    kernels' launches equal their calls."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": here + os.pathsep + os.environ.get("PYTHONPATH", "")}
    launcher = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "1"]
    ce_dir, ce_record = os.path.join(out_dir, "ce"), os.path.join(out_dir, "ce.json")
    subprocess.run(launcher + [os.path.abspath(__file__), "--torchrun-ce", ce_record,
                               "--device", "cuda", "--batch_size", "8", "--allow_random_frozen",
                               "--n_episodes", "16", "--iters", "1", "--log_every", "1",
                               "--output_dir", ce_dir],
                   check=True, timeout=timeout_s, cwd=here, env=env)
    with open(ce_record) as f:
        ce = json.load(f)
    if (ce["backend"], ce["world"]) != ("nccl", 1):
        raise AssertionError(f"dp_nccl: CE training ran {ce['backend']} at world {ce['world']}")
    launches = ce["launches"]
    if launches["splat"] != ce["gathers"] or ce["gathers"] == 0:
        raise AssertionError(f"dp_nccl: CE training made {launches['splat']} splat launches "
                             f"for {ce['gathers']} gather-and-splat calls")
    if launches["dropout"] != ce["drop_fwd"] + ce["drop_bwd"] or ce["drop_bwd"] == 0:
        raise AssertionError(f"dp_nccl: CE training made {launches['dropout']} dropout launches "
                             f"for {ce['drop_fwd']} forward and {ce['drop_bwd']} backward calls")
    with open(os.path.join(ce_dir, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    loss = [r["train/loss"] for r in logged if "train/loss" in r]
    if not (loss and loss[0] == loss[0] and loss[0] > 0
            and os.path.exists(os.path.join(ce_dir, "ckpt_1"))):
        raise AssertionError(f"dp_nccl: CE training logged {logged}")
    return ce, loss[0]


def dp_group(plain_ms_per_task: dict) -> tuple:
    """The data-parallel phases, printed: dp_pretrain, dp_replay, dp_nccl
    (against the plain run's ms per step and task)."""
    free_memory()
    work = tempfile.TemporaryDirectory()
    dpp = dp_pretrain_phase(os.path.join(work.name, "dp_pretrain"))
    one = dpp["one"]
    for r in dpp["ranks"]:
        phase("dp_pretrain", rank=r["rank"], world=r["world"], backend=r["backend"],
              rows=r["rows"], seed=dpp["seed"], tasks=",".join(r["tasks"]),
              splat_launches=r["launches"]["splat"], prepare_bev_calls=r["bev"],
              dropout_launches=r["launches"]["dropout"],
              dropout_calls=f"{r['drop_fwd']}+{r['drop_bwd']}",
              ms_per_step=",".join(f"{v:.2f}" for v in r["ms"]),
              allreduce_ms=",".join(f"{v:.2f}" for v in r["reduce_ms"]),
              peak_mem_MiB=f"{r['peak_bytes'] / 2**20:.1f}", note=repr(GLOO_NOTE),
              loop=repr(PER_STEP_NOTE))
    phase("dp_pretrain", one_process_rows=DP_WORLD * dpp["ranks"][0]["rows"],
          params=one["n_params"], grad_MB=f"{one['grad_bytes'] / 1e6:.1f}",
          first_loss=f"{dpp['ranks'][0]['loss'][0]:.6f}/{one['loss'][0]:.6f}",
          first_grad_norm=f"{dpp['ranks'][0]['grad_norm'][0]:.6f}/{one['grad_norm'][0]:.6f}",
          loss_ranks=",".join(f"{v:.6f}" for v in dpp["ranks"][0]["loss"]),
          loss_one=",".join(f"{v:.6f}" for v in one["loss"]),
          loss_rel_diff=",".join(f"{v:.2e}" for v in dpp["diffs"]["loss"]),
          grad_norm_rel_diff=",".join(f"{v:.2e}" for v in dpp["diffs"]["grad_norm"]),
          ms_per_step_one=",".join(f"{v:.2f}" for v in one["ms"]),
          splat_launches_one=one["launches"]["splat"],
          dropout_launches_one=one["launches"]["dropout"],
          peak_mem_MiB_one=f"{one['peak_bytes'] / 2**20:.1f}")
    free_memory()
    dpr = dp_replay_phase(os.path.join(work.name, "dp_replay"))
    for r in dpr["ranks"] + [dpr["one"]]:
        phase("dp_replay", rank=r["rank"], world=r["world"], rows=8 // r["world"],
              loss=f"{r['loss']:.6f}", grad_norm=f"{r['grad_norm']:.6f}",
              dropout_launches=r["launches"]["dropout"],
              dropout_calls=f"{r['drop_fwd']}+{r['drop_bwd']}",
              splat_launches=r["launches"]["splat"], ms=f"{r['ms']:.2f}",
              grad_MB=f"{r['grad_bytes'] / 1e6:.1f}",
              peak_mem_MiB=f"{r['peak_bytes'] / 2**20:.1f}")
    phase("dp_replay", teacher_rows=8, teacher_gathers=dpr["teacher"]["gathers"],
          teacher_splat_launches=dpr["teacher"]["launches"])
    phase("dp_replay", steps=dpr["steps"], **{k: f"{v:.3e}" for k, v in dpr["diffs"].items()},
          note=repr(GLOO_NOTE), loop=repr(PER_STEP_NOTE))
    free_memory()
    dce = dp_ce_phase(os.path.join(work.name, "dp_ce"))
    for r in dce["ranks"] + [dce["one"]]:
        phase("dp_ce", rank=r["rank"], world=r["world"], rows=DP_WORLD * DP_CE_ROWS // r["world"],
              dtype="float32", loss=f"{r['loss']:.6f}", grad_norm=f"{r['grad_norm']:.6f}",
              gathers=r["gathers"], splat_launches=r["launches"]["splat"],
              dropout_calls=f"{r['drop_fwd']}+{r['drop_bwd']}",
              dropout_launches=r["launches"]["dropout"], ss_bev_ms=f"{r['bev_ms']:.1f}",
              eval_ms=f"{r['eval_ms']:.1f}", ss_etp_ms=f"{r['etp_ms']:.1f}",
              eval_success=f"{r['eval']['success']:.4f}",
              peak_mem_MiB=f"{r['peak_bytes'] / 2**20:.1f}")
    for r in dce["ranks"] + [dce["one"]]:
        m = r["eval_moves"]
        phase("dp_ce", rank=r["rank"], world=r["world"], eval_steps=m["act"],
              eval_ms=f"{r['eval_ms']:.1f}", act_ms=f"{m['act_ms']:.1f}",
              act_share=f"{m['act_ms'] / r['eval_ms']:.2%}",
              turns_ms=f"{m['turns_ms']:.1f}",
              turns_share=f"{m['turns_ms'] / r['eval_ms']:.2%}",
              turn_wait_ms=f"{m['turns_ms'] - m['act_ms']:.1f}",
              control_forward_steps=m["forward_step"], control_rotations=m["rotate"])
    phase("dp_ce", trajectories="equal", np_rng="equal",
          **{k: f"{v:.3e}" for k, v in dce["diffs"].items()}, note=repr(GLOO_NOTE),
          loop=repr(PER_STEP_NOTE))
    free_memory()
    nccl = dp_nccl_phase(os.path.join(work.name, "dp_nccl"), plain_ms_per_task)
    pre = nccl["pre"]
    phase("dp_nccl", backend=pre["backend"], world=pre["world"], task=nccl["task"],
          steps=len(pre["ms"]), blocks=",".join(f"{t}x{k}" for t, k in pre["blocks"]),
          graphs_captured=pre["captures"], replays=pre["replays"],
          allreduce_calls=f"{pre['reduces']} ({pre['replays']} replays + "
                          f"{pre['captures']} warm-ups)",
          ms_per_step=f"{nccl['ms']:.2f}",
          plain_ms_per_step=f"{nccl['plain_ms']:.2f}",
          overhead_ms=f"{nccl['ms'] - nccl['plain_ms']:.2f}",
          allreduce_ms_per_step=f"{nccl['reduce_ms']:.3f}",
          grad_MB=f"{pre['grad_bytes'] / 1e6:.1f}", splat_launches=pre["launches"]["splat"],
          dropout_launches=pre["launches"]["dropout"], ckpt=os.path.basename(pre["ckpt"]),
          pretrain_wall_s=f"{nccl['pre_wall_s']:.1f}",
          finetune_transferred=nccl["transferred"], finetune_IL_loss=f"{nccl['il_loss']:.4g}",
          finetune_sr=f"{nccl['ft']['results']['val_unseen']['sr']:.2f}",
          finetune_splat_launches=nccl["ft"]["launches"]["splat"],
          finetune_gathers=nccl["ft"]["gathers"],
          finetune_dropout_launches=nccl["ft"]["launches"]["dropout"],
          finetune_dropout_calls=f"{nccl['ft']['drop_fwd']}+{nccl['ft']['drop_bwd']}",
          finetune_wall_s=f"{nccl['ft_wall_s']:.1f}")
    ce = nccl["ce"]
    phase("dp_nccl", ce_backend=ce["backend"], ce_world=ce["world"], ce_iters=1,
          ce_loss=f"{nccl['ce_loss']:.4g}", ce_success=f"{ce['results']['success']:.4f}",
          ce_gathers=ce["gathers"], ce_splat_launches=ce["launches"]["splat"],
          ce_dropout_calls=f"{ce['drop_fwd']}+{ce['drop_bwd']}",
          ce_dropout_launches=ce["launches"]["dropout"], ce_wall_s=f"{ce['wall_s']:.1f}")
    work.cleanup()
    return dpp, dpr, dce, nccl


def main() -> None:
    kind = device_phase()
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 references stay float32
    torch.backends.cudnn.allow_tf32 = False
    build_phase()
    splat_record = kernel_phase()
    drop_record = dropout_phase()

    run = slice_phase("cuda", [])
    bev_err = check_slice(run, expect_kernel=True)
    m = run["results"]["val_unseen"]
    steps, rollouts = run["steps"], run["rollouts"]
    secs = sum(t for t, _ in rollouts)
    warm_secs, warm_steps = sum(t for t, _ in rollouts[1:]), sum(n for _, n in rollouts[1:])
    phase("slice", rollouts=len(rollouts), steps=steps, gathers=run["gathers"],
          splat_launches=run["launches"], sr=f"{m['sr']:.2f}", spl=f"{m['spl']:.2f}",
          nDTW=f"{m['nDTW']:.2f}", wall_s=f"{run['wall_s']:.2f}",
          ms_per_step=f"{1e3 * secs / steps:.2f}",
          ms_per_step_after_first_rollout=(
              f"{1e3 * warm_secs / warm_steps:.2f}" if warm_steps else "n/a"
          ),
          peak_mem_MiB=f"{run['peak_bytes'] / 2**20:.1f}",
          first_step_bev_err=f"{bev_err:.3e}", first_step_action="equal")

    work = tempfile.TemporaryDirectory()  # the checkpoints, removed at exit
    train = train_phase(os.path.join(work.name, "pretrain"))
    traced = train["traced"]
    phase("train", seed=train["seed"], steps=train["steps"],
          schedule=",".join(f"{t}x{n}" for t, n in run_lengths(train["schedule"])),
          **block_fields(train),
          prepare_bev_calls=train["bev"], splat_launches=train["launches"]["splat"],
          dropout_forward_calls=train["drop_fwd"], dropout_backward_calls=train["drop_bwd"],
          dropout_launches=train["launches"]["dropout"],
          traced_block=f"{traced['task']}x{traced['k']}",
          traced_ms_per_step=f"{traced['wall_ms'] / traced['k']:.2f}",
          traced_busy_ms=f"{traced['busy_ms']:.2f}",
          traced_busy_share=f"{traced['busy_share']:.2%}",
          dropout_device_ms_per_step=f"{traced['dropout_device_ms'] / traced['k']:.4f}",
          device_ms_per_step=f"{traced['device_ms'] / traced['k']:.3f}",
          dropout_device_share=f"{traced['dropout_share']:.2%}",
          **{f"ms_per_step_{t}": f"{ms:.2f}" for t, ms in train["ms_per_task"].items()},
          **{f"first_step_ms_{t}": f"{ms:.1f}" for t, ms in train["first_ms"].items()},
          mix=":".join(f"{t}{r:g}" for t, r in train["mix"].items()),
          samples_per_s_at_mix=f"{train['samples_per_s']:.2f}",
          wall_samples_per_s=f"{train['wall_samples_per_s']:.2f}",
          wall_s=f"{train['wall_s']:.2f}", build_s=f"{train['build_s']:.2f}",
          peak_mem_MiB=f"{train['peak_bytes'] / 2**20:.1f}", params=train["n_params"],
          **{k.replace("/", "_"): f"{v:.4g}" for k, v in train["meters"].items()
             if k.endswith(("loss", "grad_norm"))}, ckpt=os.path.basename(train["ckpt"]))

    free_memory()
    blk = block_phase(os.path.join(work.name, "block"))
    for arm, ms in blk["ms_per_step"].items():
        phase("block", arm=arm, tasks=",".join(blk["tasks"]), k=blk["k"], rows=16,
              ms_per_step=",".join(f"{v:.2f}" for v in ms),
              samples_per_s=f"{blk['samples_per_s'][arm]:.2f}")
    phase("block", generator="equal", loss_rel_diff_max=f"{max(blk['loss_rel']):.3e}",
          loss_rtol=BLOCK_LOSS_RTOL, **agreement_fields(blk), graphs_captured=blk["captures"],
          capture_s=f"{blk['capture_s']:.2f}",
          cached_block_splat_launches=blk["launches"]["splat"],
          cached_block_dropout_launches=blk["launches"]["dropout"],
          eager_block_splat_launches=blk["eager_launches"]["splat"],
          eager_block_dropout_launches=blk["eager_launches"]["dropout"],
          busy_task=blk["busy_task"],
          graphed_ms_per_step=f"{blk['busy_graphed']['wall_ms'] / blk['k']:.2f}",
          graphed_busy_share=f"{blk['busy_graphed']['busy_share']:.2%}",
          eager_ms_per_step=f"{blk['busy_eager']['wall_ms'] / blk['k']:.2f}",
          eager_busy_share=f"{blk['busy_eager']['busy_share']:.2%}")

    free_memory()
    val = validate_phase(train["ckpt"], os.path.join(work.name, "validate"))
    phase("validate", step=24, num_batches=8, tasks="mlm,sap,masksem", params=val["n_params"],
          prepare_bev_calls=val["bev"], splat_launches=val["launches"]["splat"],
          dropout_launches=val["launches"]["dropout"], dropout_generator="unchanged",
          **{f"ms_per_eval_batch_{t}": f"{ms:.2f}" for t, ms in val["ms_per_eval_batch"].items()},
          ms_per_sem_predictions_batch=f"{val['ms_per_sem_batch']:.2f}",
          wall_s=f"{val['wall_s']:.2f}", peak_mem_MiB=f"{val['peak_bytes'] / 2**20:.1f}",
          **{k.split("/", 1)[1].replace("/", "_"): f"{v:.4g}" for k, v in val["results"].items()})

    free_memory()
    opt = optim_phase(train["ckpt"], os.path.join(work.name, "optim"))
    for label, r in opt["runs"].items():
        extra = ({"accumulate_ms": f"{r['accumulate_ms']:.4f}"} if r["accumulate_ms"] is not None
                 else {})
        phase("optim", optimizer=label, updates=opt["updates"], task=opt["task"],
              update_ms=f"{r['update_ms']:.4f}", first_update_ms=f"{r['first_update_ms']:.4f}",
              **extra, bound_ms=f"{r['bound_ms']:.4f}",
              bound_share=f"{r['bound_ms'] / r['update_ms']:.1%}",
              state_GB_moved=f"{r['state_bytes'] / 1e9:.3f}",
              peak_mem_MiB=f"{r['peak_bytes'] / 2**20:.1f}",
              loss=",".join(f"{v:.4g}" for v in r["loss"]),
              grad_norm=",".join(f"{v:.4g}" for v in r["grad_norm"]))
    phase("optim", splat_launches=opt["launches"]["splat"],
          dropout_launches=opt["launches"]["dropout"], moved="every parameter with a gradient",
          accumulating_steps="parameters unchanged")

    free_memory()
    ft = finetune_phase(train["ckpt"], train["pretrain_names"], os.path.join(work.name, "ft"))
    m = ft["results"]["val_unseen"]
    phase("finetune", iters=3, feedback="dagger", train_rollouts=6, updates=len(ft["losses"]),
          transferred=f"{ft['transferred']}/{ft['params']}", gathers=ft["gathers"],
          splat_launches=ft["launches"]["splat"], dropout_forward_calls=ft["drop_fwd"],
          dropout_backward_calls=ft["drop_bwd"], dropout_launches=ft["launches"]["dropout"],
          ms_per_replay_update=f"{ft['ms_per_update']:.2f}",
          first_update_ms=f"{ft['first_update_ms']:.1f}",
          train_rollout_steps=ft["rollout_steps"],
          ms_per_train_rollout_step=f"{ft['ms_per_rollout_step']:.2f}",
          ms_per_train_rollout_step_after_first=f"{ft['ms_per_rollout_step_after_first']:.2f}",
          peak_mem_MiB=f"{ft['peak_bytes'] / 2**20:.1f}", wall_s=f"{ft['wall_s']:.2f}",
          IL_loss=",".join(f"{v:.4g}" for v in ft["losses"]),
          grad_norm=",".join(f"{v:.4g}" for v in ft["grad_norms"]),
          sr=f"{m['sr']:.2f}", spl=f"{m['spl']:.2f}", nDTW=f"{m['nDTW']:.2f}",
          test_from_ckpt_latest="equal")
    free_memory()
    nav = nav_block_phase(os.path.join(work.name, "nav_block"))
    for arm, ms in nav["ms_per_update"].items():
        phase("replay_block", arm=arm, length=nav["length"], rows=4, T=nav["T"],
              steps=nav["steps"], ms_per_update=",".join(f"{v:.2f}" for v in ms))
    phase("replay_block", generator="equal", loss_rel_diff_max=f"{max(nav['loss_rel']):.3e}",
          **agreement_fields(nav), graphs_captured=1,
          capture_s=f"{nav['capture_s']:.2f}",
          cached_block_dropout_launches=nav["launches"]["dropout"],
          eager_dropout_calls=nav["eager_calls"],
          cached_block_splat_launches=nav["launches"]["splat"],
          teacher_gathers=nav["teacher"]["gathers"],
          teacher_splat_launches=nav["teacher"]["launches"],
          traced_ms_per_update=f"{nav['busy']['wall_ms'] / nav['length']:.2f}",
          traced_busy_share=f"{nav['busy']['busy_share']:.2%}",
          dropout_device_ms_per_update=(
              f"{nav['dropout']['dropout_device_ms'] / nav['length']:.4f}"),
          device_ms_per_update=f"{nav['dropout']['device_ms'] / nav['length']:.3f}",
          dropout_device_share=f"{nav['dropout']['dropout_share']:.2%}")
    work.cleanup()

    # R4R and RxR pretraining at their configs' widths and mixes, validating
    # twice; RxR's three tasks in blocks of 8 need 24 steps (seed 16: 8 each)
    cfg_runs = {}
    for label, config, steps, seed, valid in (("r4r_train", R4R_PRETRAIN, 16, 1, 8),
                                              ("rxr_train", RXR_PRETRAIN, 24, 16, 12)):
        free_memory()
        work = tempfile.TemporaryDirectory()
        run_ = config_train_phase(label, config, os.path.join(work.name, label), steps, seed,
                                  valid, min_each=8)
        cfg_runs[label] = run_
        last = run_["validations"][-1][2]
        phase(label, config=config, seed=run_["seed"], steps=run_["steps"],
              schedule=",".join(f"{t}x{n}" for t, n in run_lengths(run_["schedule"])),
              **block_fields(run_),
              params=run_["n_params"], prepare_bev_calls=run_["bev"],
              validation_prepare_bev_calls=run_["val_bev"],
              splat_launches=run_["launches"]["splat"],
              dropout_forward_calls=run_["drop_fwd"], dropout_backward_calls=run_["drop_bwd"],
              dropout_launches=run_["launches"]["dropout"],
              **{f"ms_per_step_{t}": f"{ms:.2f}" for t, ms in run_["ms_per_task"].items()},
              mix=":".join(f"{t}{r:g}" for t, r in run_["mix"].items()),
              samples_per_s_at_mix=f"{run_['samples_per_s']:.2f}",
              wall_samples_per_s=f"{run_['wall_samples_per_s']:.2f}",
              validations=",".join(f"{st}@{sec:.2f}s" for st, sec, _ in run_["validations"]),
              peak_mem_MiB=f"{run_['peak_bytes'] / 2**20:.1f}", wall_s=f"{run_['wall_s']:.2f}",
              **{k.replace("/", "_"): f"{v:.4g}" for k, v in run_["meters"].items()
                 if k.endswith(("loss", "grad_norm"))},
              **{"val_" + k.split("/", 1)[1].replace("/", "_"): f"{v:.4g}"
                 for k, v in last.items()})
        work.cleanup()

    free_memory()
    work = tempfile.TemporaryDirectory()
    obj = obj_train_phase(os.path.join(work.name, "pretrain_reverie"))
    phase("obj_train", config=REVERIE_PRETRAIN, seed=obj["seed"], steps=obj["steps"],
          schedule=",".join(f"{t}x{n}" for t, n in run_lengths(obj["schedule"])),
          **block_fields(obj),
          prepare_bev_calls=obj["bev"], splat_launches=obj["launches"]["splat"],
          dropout_forward_calls=obj["drop_fwd"], dropout_backward_calls=obj["drop_bwd"],
          dropout_launches=obj["launches"]["dropout"],
          **{f"ms_per_step_{t}": f"{ms:.2f}" for t, ms in obj["ms_per_task"].items()},
          **{f"first_step_ms_{t}": f"{ms:.1f}" for t, ms in obj["first_ms"].items()},
          mix=":".join(f"{t}{r:g}" for t, r in obj["mix"].items()),
          samples_per_s_at_mix=f"{obj['samples_per_s']:.2f}",
          wall_samples_per_s=f"{obj['wall_samples_per_s']:.2f}",
          wall_s=f"{obj['wall_s']:.2f}", build_s=f"{obj['build_s']:.2f}",
          peak_mem_MiB=f"{obj['peak_bytes'] / 2**20:.1f}", params=obj["n_params"],
          og_acc=f"{obj['meters']['og/og_acc']:.4f}",
          **{k.replace("/", "_"): f"{v:.4g}" for k, v in obj["meters"].items()
             if k.endswith(("loss", "grad_norm"))}, ckpt=os.path.basename(obj["ckpt"]))

    free_memory()
    oft = obj_finetune_phase(obj["ckpt"], obj["pretrain_names"],
                             os.path.join(work.name, "ft_reverie"))
    m, soon = oft["results"]["val_unseen"], oft["soon"]
    phase("obj_finetune", dataset="reverie", iters=3, feedback="dagger", train_rollouts=6,
          updates=len(oft["losses"]), transferred=f"{oft['transferred']}/{oft['params']}",
          gathers=oft["gathers"], splat_launches=oft["launches"]["splat"],
          dropout_forward_calls=oft["drop_fwd"], dropout_backward_calls=oft["drop_bwd"],
          dropout_launches=oft["launches"]["dropout"],
          ms_per_replay_update=f"{oft['ms_per_update']:.2f}",
          first_update_ms=f"{oft['first_update_ms']:.1f}",
          train_rollout_steps=oft["rollout_steps"],
          ms_per_train_rollout_step=f"{oft['ms_per_rollout_step']:.2f}",
          ms_per_train_rollout_step_after_first=f"{oft['ms_per_rollout_step_after_first']:.2f}",
          peak_mem_MiB=f"{oft['peak_bytes'] / 2**20:.1f}", wall_s=f"{oft['wall_s']:.2f}",
          IL_loss=",".join(f"{v:.4g}" for v in oft["losses"]),
          grad_norm=",".join(f"{v:.4g}" for v in oft["grad_norms"]),
          **{k: f"{m[k]:.2f}" for k in ("sr", "spl", "rgs", "rgspl", "oracle_sr")},
          test_from_ckpt_latest="equal", pred_obj_id="present",
          **{f"soon_{k}": f"{soon[k]:.2f}" for k in ("sr", "spl", "rgs", "rgspl")},
          soon_splat_launches=oft["soon_splat_launches"])
    work.cleanup()

    small_phase()
    small_ce_phase()

    free_memory()
    work = tempfile.TemporaryDirectory()
    cep = ce_pretrain_phase(os.path.join(work.name, "ce_pretrain"))
    phase("ce_pretrain", config=CE_PRETRAIN, seed=cep["seed"], steps=cep["steps"],
          schedule=",".join(f"{t}x{n}" for t, n in run_lengths(cep["schedule"])),
          **block_fields(cep),
          prepare_bev_calls=cep["bev"], splat_launches=cep["launches"]["splat"],
          dropout_forward_calls=cep["drop_fwd"], dropout_backward_calls=cep["drop_bwd"],
          dropout_launches=cep["launches"]["dropout"],
          **{f"ms_per_step_{t}": f"{ms:.2f}" for t, ms in cep["ms_per_task"].items()},
          **{f"first_step_ms_{t}": f"{ms:.1f}" for t, ms in cep["first_ms"].items()},
          mix=":".join(f"{t}{r:g}" for t, r in cep["mix"].items()),
          samples_per_s_at_mix=f"{cep['samples_per_s']:.2f}",
          wall_samples_per_s=f"{cep['wall_samples_per_s']:.2f}",
          wall_s=f"{cep['wall_s']:.2f}", build_s=f"{cep['build_s']:.2f}",
          peak_mem_MiB=f"{cep['peak_bytes'] / 2**20:.1f}", params=cep["n_params"],
          **{k.replace("/", "_"): f"{v:.4g}" for k, v in cep["meters"].items()
             if k.endswith(("loss", "grad_norm"))}, ckpt=os.path.basename(cep["ckpt"]))

    # SS-BEV at B=8 from the CE pretraining checkpoint: 4 training iterations,
    # an evaluation every 2, then eval over its checkpoints and inference
    ce_argv = ["--batch_size", "8", "--allow_random_frozen", "--pretrain_ckpt", cep["ckpt"],
               "--n_episodes", "16"]
    free_memory()
    ce = ce_phase("ce", os.path.join(work.name, "ce"),
                  ce_argv + ["--trainer", "ss-bev", "--iters", "4", "--log_every", "2"],
                  cep["pretrain_names"], eval_and_infer=True)
    print_ce("ce", ce)
    free_memory()
    etp = ce_phase("ce_etp", os.path.join(work.name, "ce_etp"),
                   ce_argv + ["--trainer", "ss-etp", "--iters", "2", "--log_every", "2"],
                   cep["pretrain_names"], eval_and_infer=False)
    print_ce("ce_etp", etp)

    # the Habitat sensor stack: SS-BEV over the stand-in simulator with the
    # full-width CLIP and DDPPO towers, from the CE pretraining checkpoint
    free_memory()
    hab = habitat_phase(os.path.join(work.name, "habitat"), cep["ckpt"], cep["pretrain_names"])
    print_habitat(hab)
    free_memory()
    pre = precompute_phase(hab["clip_path"], hab["ddppo_path"])
    phase("precompute", viewpoints=4, image_hw=224,
          **{f"ms_per_viewpoint_{k}": f"{v:.2f}" for k, v in pre.items()},
          hdf5_writes="not timed here (no h5py on this machine)")

    # CE DAgger at full width: PREVALENT from random weights, the glocal
    # policies from the CE pretraining checkpoint; 2 iterations of 16
    # episodes at p 0.75 (the second mixes in policy actions), 2 epochs each
    free_memory()
    depth = ["--dagger_iters", "2", "--update_size", "16", "--dagger_epochs", "2"]
    dag = {"prevalent": dagger_phase("dagger_prevalent",
                                     os.path.join(work.name, "dagger_prevalent"),
                                     ["--policy", "prevalent", *depth])}
    print_dagger("dagger_prevalent", dag["prevalent"])
    free_memory()
    dag["bev"] = dagger_phase("dagger_bev", os.path.join(work.name, "dagger_bev"),
                              ["--policy", "bev", "--pretrain_ckpt", cep["ckpt"], *depth],
                              cep["pretrain_names"])
    print_dagger("dagger_bev", dag["bev"])
    free_memory()
    dag["etp"] = dagger_phase("dagger_etp", os.path.join(work.name, "dagger_etp"),
                              ["--policy", "etp", "--pretrain_ckpt", cep["ckpt"],
                               "--dagger_iters", "1", "--update_size", "8",
                               "--dagger_epochs", "2"], cep["pretrain_names"])
    print_dagger("dagger_etp", dag["etp"])
    free_memory()
    pool = ce_pool_phase(os.path.join(work.name, "ce_pool"))
    for n, r in pool.items():
        phase("ce_pool", workers=n, rollouts=r["rollouts"], steps=r["pool"]["steps"], trajectories="equal",
              worker_cuda_context="none",
              ms_per_rollout_step_inprocess=f"{r['inproc']['ms_per_step']:.2f}",
              ms_per_rollout_step_pool=f"{r['pool']['ms_per_step']:.2f}",
              rollout_range_inprocess="{:.2f}-{:.2f}".format(*r["inproc"]["ms_range"]),
              rollout_range_pool="{:.2f}-{:.2f}".format(*r["pool"]["ms_range"]),
              env_host_ms_per_step_inprocess=f"{r['inproc']['env_ms_per_step']:.2f}",
              env_host_ms_per_step_pool=f"{r['pool']['env_ms_per_step']:.2f}")
    work.cleanup()

    # data parallelism: two gloo ranks on the one card against one process at
    # the global batch, then the CLIs under torch.distributed.run on NCCL
    dpp, dpr, dce, nccl = dp_group(train["ms_per_task"])

    loaded = sorted(k for k in sys.modules if k.split(".")[0] in
                    ("vln_bevbert_tpu", "jax", "jaxlib", "flax", "optax", "orbax"))
    if loaded:
        raise AssertionError(f"JAX or JAX-package modules were imported: {loaded[:5]}")
    # "launches" is the pretraining path's count; "ms", "bound_ms" and
    # "library_ms" are at the navigation shape (splat) and the attention
    # probabilities (dropout); every shape's numbers are nested beside them
    print(json.dumps({"kernels": [
        {**SPLAT, "launches": train["launches"]["splat"], **splat_record, "bound_by": "bytes",
         "launches_eval": run["launches"], "launches_finetune": ft["launches"]["splat"],
         "launches_obj_pretrain": obj["launches"]["splat"],
         "launches_obj_finetune": oft["launches"]["splat"],
         "launches_ce_pretrain": cep["launches"]["splat"], "launches_ce": ce["launches"]["splat"],
         "launches_ce_eval": ce["eval_gathers"], "launches_ce_etp": etp["launches"]["splat"],
         "launches_habitat": hab["launches"]["splat"],
         "launches_validate": val["launches"]["splat"], "launches_optim": opt["launches"]["splat"],
         "launches_r4r": cfg_runs["r4r_train"]["launches"]["splat"],
         "launches_rxr": cfg_runs["rxr_train"]["launches"]["splat"],
         **{f"launches_dagger_{k}": r["launches"]["splat"] for k, r in dag.items()},
         "launches_dp_pretrain_ranks": [r["launches"]["splat"] for r in dpp["ranks"]],
         "launches_dp_pretrain_one": dpp["one"]["launches"]["splat"],
         "launches_dp_replay_ranks": [r["launches"]["splat"] for r in dpr["ranks"]],
         "launches_dp_replay_teacher": dpr["teacher"]["launches"],
         "launches_dp_nccl": nccl["pre"]["launches"]["splat"],
         "launches_dp_nccl_finetune": nccl["ft"]["launches"]["splat"],
         "launches_dp_ce_ranks": [r["launches"]["splat"] for r in dce["ranks"]],
         "launches_dp_ce_one": dce["one"]["launches"]["splat"],
         "launches_dp_nccl_ce": nccl["ce"]["launches"]["splat"],
         "launches_block_cached": blk["launches"]["splat"],
         "launches_replay_block_cached": nav["launches"]["splat"]},
        {**DROPOUT, "launches": train["launches"]["dropout"], **drop_record,
         "bound_by": "bytes",
         "device_ms_per_graphed_step": traced["dropout_device_ms"] / traced["k"],
         "device_ms_per_graphed_update": nav["dropout"]["dropout_device_ms"] / nav["length"],
         "launches_finetune": ft["launches"]["dropout"],
         "launches_obj_pretrain": obj["launches"]["dropout"],
         "launches_obj_finetune": oft["launches"]["dropout"],
         "launches_ce_pretrain": cep["launches"]["dropout"],
         "launches_ce": ce["launches"]["dropout"], "launches_ce_etp": etp["launches"]["dropout"],
         "launches_habitat": hab["launches"]["dropout"],
         "launches_validate": val["launches"]["dropout"],
         "launches_optim": opt["launches"]["dropout"],
         "launches_r4r": cfg_runs["r4r_train"]["launches"]["dropout"],
         "launches_rxr": cfg_runs["rxr_train"]["launches"]["dropout"],
         **{f"launches_dagger_{k}": r["launches"]["dropout"] for k, r in dag.items()},
         "launches_dp_pretrain_ranks": [r["launches"]["dropout"] for r in dpp["ranks"]],
         "launches_dp_pretrain_one": dpp["one"]["launches"]["dropout"],
         "launches_dp_replay_ranks": [r["launches"]["dropout"] for r in dpr["ranks"]],
         "launches_dp_replay_one": dpr["one"]["launches"]["dropout"],
         "launches_dp_nccl": nccl["pre"]["launches"]["dropout"],
         "launches_dp_nccl_finetune": nccl["ft"]["launches"]["dropout"],
         "launches_dp_ce_ranks": [r["launches"]["dropout"] for r in dce["ranks"]],
         "launches_dp_ce_one": dce["one"]["launches"]["dropout"],
         "launches_dp_nccl_ce": nccl["ce"]["launches"]["dropout"],
         "launches_block_cached": blk["launches"]["dropout"],
         "launches_replay_block_cached": nav["launches"]["dropout"]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--torchrun-pretrain"]:  # a rank of dp_nccl_phase's launch
        torchrun_pretrain(sys.argv[2], sys.argv[3:])
    elif sys.argv[1:2] == ["--torchrun-finetune"]:  # likewise
        torchrun_finetune(sys.argv[2], sys.argv[3:])
    elif sys.argv[1:2] == ["--torchrun-ce"]:  # likewise
        torchrun_ce(sys.argv[2], sys.argv[3:])
    else:
        main()
