"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths (eval, pretraining, fine-tuning, their object
grounding variants, and continuous-environment pretraining, training, eval,
inference and DAgger with its stores and env pool, and CE training over the
Habitat sensor stack with the frozen CLIP and DDPPO towers) at full
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
             sap and masksem eight times in 24 steps; the kernels' launch
             counts must equal the dropout calls (forward and backward) and
             the ``prepare_bev`` calls; losses and gradient norms finite;
             ms/step per task, samples/s weighted by the configured task mix,
             peak memory;
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
             twice; checked as ``train`` is, the validations' splat launches
             included;
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
             waypoint predictor's device ms per call, peak memory;
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

The dropout phase also holds the kernel to its plain version, forward and
backward bitwise, at the PREVALENT update's sites (B=8, language bucket 32,
7 [state; vision] rows).

Launch counts are the operators' own (C++, ``_build.launches``), set to 0
just before each path and read just after it. The second-to-last line is a
JSON record of the kernels; the last line is ``{"ok": true, "device": {...}}``.
The port imports neither JAX nor the JAX package ``vln_bevbert_tpu``, and
the run checks that none of their modules was loaded.
"""

from __future__ import annotations

import gc
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


def device_ms_by_kernel(fn, iters: int = 10) -> dict:
    """Mean device milliseconds per call of each kernel (and copy) that
    ``fn`` runs, by torch.profiler: their own time, without the gaps in
    which the host is still launching (which CUDA events around a short
    kernel measure instead)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(6):  # the tracer has returned sessions without device events
        if attempt:
            time.sleep(0.2)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                r = e.time_range
                by_name[e.name] = by_name.get(e.name, 0.0) + (r.end - r.start) / 1e3 / iters
        if by_name:
            return by_name
    raise RuntimeError("torch.profiler recorded no device time in six sessions")


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
        "pretrain": (16, 1, 2352, 1, 441, 768, 40, torch.float16),  # prepare_bev
        # the 11x11 CE map: a rollout step's gather_and_splat at B=8, and CE
        # pretraining's prepare_bev
        "ce_rollout": (8, 15, 2352, 8, 121, 768, 0, torch.bfloat16),
        "ce_pretrain": (16, 1, 2352, 1, 121, 768, 40, torch.float16),
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
        "hidden": ((16, 200, 768), torch.bfloat16, 0.1),
        "feat": ((16, 441, 768), torch.float32, 0.4),
        # the replay update's: a step's BEV attention at B=4, the panorama
        # encoder over T*B = 60 step-rows of 44 view slots
        "ft_attn_probs": ((4, 12, 441, 441), torch.bfloat16, 0.1),
        "ft_pano_hidden": ((60, 44, 768), torch.bfloat16, 0.1),
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
        # the PREVALENT BPTT update's at B=8 and the language bucket L=32:
        # the embeddings and the 9 language layers' outputs and attention
        # probabilities, then per recurrent step the candidate embeddings
        # (float32 after visn_ln), and in each cross-modal layer over the
        # K+1 = 7 [state; vision] rows the cross-attention probabilities
        # into the L-1 language keys, the self-attention probabilities and
        # the cross, self and FFN outputs
        **PREVALENT_SITES,
    }
    record = {"max_abs_err": 0.0, "sites": {}}
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
        ms = cuda_ms(lambda: dropout(x, seeds, rate), iters=20)
        lib_ms = cuda_ms(lambda: F.dropout(x, rate), iters=20)
        plain_ms = cuda_ms(lambda: dropout_ref(x, seeds, rate), iters=3, warmup=1)
        dev_ms = device_ms(lambda: dropout(x, seeds, rate))
        lib_dev_ms = device_ms(lambda: F.dropout(x, rate))
        bound = bound_ms(2 * x.numel() * x.element_size() + seeds.numel() * 4)
        row = {"ms": ms, "device_ms": dev_ms, "F_dropout_ms": lib_ms,
               "F_dropout_device_ms": lib_dev_ms, "plain_ms": plain_ms, "bound_ms": bound}
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
              F_dropout_device_ms=f"{lib_dev_ms:.4f}", bound_us=f"{1e3 * bound:.1f}",
              bound_share=f"{bound / dev_ms:.1%}", plain_ms=f"{plain_ms:.4f}", **extra)
        record["max_abs_err"] = max(record["max_abs_err"], err)
        record["sites"][label] = row
        if label == "attn_probs":
            record.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_us=1e3 * bound,
                          library_ms=lib_ms, device_ms=dev_ms)

    # edges: rate 0, a row length not divisible by 4, a single row, a
    # misaligned start (the scalar path)
    x = torch.randn(1, 1000, generator=g, device="cuda").bfloat16()
    one = draw_seeds(1, g, "cuda")
    if not torch.equal(dropout(x, one, 0.0), x):
        raise AssertionError("dropout edge: rate 0 must be the identity")
    base = torch.randn(1 + 5 * 3 * 7, generator=g, device="cuda")
    cases = {"ragged_rows": base[1:].view(5, 3, 7).bfloat16().contiguous(),
             "misaligned": base[1:].view(5, 21), "single_row": x}
    for label, t in cases.items():
        seeds = draw_seeds(t.shape[0], g, "cuda")
        if not torch.equal(dropout(t, seeds, 0.3), dropout_ref(t, seeds, 0.3)):
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
    phase("dropout", edges="rate0 ragged_rows misaligned single_row", backward_mask="equal",
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
    return record


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
    """Train ``trainer`` to its configured step count, instrumented: the
    kernels' launch counts against the dropout calls (forward and backward)
    and the ``prepare_bev`` calls of training and of the validations at
    every ``valid_steps`` crossing (``val_prepare_calls`` each, no dropout),
    CUDA events around every step, then save its checkpoint. Every task of
    the mix must run ``min_each`` steps."""
    from vln_bevbert_tpu_torch import _build
    from vln_bevbert_tpu_torch.ops import dropout as drop_mod
    from vln_bevbert_tpu_torch.parallel import train_step as ts_mod

    seen = {"drop_fwd": 0, "drop_bwd": 0, "bev": 0, "val_bev": 0, "steps": [],
            "validations": [], "in_val": False}
    forward, prepare = drop_mod.Dropout.forward, ts_mod.prepare_bev

    def counted_forward(self, x):
        if self.training and self.rate > 0 and x.dim() >= 2:
            seen["drop_fwd"] += 1
            seen["drop_bwd"] += bool(x.requires_grad and torch.is_grad_enabled())
        return forward(self, x)

    def counted_prepare(projector, batch):
        seen["val_bev" if seen["in_val"] else "bev"] += "depths" in batch
        return prepare(projector, batch)

    validate = trainer.validate

    def timed_validate(step, num_batches=8):
        torch.cuda.synchronize()
        seen["in_val"], t0 = True, time.perf_counter()
        try:
            results = validate(step, num_batches)
        finally:
            seen["in_val"] = False
        seen["validations"].append((step, time.perf_counter() - t0, results))
        return results

    trainer.validate = timed_validate
    step_fn = trainer.step_fn

    def timed_step(state, batch, task):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        metrics = step_fn(state, batch, task)
        end.record()
        seen["steps"].append((task, start, end, metrics))
        return metrics

    cfg = trainer.cfg
    steps = cfg.optim.num_train_steps
    drop_mod.Dropout.forward, ts_mod.prepare_bev = counted_forward, counted_prepare
    trainer.step_fn = timed_step
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        meters = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"dropout": _build.launches("dropout"), "splat": _build.launches("splat")}
    finally:
        drop_mod.Dropout.forward, ts_mod.prepare_bev = forward, prepare
        trainer.step_fn, trainer.validate = step_fn, validate
    peak = torch.cuda.max_memory_allocated()
    ckpt = trainer.save(trainer.state.step)
    n_params = sum(p.numel() for p in trainer.state.params)

    schedule = [t for t, *_ in seen["steps"]]
    mix = {t.split("_")[0]: r for t, r in zip(cfg.tasks, cfg.mix_ratio)}
    if len(schedule) != steps or any(schedule.count(t) < min_each for t in mix):
        raise AssertionError(f"{label}: ran {schedule}; every task of {sorted(mix)} needs "
                             f"{min_each} of {steps} steps")
    n_val = steps // cfg.valid_steps if cfg.valid_steps else 0
    if [v[0] for v in seen["validations"]] != [cfg.valid_steps * (i + 1) for i in range(n_val)]:
        raise AssertionError(f"{label}: validated at {[v[0] for v in seen['validations']]}")
    if (launches["splat"] != seen["bev"] + seen["val_bev"] or seen["bev"] != steps
            or seen["val_bev"] != n_val * val_prepare_calls(cfg)):
        raise AssertionError(f"{label}: {launches['splat']} splat launches for "
                             f"{seen['bev']} training and {seen['val_bev']} validation "
                             f"prepare_bev calls in {steps} steps")
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
        "ms_per_task": ms_per_task, "mix": mix,
        "samples_per_s": cfg.train_batch_size * 1e3 / mix_ms,
        "wall_samples_per_s": cfg.train_batch_size * steps / wall,
        "wall_s": wall, "build_s": build_s,
        "peak_bytes": peak, "n_params": n_params, "meters": meters,
        "validations": seen["validations"], "val_bev": seen["val_bev"],
        "first_ms": {t: next(s.elapsed_time(e) for tt, s, e, _ in seen["steps"] if tt == t)
                     for t in per_task},
    }


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
    return run_trainer(trainer, "train", min_each, time.perf_counter() - t0)


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
    from vln_bevbert_tpu_torch.parallel.train_step import TrainState, upload

    trainer = pretrain.build(pretrain.parse_args([
        "--synthetic", "--device", "cuda", "--batch_size", "16", "--seed", "16",
        "--resume", ckpt, "--output_dir", out_dir]))
    model, device = trainer.model, trainer.device
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

        def timed_update(grads, update=update, events=events, nonzero=nonzero):
            nonzero |= torch.stack(torch._foreach_norm(grads)) > 0
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            moved = update(grads)
            t1.record()
            events.append((t0, t1, moved))
            return moved

        state.tx.update = timed_update
        metrics, unchanged = [], []
        _build.reset_launches()
        for i in range(calls):
            before = ([p.detach().clone() for p in state.params] if (i + 1) % k else None)
            metrics.append(trainer.step_fn(state, batches[i], task))
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
    gather, drop_forward = agent_mod.gather_and_splat, drop_mod.Dropout.forward
    rollout, learn, init = cls._rollout, cls.learn_from_bundle, cls.init_params

    def counted_gather(*args):
        seen["gathers"] += 1
        return gather(*args)

    def counted_dropout(self, x):
        if self.training and self.rate > 0 and x.dim() >= 2:
            seen["drop_fwd"] += 1
            seen["drop_bwd"] += bool(x.requires_grad and torch.is_grad_enabled())
        return drop_forward(self, x)

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
    gather, drop_forward = ce_mod.gather_and_splat, drop_mod.Dropout.forward
    rollout, ce_rollout, gmap_var = cls.rollout, cls._ce_rollout, cls._ce_gmap_variable
    learn, init = base.learn_from_bundle, cls.init_params

    def counted_gather(*args):
        seen["gathers"] += 1
        return gather(*args)

    def counted_dropout(self, x):
        if self.training and self.rate > 0 and x.dim() >= 2:
            seen["drop_fwd"] += 1
            seen["drop_bwd"] += bool(x.requires_grad and torch.is_grad_enabled())
        return drop_forward(self, x)

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
        collided = []
        for slot, ghost in ((0, [cx, 0.0, cz - r - 1.0]), (1, free_start + [1.5, 0.0, -1.5])):
            start = ctrl_env.positions[slot].copy()
            ctrl.execute(slot, {"act": 4, "back_path": None, "front_pos": start,
                                "ghost_pos": np.asarray(ghost), "tryout": True})
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
                        "last_step_collided": collided},
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
          control_check_last_step_collided=",".join(map(str, run["control"]["last_step_collided"])))


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
    gather, drop_forward = ce_mod.gather_and_splat, drop_mod.Dropout.forward

    def counted_gather(*args):
        seen["gathers"] += 1
        return gather(*args)

    def counted_dropout(self, x):
        y = drop_forward(self, x)
        if self.training and self.rate > 0 and x.dim() >= 2:
            seen["drop_fwd"] += 1
            if y.requires_grad:
                # the backward launches only where the loss reaches this
                # output: the last recurrent step's last FFN and
                # self-attention block feed no later step
                y.register_hook(lambda g: seen.__setitem__("drop_bwd", seen["drop_bwd"] + 1))
        return y

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
    phase("train", seed=train["seed"], steps=train["steps"],
          schedule=",".join(f"{t}x{n}" for t, n in run_lengths(train["schedule"])),
          prepare_bev_calls=train["bev"], splat_launches=train["launches"]["splat"],
          dropout_forward_calls=train["drop_fwd"], dropout_backward_calls=train["drop_bwd"],
          dropout_launches=train["launches"]["dropout"],
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
         **{f"launches_dagger_{k}": r["launches"]["splat"] for k, r in dag.items()}},
        {**DROPOUT, "launches": train["launches"]["dropout"], **drop_record,
         "bound_by": "bytes", "launches_finetune": ft["launches"]["dropout"],
         "launches_obj_pretrain": obj["launches"]["dropout"],
         "launches_obj_finetune": oft["launches"]["dropout"],
         "launches_ce_pretrain": cep["launches"]["dropout"],
         "launches_ce": ce["launches"]["dropout"], "launches_ce_etp": etp["launches"]["dropout"],
         "launches_habitat": hab["launches"]["dropout"],
         "launches_validate": val["launches"]["dropout"],
         "launches_optim": opt["launches"]["dropout"],
         "launches_r4r": cfg_runs["r4r_train"]["launches"]["dropout"],
         "launches_rxr": cfg_runs["rxr_train"]["launches"]["dropout"],
         **{f"launches_dagger_{k}": r["launches"]["dropout"] for k, r in dag.items()}},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
