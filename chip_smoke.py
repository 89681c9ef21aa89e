"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's three paths at full bert-base width with random seeded
weights, through the hand-written CUDA kernels, in phases; each phase prints
one line and a failing phase raises, so the script exits non-zero:

1. device  - a CUDA card must be present; its name and power limit;
2. build   - compile ``csrc/splat.cu`` and ``csrc/dropout.cu`` with nvcc for
             sm_90a into ``build/``, one nvcc per source, started together;
3. kernel  - the splat kernel against its plain PyTorch version on the card
             at the navigation, pretraining and CE shapes and at edge cases;
4. dropout - the dropout kernel against its plain version, bitwise, at the
             pretraining step's and the replay update's largest sites and at
             edge cases; P(keep); the
             backward's mask; seed-only saved tensors;
5. slice   - the navigation eval (``cli.finetune --synthetic --test``); the
             splat kernel's launch count must equal the number of
             gather-and-splat calls, and the first step's BEV features and
             action must match the plain version's;
6. train   - the pretraining path (``cli.pretrain --synthetic --seed 16``),
             B=16, then its checkpoint; seed 16's schedule runs each of mlm,
             sap and masksem eight times in 24 steps; the kernels' launch
             counts must equal
             the dropout calls (forward and backward) and the ``prepare_bev``
             calls; losses and gradient norms finite; ms/step per task,
             samples/s weighted by the configured task mix, peak memory;
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
8. small   - a small configuration evaluated on the card and on the CPU with
             the same parameters: equal trajectories, close logits.

The second-to-last line is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``. The port imports no JAX: the host modules
it shares with ``vln_bevbert_tpu`` are JAX-free, and the run checks that no
JAX module was loaded.
"""

from __future__ import annotations

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
# The count column is integer-valued and must match exactly; feature sums of a
# bf16 payload accumulate in float32 in another order (atomics), hence:
RTOL, ATOL = 1e-5, 1e-3


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


def device_ms(fn, iters: int = 10) -> float:
    """Mean device milliseconds per call by torch.profiler: the kernels' and
    copies' own time, without the gaps in which the host is still launching
    (which CUDA events around a short kernel measure instead)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(r.end - r.start for r in spans) / 1e3 / iters


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


def build_phase() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from vln_bevbert_tpu_torch import _build

    names = ("splat", "dropout")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc process per source
        built = dict(zip(names, pool.map(_build.build, names)))
    secs = time.perf_counter() - t0
    for name, (path, log) in built.items():
        _build.load(name)
        ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "smem" in ln]
        phase("build", kernel=name, seconds=f"{secs:.2f}", library=path.name,
              ptxas=repr(" | ".join(ptxas)))


def random_splat_inputs(g, b, n, c, d, valid_frac=2 / 3):
    """int32 cells (invalid -> -1) and a bf16 payload whose last column is 1."""
    cell = torch.randint(0, c, (b, n), generator=g, device="cuda", dtype=torch.int32)
    invalid = torch.rand(b, n, generator=g, device="cuda") > valid_frac
    cell = torch.where(invalid, torch.full_like(cell, -1), cell)
    payload = torch.randn(b, n, d, generator=g, device="cuda").to(torch.bfloat16)
    payload[..., -1] = 1.0
    return cell, payload


def check_sums(label: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    if not torch.equal(out[..., -1], ref[..., -1]):
        raise AssertionError(f"{label}: count column differs from the plain version")
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL, msg=lambda m: f"{label}: {m}")
    return (out - ref).abs().max().item()


def kernel_phase() -> dict:
    from vln_bevbert_tpu_torch.ops import bev as bev_mod
    from vln_bevbert_tpu_torch.ops.bev import BevProjector
    from vln_bevbert_tpu_torch.ops.splat import splat_sums, splat_sums_ref

    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = {  # (B, N, C, D)
        "nav": (4, 8 * 2352, 441, 769),       # gather_and_splat at the slice's shape
        "pretrain": (16, 2352, 441, 809),     # feats + 40 sem + count
        "ce": (8, 2352, 121, 769),            # the 11x11 continuous-env map
    }
    record = {"max_abs_err": 0.0}
    for label, (b, n, c, d) in shapes.items():
        cell, payload = random_splat_inputs(g, b, n, c, d)
        out, ref = splat_sums(cell, payload, c), splat_sums_ref(cell, payload, c)
        err = check_sums(label, out, ref)
        ms = cuda_ms(lambda: splat_sums(cell, payload, c), iters=20)
        plain_ms = cuda_ms(lambda: splat_sums_ref(cell, payload, c), iters=5)
        gbps = (cell.numel() * 4 + payload.numel() * 2 + b * c * d * 4) / ms / 1e6
        phase("kernel", shape=label, B=b, N=n, C=c, D=d, max_abs_err=f"{err:.3e}",
              ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", kernel_GBps=f"{gbps:.1f}")
        record["max_abs_err"] = max(record["max_abs_err"], err)
        if label == "nav":
            record.update(ms=ms, plain_ms=plain_ms)

    # edge cases: an all-invalid row, cells out of range, zero depth
    cell, payload = random_splat_inputs(g, 3, 5000, 441, 769)
    cell[0] = -1
    cell[1, ::3] = 441 + 7
    out = splat_sums(cell, payload, 441)
    if out[0].abs().max().item() != 0.0:
        raise AssertionError("edge: an all-invalid row must splat to zeros")
    record["max_abs_err"] = max(record["max_abs_err"],
                                check_sums("edge", out, splat_sums_ref(cell, payload, 441)))
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
    bev_mod.splat_sums = splat_sums_ref
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
          zero_depth="ok", occupied_cells=int(ours[1][1].sum()))
    return record


def dropout_phase() -> dict:
    import math

    from vln_bevbert_tpu_torch.ops.dropout import draw_seeds, dropout, dropout_apply, dropout_ref

    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = {  # the pretraining step's largest sites: (shape, dtype, rate)
        "attn_probs": ((16, 12, 441, 441), torch.bfloat16, 0.1),
        "hidden": ((16, 200, 768), torch.bfloat16, 0.1),
        "feat": ((16, 441, 768), torch.float32, 0.4),
        # the replay update's: a step's BEV attention at B=4, the panorama
        # encoder over T*B = 60 step-rows of 44 view slots
        "ft_attn_probs": ((4, 12, 441, 441), torch.bfloat16, 0.1),
        "ft_pano_hidden": ((60, 44, 768), torch.bfloat16, 0.1),
    }
    record = {"max_abs_err": 0.0}
    for label, (shape, dtype, rate) in shapes.items():
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        seeds = draw_seeds(shape[0], g, "cuda")
        y, ref = dropout_apply(x, seeds, rate), dropout_ref(x, seeds, rate)
        if not torch.equal(y, ref):
            raise AssertionError(f"dropout {label}: kernel differs from the plain version")
        err = (y.float() - ref.float()).abs().max().item()
        keep = (y != 0).float().mean().item()
        sd = math.sqrt(rate * (1 - rate) / x.numel())
        if abs(keep - (1 - rate)) > 5 * sd:
            raise AssertionError(f"dropout {label}: P(keep) {keep} vs {1 - rate}")
        ms = cuda_ms(lambda: dropout_apply(x, seeds, rate), iters=20)
        plain_ms = cuda_ms(lambda: dropout_ref(x, seeds, rate), iters=3, warmup=1)
        dev_ms = device_ms(lambda: dropout_apply(x, seeds, rate))
        gbps = 2 * x.numel() * x.element_size() / dev_ms / 1e6
        phase("dropout", site=label, shape=tuple(shape), dtype=str(dtype).split(".")[-1],
              rate=rate, bitwise="equal", keep=f"{keep:.6f}", ms=f"{ms:.4f}",
              plain_ms=f"{plain_ms:.4f}", kernel_device_ms=f"{dev_ms:.4f}",
              kernel_device_GBps=f"{gbps:.1f}")
        record["max_abs_err"] = max(record["max_abs_err"], err)
        if label == "attn_probs":
            record.update(ms=ms, plain_ms=plain_ms)

    # edges: rate 0, a row length not divisible by 4, a single row, a
    # misaligned start (the scalar path)
    x = torch.randn(1, 1000, generator=g, device="cuda").bfloat16()
    one = draw_seeds(1, g, "cuda")
    if not torch.equal(dropout_apply(x, one, 0.0), x):
        raise AssertionError("dropout edge: rate 0 must be the identity")
    base = torch.randn(1 + 5 * 3 * 7, generator=g, device="cuda")
    cases = {"ragged_rows": base[1:].view(5, 3, 7).bfloat16().contiguous(),
             "misaligned": base[1:].view(5, 21), "single_row": x}
    for label, t in cases.items():
        seeds = draw_seeds(t.shape[0], g, "cuda")
        if not torch.equal(dropout_apply(t, seeds, 0.3), dropout_ref(t, seeds, 0.3)):
            raise AssertionError(f"dropout edge {label}: kernel differs from the plain version")

    # autograd: the backward relaunches the kernel on dy with the saved seeds
    x = torch.randn(16, 200, 768, generator=g, device="cuda").bfloat16().requires_grad_()
    seeds = draw_seeds(16, g, "cuda")
    packed = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: packed.append(t) or t,
                                                  lambda t: t):
        y = dropout(x, seeds, 0.1)
    if len(packed) != 1 or packed[0] is not seeds:
        raise AssertionError(f"dropout: saved {len(packed)} tensors, expected the seeds only")
    dy = torch.randn_like(y)
    before = dropout_apply.launches
    y.backward(dy)
    if dropout_apply.launches != before + 1:
        raise AssertionError("dropout: the backward did not launch the kernel")
    if not (torch.equal(x.grad, dropout_ref(dy, seeds, 0.1))
            and torch.equal(x.grad != 0, (y != 0) & (dy != 0))):
        raise AssertionError("dropout: the backward's mask differs from the forward's")
    phase("dropout", edges="rate0 ragged_rows misaligned single_row", backward_mask="equal",
          saved="seeds only")
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


def train_phase(out_dir: str, steps: int = 24, seed: int = 16, min_each: int = 3) -> dict:
    """Run the CLI's synthetic pretraining at full width, instrumented, and
    save its checkpoint into ``out_dir`` as the CLI does. ``seed`` 16
    schedules every task at least ``min_each`` times in the first 24 steps
    (the MetaLoader draws tasks in blocks of 8)."""
    from vln_bevbert_tpu_torch.cli import pretrain
    from vln_bevbert_tpu_torch.ops import dropout as drop_mod
    from vln_bevbert_tpu_torch.ops.splat import splat_sums
    from vln_bevbert_tpu_torch.parallel import train_step as ts_mod

    seen = {"drop_fwd": 0, "drop_bwd": 0, "bev": 0, "steps": []}
    forward, prepare = drop_mod.Dropout.forward, ts_mod.prepare_bev

    def counted_forward(self, x):
        if self.training and self.rate > 0 and x.dim() >= 2:
            seen["drop_fwd"] += 1
            seen["drop_bwd"] += bool(x.requires_grad and torch.is_grad_enabled())
        return forward(self, x)

    def counted_prepare(projector, batch):
        seen["bev"] += "depths" in batch
        return prepare(projector, batch)

    t0 = time.perf_counter()
    trainer = pretrain.build(pretrain.parse_args([
        "--synthetic", "--device", "cuda", "--num_steps", str(steps),
        "--batch_size", "16", "--seed", str(seed), "--output_dir", out_dir]))
    build_s = time.perf_counter() - t0
    step_fn = trainer.step_fn

    def timed_step(state, batch, task):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        metrics = step_fn(state, batch, task)
        end.record()
        seen["steps"].append((task, start, end, metrics))
        return metrics

    drop_mod.Dropout.forward, ts_mod.prepare_bev = counted_forward, counted_prepare
    trainer.step_fn = timed_step
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        drop_mod.dropout_apply.launches = splat_sums.launches = 0
        t0 = time.perf_counter()
        meters = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"dropout": drop_mod.dropout_apply.launches,
                    "splat": splat_sums.launches}
    finally:
        drop_mod.Dropout.forward, ts_mod.prepare_bev = forward, prepare
    peak = torch.cuda.max_memory_allocated()
    ckpt = trainer.save(trainer.state.step)
    n_params = sum(p.numel() for p in trainer.state.params)

    cfg = trainer.cfg
    schedule = [t for t, *_ in seen["steps"]]
    mix = {t.split("_")[0]: r for t, r in zip(cfg.tasks, cfg.mix_ratio)}
    if len(schedule) != steps or any(schedule.count(t) < min_each for t in mix):
        raise AssertionError(f"train: ran {schedule}; every task of {sorted(mix)} needs "
                             f"{min_each} of {steps} steps")
    if launches["splat"] != seen["bev"] or seen["bev"] != steps:
        raise AssertionError(f"train: {launches['splat']} splat launches for "
                             f"{seen['bev']} prepare_bev calls in {steps} steps")
    if launches["dropout"] != seen["drop_fwd"] + seen["drop_bwd"] or seen["drop_bwd"] == 0:
        raise AssertionError(
            f"train: {launches['dropout']} dropout launches for {seen['drop_fwd']} "
            f"forward and {seen['drop_bwd']} backward dropout calls")
    values = torch.stack([torch.stack([m["loss"], m["grad_norm"]]) for *_, m in seen["steps"]])
    if not torch.isfinite(values).all() or not (values[:, 1] > 0).all():
        raise AssertionError(f"train: non-finite or zero loss / grad_norm {values.tolist()}")
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
        "seed": seed, "steps": steps, "schedule": schedule, "launches": launches,
        "drop_fwd": seen["drop_fwd"], "drop_bwd": seen["drop_bwd"], "bev": seen["bev"],
        "ms_per_task": ms_per_task, "mix": mix,
        "samples_per_s": cfg.train_batch_size * 1e3 / mix_ms,
        "wall_samples_per_s": cfg.train_batch_size * steps / wall,
        "wall_s": wall, "build_s": build_s,
        "peak_bytes": peak, "n_params": n_params, "meters": meters,
        "first_ms": {t: next(s.elapsed_time(e) for tt, s, e, _ in seen["steps"] if tt == t)
                     for t in per_task},
    }


def slice_phase(device: str, extra_args: list) -> dict:
    """Run the CLI's synthetic eval, instrumented; returns its measurements."""
    from vln_bevbert_tpu_torch.cli import finetune
    from vln_bevbert_tpu_torch.nav import agent as agent_mod
    from vln_bevbert_tpu_torch.ops import bev as bev_mod
    from vln_bevbert_tpu_torch.ops.splat import splat_sums, splat_sums_ref

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
            splat_sums.launches = 0
            t0 = time.perf_counter()
            results = finetune.main(argv)
            wall = time.perf_counter() - t0
            launches = splat_sums.launches
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
    bev_mod.splat_sums = splat_sums_ref
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
                   iters: int = 3) -> dict:
    """DAgger fine-tuning at full width from the pretraining checkpoint,
    through the CLI (``--synthetic --pretrain_ckpt <ckpt> --iters 3
    --log_every 3``: 6 training rollouts, 6 replay updates, one evaluation of
    val_unseen), instrumented; then ``--test --pretrain_ckpt ckpt_latest``."""
    from vln_bevbert_tpu_torch.cli import finetune
    from vln_bevbert_tpu_torch.nav import agent as agent_mod
    from vln_bevbert_tpu_torch.ops import dropout as drop_mod
    from vln_bevbert_tpu_torch.ops.splat import splat_sums

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

    argv = ["--synthetic", "--device", "cuda", "--output_dir", out_dir]
    agent_mod.gather_and_splat, drop_mod.Dropout.forward = counted_gather, counted_dropout
    cls._rollout, cls.learn_from_bundle, cls.init_params = timed_rollout, timed_learn, recorded_init
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        splat_sums.launches = drop_mod.dropout_apply.launches = 0
        t0 = time.perf_counter()
        results = finetune.main(argv + ["--pretrain_ckpt", pretrain_ckpt, "--iters", str(iters),
                                        "--log_every", str(iters)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"splat": splat_sums.launches, "dropout": drop_mod.dropout_apply.launches}
        peak = torch.cuda.max_memory_allocated()
    finally:
        agent_mod.gather_and_splat, drop_mod.Dropout.forward = gather, drop_forward
        cls._rollout, cls.learn_from_bundle, cls.init_params = rollout, learn, init
    agent = seen["agent"]

    nav_names = set(agent.model.state_dict())
    if not nav_names <= pretrain_names or agent.transferred != len(nav_names):
        raise AssertionError(f"finetune: {agent.transferred} entries transferred; the models "
                             f"share {len(nav_names & pretrain_names)} of {len(nav_names)}")
    feedbacks = [fb for fb, *_ in seen["rollouts"]]
    if feedbacks != ["teacher", "sample"] * iters or len(seen["updates"]) != 2 * iters:
        raise AssertionError(f"finetune: rollouts {feedbacks}, {len(seen['updates'])} updates")
    if launches["splat"] != seen["gathers"]:
        raise AssertionError(f"finetune: {launches['splat']} splat launches for "
                             f"{seen['gathers']} gather-and-splat calls")
    if launches["dropout"] != seen["drop_fwd"] + seen["drop_bwd"] or seen["drop_bwd"] == 0:
        raise AssertionError(f"finetune: {launches['dropout']} dropout launches for "
                             f"{seen['drop_fwd']} forward and {seen['drop_bwd']} backward calls")
    losses, norms = agent.logs["IL_loss"], agent.logs["grad_norm"]
    values = torch.tensor(losses + norms)
    if len(losses) != 2 * iters or not torch.isfinite(values).all() or not (values > 0).all():
        raise AssertionError(f"finetune: IL_loss {losses}, grad_norm {norms}")
    unchanged = [n for n, p in agent.model.named_parameters()
                 if torch.equal(p.detach().cpu(), seen["start"][n])]
    if unchanged:
        raise AssertionError(f"finetune: {len(unchanged)} parameters unchanged: {unchanged[:3]}")
    metrics = results["val_unseen"]
    for key in ("sr", "spl", "nDTW"):
        if not 0.0 <= metrics[key] <= 100.0:
            raise AssertionError(f"finetune: {key}={metrics[key]} outside [0, 100]")

    # the saved agent, evaluated on its own, predicts what the trained one did
    for name in ("ckpt_best", "ckpt_latest"):
        if not os.path.isfile(os.path.join(out_dir, name)):
            raise AssertionError(f"finetune: {name} was not written")
    test_dir = os.path.join(out_dir, "test")
    finetune.main(["--synthetic", "--device", "cuda", "--test", "--output_dir", test_dir,
                   "--pretrain_ckpt", os.path.join(out_dir, "ckpt_latest")])

    def by_id(path):
        with open(path) as f:
            return {p["instr_id"]: p["trajectory"] for p in json.load(f)}

    trained = by_id(os.path.join(out_dir, f"preds_val_unseen_{iters}.json"))
    if by_id(os.path.join(test_dir, "preds_val_unseen_0.json")) != trained or len(trained) != 16:
        raise AssertionError("finetune: --test from ckpt_latest predicts other trajectories")
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

    torch.cuda.empty_cache()
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

    small_phase()

    loaded = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "flax"))
    if loaded:
        raise AssertionError(f"JAX modules were imported: {loaded[:5]}")
    print(json.dumps({"kernels": [
        {**SPLAT, "launches": train["launches"]["splat"], **splat_record,
         "launches_eval": run["launches"], "launches_finetune": ft["launches"]["splat"]},
        {**DROPOUT, "launches": train["launches"]["dropout"], **drop_record,
         "launches_finetune": ft["launches"]["dropout"]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
