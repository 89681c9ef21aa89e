"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's navigation-eval path (``vln_bevbert_tpu_torch.cli.finetune
--synthetic --test``) at full bert-base width with random seeded weights,
through the hand-written CUDA splat kernel, in phases; each phase prints one
line and a failing phase raises, so the script exits non-zero:

1. device  - a CUDA card must be present; its name and power limit;
2. build   - compile ``csrc/splat.cu`` with nvcc for sm_90a into ``build/``;
3. kernel  - the kernel against its plain PyTorch version on the card at the
             navigation, pretraining and CE shapes and at edge cases;
4. slice   - the full-width synthetic eval; the kernel's launch count must
             equal the number of gather-and-splat calls, and the first step's
             BEV features and action must match the plain version's;
5. small   - a small configuration evaluated on the card and on the CPU with
             the same parameters: equal trajectories, close logits.

The second-to-last line is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``. The port imports no JAX: the host modules
it shares with ``vln_bevbert_tpu`` are JAX-free, and the run checks that no
JAX module was loaded.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import torch

SPLAT = {"name": "splat_sums", "route": "cuda",
         "source": "vln_bevbert_tpu_torch/csrc/splat.cu",
         "replaces": "vln_bevbert_tpu/ops/pallas_splat.py:47"}
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
    from vln_bevbert_tpu_torch import _build

    t0 = time.perf_counter()
    path, log = _build.build("splat")
    secs = time.perf_counter() - t0
    _build.load("splat")
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "smem" in ln]
    phase("build", seconds=f"{secs:.2f}", library=path.name, ptxas=repr(" | ".join(ptxas)))


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
            _, val_envs, agents[device] = finetune.build(args)
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
    record = kernel_phase()

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

    small_phase()

    loaded = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "flax"))
    if loaded:
        raise AssertionError(f"JAX modules were imported: {loaded[:5]}")
    print(json.dumps({"kernels": [{**SPLAT, "launches": run["launches"], **record}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
