"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's three paths at full bert-base width with random seeded
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
             store), pretraining (float16 features and semantic labels) and
             CE shapes and at edge cases; per shape its time, its byte bound
             and the share reached, the library calls ``index_add_`` and
             one-hot ``torch.bmm``; the navigation BEV step's device time,
             fused against the parent's gather, concat and splat;
4. dropout - the dropout operator against its plain version, bitwise, at the
             pretraining step's and the replay update's largest sites and at
             edge cases, beside ``F.dropout``; P(keep); host us per launch;
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

Launch counts are the operators' own (C++, ``_build.launches``), set to 0
just before each path and read just after it. The second-to-last line is a
JSON record of the kernels; the last line is ``{"ok": true, "device": {...}}``.
The port imports neither JAX nor the JAX package ``vln_bevbert_tpu``, and
the run checks that none of their modules was loaded.
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
# The count and one-hot columns are integer-valued and must match exactly;
# feature sums of bf16 values accumulate in float32 in another order
# (atomics), hence:
RTOL, ATOL = 1e-5, 1e-3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)


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
    for _ in range(3):  # the tracer has returned a session without device events
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
    raise RuntimeError("torch.profiler recorded no device time in three sessions")


def device_ms(fn, iters: int = 10) -> float:
    """Mean device milliseconds per call of all the kernels ``fn`` runs."""
    return sum(device_ms_by_kernel(fn, iters).values())


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
        "ce": (8, 1, 2352, 1, 121, 768, 0, torch.bfloat16),       # the 11x11 CE map
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
        if label in ("hidden", "ft_pano_hidden"):
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
    if not (torch.equal(x.grad, dropout_ref(dy, seeds, 0.1))
            and torch.equal(x.grad != 0, (y != 0) & (dy != 0))):
        raise AssertionError("dropout: the backward's mask differs from the forward's")
    phase("dropout", edges="rate0 ragged_rows misaligned single_row", backward_mask="equal",
          saved="seeds only", backward_launch="counted")
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
    from vln_bevbert_tpu_torch import _build
    from vln_bevbert_tpu_torch.cli import pretrain
    from vln_bevbert_tpu_torch.ops import dropout as drop_mod
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
        _build.reset_launches()
        t0 = time.perf_counter()
        meters = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"dropout": _build.launches("dropout"), "splat": _build.launches("splat")}
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
                   iters: int = 3) -> dict:
    """DAgger fine-tuning at full width from the pretraining checkpoint,
    through the CLI (``--synthetic --pretrain_ckpt <ckpt> --iters 3
    --log_every 3``: 6 training rollouts, 6 replay updates, one evaluation of
    val_unseen), instrumented; then ``--test --pretrain_ckpt ckpt_latest``."""
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

    argv = ["--synthetic", "--device", "cuda", "--output_dir", out_dir]
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

    loaded = sorted(k for k in sys.modules if k.split(".")[0] in
                    ("vln_bevbert_tpu", "jax", "jaxlib", "flax", "optax", "orbax"))
    if loaded:
        raise AssertionError(f"JAX or JAX-package modules were imported: {loaded[:5]}")
    # "launches" is the pretraining path's count; "ms", "bound_ms" and
    # "library_ms" are at the navigation shape (splat) and the attention
    # probabilities (dropout); every shape's numbers are nested beside them
    print(json.dumps({"kernels": [
        {**SPLAT, "launches": train["launches"]["splat"], **splat_record, "bound_by": "bytes",
         "launches_eval": run["launches"], "launches_finetune": ft["launches"]["splat"]},
        {**DROPOUT, "launches": train["launches"]["dropout"], **drop_record,
         "bound_by": "bytes", "launches_finetune": ft["launches"]["dropout"]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
