"""Where the time of a pretraining step goes.

    python -m vln_bevbert_tpu_torch.cli.profile_train [--steps 2] [--top 15] [--out DIR]

Builds the trainer of ``cli/pretrain.py`` (full-width synthetic world, B=16
and random seeded weights by default; other ``pretrain`` arguments such as
``--config`` or ``--batch_size`` pass through), builds ``--steps`` batches of
every task on the host, runs one step of each task to warm up, then:

1. cProfile over those steps: the host functions by their own time, in ms
   per step;
2. ``torch.profiler`` over the same steps again: wall ms per step by task,
   the device's busy time per step (the union of the kernel and copy
   intervals on the card) and its share of the wall time, and the device ops
   by self device time.

Batches are built before timing, so the loader is outside both windows.
Prints one ``[profile]`` line and the two tables; ``--out`` also writes the
full tables and a Chrome trace there.

    python -m vln_bevbert_tpu_torch.cli.profile_train --ab [--ab_steps 24]

instead holds the dropout kernel against PyTorch's eager bernoulli dropout
(the port's ``Dropout`` before the kernel: a float32 bernoulli buffer, a
compare, a select that saves a bool mask for its backward), in one process:

1. at the step's three largest dropout sites (attention probabilities,
   hidden activations, BEV features), device ms per call of the kernel, the
   eager dropout and PyTorch's fused ``F.dropout`` (torch.profiler);
2. the trainer's own ``train()`` (its per-step loop, ``task_block_size``
   1) over ``--ab_steps`` steps in four arms,
   kernel, eager, eager, kernel, each over the same batches (``--seed 16``
   by default, whose schedule runs each task eight times in 24 steps):
   ms/step per task by CUDA events around each step, without each task's
   first step of an arm; samples/s at the configured task mix; peak device
   memory of the arm.

One ``[ab]`` line per site and per arm, then one ``[ab] {json}`` summary.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .. import _build
from ..ops import dropout as drop_mod
from ..parallel.train_step import upload
from . import pretrain
from .profile_eval import device_busy_us, host_table


def timed_steps(trainer, items) -> list:
    """Seconds of each step of ``items`` [(task, host batch)], each up to the
    end of its device work."""
    times = []
    for task, batch in items:
        t0 = time.perf_counter()
        trainer.step_fn(trainer.state, upload(batch, trainer.device), task)
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        times.append(time.perf_counter() - t0)
    return times


def eager_dropout_forward(self, x):
    """``Dropout.forward`` as PyTorch's eager ops compute it: a float32
    bernoulli draw, a compare, a select (which saves the bool mask)."""
    if not self.training or self.rate == 0.0:
        return x
    keep = torch.bernoulli(torch.full_like(x, 1.0 - self.rate, dtype=torch.float32),
                           generator=self.generator).bool()
    return torch.where(keep, x * (1.0 / (1.0 - self.rate)), torch.zeros_like(x))


def per_call_ms(fn, device, iters: int = 10) -> float | None:
    """Device ms per call of ``fn`` (the union of its kernels' intervals);
    None (not measured) off the card."""
    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize(device)
    return device_busy_us(prof.events()) / 1e3 / iters


def site_ab(trainer) -> list:
    """Kernel vs eager vs ``F.dropout`` at the step's largest dropout sites."""
    m, shapes, b = trainer.cfg.model, trainer.cfg.shapes, trainer.cfg.train_batch_size
    device = trainer.device
    act = torch.bfloat16 if m.dtype == "bfloat16" else torch.float32
    sites = {  # name: (shape, dtype, rate)
        "attn_probs": ((b, m.num_attention_heads, m.num_bev_tokens, m.num_bev_tokens),
                       act, m.attention_probs_dropout_prob),
        "hidden": ((b, shapes.max_txt_len, m.hidden_size), act, m.hidden_dropout_prob),
        "feat": ((b, m.num_bev_tokens, m.bev_grid_feat_size), torch.float32,
                 m.feat_dropout),
    }
    g = torch.Generator(device=device).manual_seed(0)
    eager = drop_mod.Dropout(0.0)
    eager.generator = g
    rows = []
    for name, (shape, dtype, rate) in sites.items():
        x = torch.randn(shape, generator=g, device=device).to(dtype)
        seeds = drop_mod.draw_seeds(shape[0], g, device)
        eager.rate = rate
        row = {"site": name, "shape": list(shape), "dtype": str(dtype).split(".")[-1],
               "rate": rate}
        for label, fn in (("kernel", lambda: drop_mod.dropout(x, seeds, rate)),
                          ("eager", lambda: eager_dropout_forward(eager, x)),
                          ("F.dropout", lambda: torch.nn.functional.dropout(x, rate))):
            row[f"{label}_device_ms"] = per_call_ms(fn, device)
        rows.append(row)
        print("[ab] " + json.dumps(row), flush=True)
    return rows


def train_arm(trainer, steps: int, eager: bool) -> dict:
    """``trainer.train()`` over ``steps`` more steps, with the kernel or the
    eager dropout, timed per step by CUDA events (host clock off the card).
    The arm runs the per-step loop (``task_block_size`` 1), whose every step
    calls ``step_fn``."""
    cuda = trainer.device.type == "cuda"
    step_fn, seen, block_size = trainer.step_fn, [], trainer.cfg.task_block_size

    def mark():
        if not cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def timed_step(state, batch, task):
        start = mark()
        metrics = step_fn(state, batch, task)
        seen.append((task, start, mark()))
        return metrics

    forward = drop_mod.Dropout.forward
    trainer.step_fn, trainer.cfg.task_block_size = timed_step, 1
    if eager:
        drop_mod.Dropout.forward = eager_dropout_forward
    try:
        if cuda:
            torch.cuda.synchronize(trainer.device)
            torch.cuda.reset_peak_memory_stats(trainer.device)
        launches = _build.launches("dropout")
        trainer.train(trainer.state.step + steps)
        if cuda:
            torch.cuda.synchronize(trainer.device)
        launches = _build.launches("dropout") - launches
    finally:
        trainer.step_fn, drop_mod.Dropout.forward = step_fn, forward
        trainer.cfg.task_block_size = block_size
    per_task, first = {}, set()
    for task, start, end in seen:
        if task in first:
            ms = start.elapsed_time(end) if cuda else 1e3 * (end - start)
            per_task.setdefault(task, []).append(ms)
        first.add(task)
    ms_per_task = {t: sum(v) / len(v) for t, v in per_task.items()}
    mix = {t.split("_")[0]: r for t, r in zip(trainer.cfg.tasks, trainer.cfg.mix_ratio)}
    mix_ms = (sum(mix[t] * ms_per_task[t] for t in mix) / sum(mix.values())
              if set(mix) <= set(ms_per_task) else None)
    return {
        "dropout": "eager" if eager else "kernel", "steps": len(seen),
        "kernel_launches": launches, "ms_per_task": ms_per_task,
        "samples_per_s_at_mix": (trainer.cfg.train_batch_size * 1e3 / mix_ms
                                 if mix_ms else None),
        "peak_MiB": torch.cuda.max_memory_allocated(trainer.device) / 2 ** 20 if cuda else None,
    }


def ab_main(steps: int, rest: list) -> dict:
    args = pretrain.parse_args(["--synthetic", "--batch_size", "16", "--seed", "16",
                                "--num_steps", str(8 * steps), *rest])
    trainer = pretrain.build(args)
    sites = site_ab(trainer)
    arms = []
    for eager in (False, True, True, False):
        arms.append(train_arm(trainer, steps, eager))
        print("[ab] " + json.dumps(arms[-1]), flush=True)
    summary = {"card": card_name(trainer.device), "sites": sites, "arms": arms}
    print("[ab] " + json.dumps(summary), flush=True)
    return summary


def card_name(device) -> str:
    if device.type != "cuda":
        return "no card"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None):
    own = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    own.add_argument("--steps", type=int, default=2, help="profiled steps per task")
    own.add_argument("--top", type=int, default=15, help="rows per table")
    own.add_argument("--out", default=None, help="directory for full tables + trace")
    own.add_argument("--ab", action="store_true",
                     help="dropout kernel vs eager dropout, per site and end to end")
    own.add_argument("--ab_steps", type=int, default=24, help="train steps per A/B arm")
    ours, rest = own.parse_known_args(argv)
    if ours.ab:
        return ab_main(ours.ab_steps, rest)
    args = pretrain.parse_args(["--synthetic", "--batch_size", "16", *rest])
    trainer = pretrain.build(args)
    cuda = trainer.device.type == "cuda"
    smi = card_name(trainer.device)
    tasks = [t.split("_")[0] for t in trainer.cfg.tasks]
    build = trainer.train_loader.build_batch
    warm = [build(i, task=t)[1] for i, t in enumerate(tasks)]
    items = [(t, build(len(tasks) + i * len(tasks) + j, task=t)[1])
             for i in range(ours.steps) for j, t in enumerate(tasks)]

    timed_steps(trainer, zip(tasks, warm))  # warm-up: cuBLAS handles, allocator, kernel build

    host = cProfile.Profile()
    host.enable()
    host_s = sum(timed_steps(trainer, items))
    host.disable()

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        traced = timed_steps(trainer, items)
    busy_us = device_busy_us(prof.events())

    n = len(items)
    sort = "self_device_time_total" if cuda else "self_cpu_time_total"
    device_table = prof.key_averages().table(sort_by=sort, row_limit=ours.top)
    summary = {
        "card": smi, "batch_size": trainer.cfg.train_batch_size, "steps": n,
        "host_ms_per_step": 1e3 * host_s / n,
        "traced_ms_per_step": 1e3 * sum(traced) / n,
        "traced_ms_per_task": {t: 1e3 * sum(s for (tt, _), s in zip(items, traced) if tt == t)
                               / ours.steps for t in tasks},
        "device_busy_ms_per_step": busy_us / 1e3 / n if cuda else None,  # None: not measured
        "device_busy_share": busy_us / 1e6 / sum(traced) if cuda else None,
    }
    stats = pstats.Stats(host)
    print("[profile] " + json.dumps(summary), flush=True)
    print(f"[profile] host, cProfile over {n} steps:\n" + host_table(stats, n, ours.top),
          flush=True)
    print(f"[profile] device ops, torch.profiler over {n} steps:\n" + device_table, flush=True)
    if ours.out:
        os.makedirs(ours.out, exist_ok=True)
        with open(os.path.join(ours.out, "profile_train_host.txt"), "w") as f:
            f.write(host_table(stats, n, 200))
        with open(os.path.join(ours.out, "profile_train_device.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by=sort, row_limit=200))
        prof.export_chrome_trace(os.path.join(ours.out, "profile_train_trace.json"))
    return summary


if __name__ == "__main__":
    main()
