"""Where the time of DAgger fine-tuning goes.

    python -m vln_bevbert_tpu_torch.cli.profile_finetune [--repeats 2] [--top 15] [--out DIR]

Builds the agent of ``cli/finetune.py`` (full-width synthetic world, B=4 and
random seeded weights by default; other ``finetune`` arguments such as
``--config`` or ``--pretrain_ckpt`` pass through), runs one DAgger
iteration to warm up (a teacher-forced and a sampled rollout, each with its
replay update), then measures two parts apart:

- ``rollout``: one sampled training rollout, which records its steps (its
  replay update is left out);
- ``update``: one replay update of the warm-up's teacher-forced episode
  (language, panorama encoder over all steps, per-step navigation forward,
  backward through the episode, clip, AdamW).

For each part, cProfile over ``--repeats`` runs (host functions by their own
time, ms per run), then ``torch.profiler`` over one more run: wall ms, the
device's busy time (the union of the kernel and copy intervals on the card)
and its share of the wall time, and the device ops by self device time.
Prints one ``[profile] {json}`` summary and the tables; ``--out`` also
writes the full tables and a Chrome trace per part.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..nav.agent import IGNORE_ID
from . import finetune
from .profile_eval import card_name, device_busy_us, host_table


def timed(fn, device) -> float:
    """Seconds of ``fn()``, up to the end of its device work."""
    t0 = time.perf_counter()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def measure(name: str, fn, device, repeats: int, top: int, out: str | None) -> dict:
    cuda = device.type == "cuda"
    host = cProfile.Profile()
    host.enable()
    host_s = sum(timed(fn, device) for _ in range(repeats))
    host.disable()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        traced_s = timed(fn, device)
    busy_us = device_busy_us(prof.events())
    sort = "self_device_time_total" if cuda else "self_cpu_time_total"
    stats = pstats.Stats(host)
    print(f"[profile] {name}, host, cProfile, ms per run:\n"
          + host_table(stats, repeats, top, per="run"), flush=True)
    print(f"[profile] {name}, device ops, torch.profiler over one run:\n"
          + prof.key_averages().table(sort_by=sort, row_limit=top), flush=True)
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"profile_finetune_{name}_host.txt"), "w") as f:
            f.write(host_table(stats, repeats, 200, per="run"))
        with open(os.path.join(out, f"profile_finetune_{name}_device.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by=sort, row_limit=200))
        prof.export_chrome_trace(os.path.join(out, f"profile_finetune_{name}_trace.json"))
    return {
        "host_ms": 1e3 * host_s / repeats,
        "traced_ms": 1e3 * traced_s,
        "device_busy_ms": busy_us / 1e3 if cuda else None,  # None: not measured
        "device_busy_share": busy_us / 1e6 / traced_s if cuda else None,
        "peak_MiB": torch.cuda.max_memory_allocated(device) / 2 ** 20 if cuda else None,
    }


def main(argv=None):
    own = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    own.add_argument("--repeats", type=int, default=2, help="runs per part under cProfile")
    own.add_argument("--top", type=int, default=15, help="rows per table")
    own.add_argument("--out", default=None, help="directory for full tables + traces")
    ours, rest = own.parse_known_args(argv)
    args = finetune.parse_args(["--synthetic", *rest])
    _, _, _, agent = finetune.build(args)
    device = agent.device
    learn, bundles = agent.learn_from_bundle, []

    def keep(rb):
        bundles.append(rb)
        return learn(rb)

    agent.learn_from_bundle = keep
    agent.train_iters(1, feedback="dagger")  # warm-up: cuBLAS, allocator, kernel builds
    agent.learn_from_bundle = bundles.append  # rollouts below record, nothing more
    replay = bundles[0]  # the teacher-forced episode
    replay_steps = int((np.asarray(replay["targets"]) != IGNORE_ID).any(axis=1).sum())

    steps = []

    def rollout():
        n = len(bundles)
        agent.rollout(feedback="sample", train=True)
        steps.append(int((np.asarray(bundles[n]["targets"]) != IGNORE_ID).any(axis=1).sum()))

    summary = {"card": card_name(device), "batch_size": agent.cfg.batch_size}
    summary["rollout"] = measure("rollout", rollout, device, ours.repeats, ours.top, ours.out)
    summary["rollout"]["steps_per_run"] = steps
    summary["update"] = measure("update", lambda: learn(replay), device, ours.repeats,
                                ours.top, ours.out)
    summary["update"]["replay_steps"] = replay_steps
    print("[profile] " + json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
