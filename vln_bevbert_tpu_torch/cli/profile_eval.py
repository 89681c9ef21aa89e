"""Where the time of a navigation-eval step goes.

    python -m vln_bevbert_tpu_torch.cli.profile_eval [--rollouts 2] [--top 12] [--out DIR]

Builds the eval of ``cli/finetune.py`` (full-width synthetic world and random
seeded weights by default; other ``finetune`` arguments such as ``--config``
pass through), runs one rollout to warm up, then:

1. cProfile over ``--rollouts`` rollouts: the host functions by their own
   time, in ms per navigation step;
2. ``torch.profiler`` over one more rollout: wall ms per step, the device's
   busy time per step (the union of the kernel and copy intervals on the
   card) and its share of the wall time, and the device ops by self device
   time.

Prints one ``[profile]`` line and the two tables; ``--out`` also writes the
full tables and a Chrome trace there.
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

from . import finetune


def count_steps(agent) -> dict:
    """Wrap the agent's forward so that it counts navigation forwards."""
    counter = {"steps": 0}
    forward = agent._forward

    def counted(mode, batch):
        if mode == "navigation":
            counter["steps"] += 1
        return forward(mode, batch)

    agent._forward = counted
    return counter


def timed_rollout(agent) -> float:
    """Seconds of one greedy rollout, up to the end of its device work."""
    t0 = time.perf_counter()
    agent.rollout()
    if agent.device.type == "cuda":
        torch.cuda.synchronize(agent.device)
    return time.perf_counter() - t0


def device_busy_us(events) -> float:
    """Length of the union of the device-side event intervals (us)."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy, reach = 0.0, float("-inf")
    for start, end in spans:
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def host_table(stats: pstats.Stats, steps: int, top: int) -> str:
    rows = sorted(stats.stats.items(), key=lambda kv: kv[1][2], reverse=True)
    lines = [f"{'own ms/step':>12} {'cum ms/step':>12} {'calls':>8}  function"]
    for (path, line, func), (_, calls, own, cum, _) in rows[:top]:
        where = f"{os.path.basename(os.path.dirname(path))}/{os.path.basename(path)}:{line}"
        lines.append(f"{1e3 * own / steps:12.3f} {1e3 * cum / steps:12.3f} {calls:8d}  "
                     f"{where}({func})")
    return "\n".join(lines)


def main(argv=None):
    own = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    own.add_argument("--rollouts", type=int, default=2, help="rollouts under cProfile")
    own.add_argument("--top", type=int, default=12, help="rows per table")
    own.add_argument("--out", default=None, help="directory for full tables + trace")
    ours, rest = own.parse_known_args(argv)
    args = finetune.parse_args(["--synthetic", "--test", *rest])
    _, val_envs, agent = finetune.build(args)
    agent.env = next(iter(val_envs.values()))
    agent.env.reset_epoch(shuffle=False)
    counter = count_steps(agent)
    if agent.device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    else:
        smi = "no card"

    timed_rollout(agent)  # warm-up: cuBLAS handles, allocator, kernel build

    counter["steps"] = 0
    host = cProfile.Profile()
    host.enable()
    host_s = sum(timed_rollout(agent) for _ in range(ours.rollouts))
    host.disable()
    host_steps = counter["steps"]

    counter["steps"] = 0
    activities = [ProfilerActivity.CPU]
    if agent.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        traced_s = timed_rollout(agent)
    traced_steps = counter["steps"]
    busy_us = device_busy_us(prof.events())

    stats = pstats.Stats(host)
    sort = "self_device_time_total" if agent.device.type == "cuda" else "self_cpu_time_total"
    device_table = prof.key_averages().table(sort_by=sort, row_limit=ours.top)
    summary = {
        "card": smi,
        "host_steps": host_steps,
        "host_ms_per_step": 1e3 * host_s / host_steps,
        "traced_steps": traced_steps,
        "traced_ms_per_step": 1e3 * traced_s / traced_steps,
        "device_busy_ms_per_step": None,   # no card: not measured
        "device_busy_share": None,
    }
    if agent.device.type == "cuda":
        summary["device_busy_ms_per_step"] = busy_us / 1e3 / traced_steps
        summary["device_busy_share"] = busy_us / 1e6 / traced_s
    print("[profile] " + json.dumps(summary), flush=True)
    print(f"[profile] host, cProfile over {host_steps} steps:\n"
          + host_table(stats, host_steps, ours.top), flush=True)
    print(f"[profile] device ops, torch.profiler over {traced_steps} steps:\n"
          + device_table, flush=True)
    if ours.out:
        os.makedirs(ours.out, exist_ok=True)
        with open(os.path.join(ours.out, "profile_eval_host.txt"), "w") as f:
            f.write(host_table(stats, host_steps, 200))
        with open(os.path.join(ours.out, "profile_eval_device.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by=sort, row_limit=200))
        prof.export_chrome_trace(os.path.join(ours.out, "profile_eval_trace.json"))
    return summary


if __name__ == "__main__":
    main()
