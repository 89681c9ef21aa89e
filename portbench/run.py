"""Run one benchmark cell once and print its result as the last line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the program (``vln_bevbert_tpu_torch``). The run needs as many CUDA
cards as the cell asks for: without them it exits with code 2 and prints no
result. It loads, warms up, measures for ``--seconds``, checks what the timed
path produced against the plain reference, and prints one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and ``checks``: each compared number with its
limit, which the last lines of standard error repeat. A run that finds JAX
or the JAX package loaded exits with code 3 and prints no result.

The program's kernels are built into the checkout's ``build/`` on first use;
every other cache of the run goes there too, at fixed paths.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import harness  # noqa: E402

os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")
os.environ.setdefault("TRITON_CACHE_DIR", str(harness.ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(harness.ROOT / "build" / "torch_extensions"))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(device, memory_peak: int, record: harness.Record, trace: bool) -> dict:
    import torch

    info = {"platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": int(memory_peak)}
    if trace and record.traced:
        info["busy_s"] = record.traced["busy_s"]
        info["window_s"] = record.traced["window_s"]
    return info


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None, root=harness.ROOT, need_card: bool = True, device_name: str = "cuda",
         t_start: float = T_START) -> int:
    args = parse_args(argv)
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    try:
        cell = harness.resolve(args.workload, root)
        job = harness.job_module(cell)
    except harness.HarnessError as err:
        log(f"[portbench] {err}")
        return 2
    import torch

    if need_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            log(f"[portbench] {cell.name} needs {cell.chips} CUDA card(s); "
                f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        log(f"[portbench] card: {power_limit()}")
    device = torch.device(device_name)
    result = job.run(cell, args.seed, args.seconds, bool(args.trace), device, t_start, log)
    bad = harness.forbidden_modules()
    if bad:
        log(f"[portbench] the run loaded {', '.join(bad)}: it must not load JAX or the "
            "JAX package")
        return 3
    line = harness.result_line(cell, result, bool(args.trace),
                               device_info(device, result.memory_peak_bytes, result.record,
                                           bool(args.trace)))
    for c in result.checks:
        log(f"[portbench] check {c.name} = {c.value!r} (limit {c.limit!r}; worst at {c.where})"
            f" {'ok' if c.ok else 'FAILED'}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
