"""The seeded-dropout kernel's device time at the training paths' sites, on
the card, for one or more versions of its source held against each other.

    python -m vln_bevbert_tpu_torch.cli.profile_dropout [--csrc DIR ...]
        [--variants 256x2,128x1,...] [--ceiling] [--out FILE]

The versions: this package's ``csrc/``; each ``--csrc`` directory (another
checkout's ``vln_bevbert_tpu_torch/csrc``, e.g. the parent commit's); each
``--variants`` entry ``THREADSxUNROLL``, a copy of ``csrc/`` under
``build/dropout_variants/`` whose ``dropout.cu`` has those ``kThreads`` and
``kUnroll``; with ``--ceiling``, a copy whose Philox returns all ones
(every element kept, no bits drawn): the time of the kernel's accesses and
arithmetic without its generator, the one version not held to the plain
version. Each version is built (all at once, one process each; the
library's name hashes its sources) and then timed in a process of its own,
since two libraries of the ``bevbert`` operators cannot load into one, in
turns A B ... B A. Per site and turn: the kernel's device us (torch.profiler
over calls that cycle over enough input copies that the others move twice
the L2 between two uses of one: a cold L2, as the kernel meets it in a
step), ``F.dropout``'s in the same process, their ratio, a plain copy's
(``torch.clone``: the same bytes read and written), and the share of the
byte bound (input read once, output written once, at 3.35 TB/s). Every
version's output is held to the plain version bit for bit first.

One ``[dropout]`` line per version, turn and site, then one ``[dropout]
{json}`` summary (each version's mean over its turns); ``--out`` writes the
summary there too.
"""

from __future__ import annotations

import argparse
import collections
import itertools
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from .. import _build

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
# (shape, dtype, rate): pretraining's attention probabilities (and dp's one
# process at B=32), hidden activations and BEV features; the replay
# update's attention probabilities and panorama; CE's replay attention
# probabilities; dp_ce's float32 ones; PREVALENT's self-attention
SITES = {
    "attn_probs": ((16, 12, 441, 441), torch.bfloat16, 0.1),
    "attn_probs_b32": ((32, 12, 441, 441), torch.bfloat16, 0.1),
    "feat": ((16, 441, 768), torch.float32, 0.4),
    "hidden": ((16, 200, 768), torch.bfloat16, 0.1),
    "ft_attn_probs": ((4, 12, 441, 441), torch.bfloat16, 0.1),
    "ft_pano_hidden": ((60, 44, 768), torch.bfloat16, 0.1),
    "ce_replay_attn_probs": ((8, 12, 121, 121), torch.bfloat16, 0.1),
    "dp_ce_attn_probs_b4": ((4, 12, 121, 121), torch.float32, 0.1),
    "prev_self_attn_probs": ((8, 12, 7, 7), torch.bfloat16, 0.1),
}
MAX_COPIES = 64
H100_L2_BYTES = 50 << 20  # where the device properties lack the L2's size


def device_us(fn, iters: int = 20) -> float:
    """Mean device us per call of everything ``fn`` runs (torch.profiler),
    retried while the tracer returns a session without device events."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if spans:
            return sum(r.end - r.start for r in spans) / iters
    raise RuntimeError("torch.profiler recorded no device time in six sessions")


def time_sites(label: str, turn: int, check: bool = True) -> dict:
    """Every site's numbers with the library built from ``_build.CSRC``."""
    import torch.nn.functional as F

    from ..ops.dropout import draw_seeds, dropout, dropout_ref

    _build.load()
    g = torch.Generator(device="cuda").manual_seed(0)
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", H100_L2_BYTES)
    out = {}
    for site, (shape, dtype, rate) in SITES.items():
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        seeds = draw_seeds(shape[0], g, "cuda")
        if check and not torch.equal(dropout(x, seeds, rate), dropout_ref(x, seeds, rate)):
            raise AssertionError(f"{label} {site}: the kernel differs from the plain version")
        moved = 2 * x.numel() * x.element_size()
        n_copies = min(MAX_COPIES, 2 + -(-2 * l2 // moved))
        xs = [x] + [x.clone() for _ in range(n_copies - 1)]
        turns, kept = itertools.count(), collections.deque(maxlen=n_copies)

        def cycled(fn):
            return lambda: kept.append(fn(xs[next(turns) % n_copies]))

        us = device_us(cycled(lambda v: dropout(v, seeds, rate)))
        lib_us = device_us(cycled(lambda v: F.dropout(v, rate)))
        copy_us = device_us(cycled(torch.clone))
        bound_us = 1e6 * (moved + 4 * seeds.numel()) / HBM_BYTES_PER_S
        cold = (n_copies - 1) * moved >= 2 * l2
        out[site] = {"device_us": us, "F_dropout_device_us": lib_us,
                     "F_dropout_ratio": us / lib_us, "copy_device_us": copy_us,
                     "bound_us": bound_us,
                     "bound_share": bound_us / us, "cache": "cold" if cold else "warm"}
        print(f"[dropout] version={label} turn={turn} site={site} shape={tuple(shape)} "
              f"dtype={str(dtype).split('.')[-1]} device_us={us:.2f} "
              f"F_dropout_device_us={lib_us:.2f} F_dropout_ratio={us / lib_us:.3f} "
              f"copy_device_us={copy_us:.2f} "
              f"bound_us={bound_us:.2f} bound_share={bound_us / us:.1%} "
              f"cache={out[site]['cache']}", flush=True)
        del xs, kept
    return out


def patched_csrc(name: str, edit) -> Path:
    """A copy of ``csrc/`` under ``build/dropout_variants/<name>/`` whose
    ``dropout.cu`` is ``edit(its text)``."""
    dest = _build.BUILD_DIR / "dropout_variants" / name / "csrc"
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(_build.CSRC, dest)
    source = dest / "dropout.cu"
    source.write_text(edit(source.read_text()))
    return dest


def variant_csrc(threads: int, unroll: int) -> Path:
    """A copy of ``csrc/`` with ``dropout.cu``'s kThreads and kUnroll set."""
    def edit(src):
        for name, value in (("kThreads", threads), ("kUnroll", unroll)):
            src, n = re.subn(rf"constexpr int {name} = \d+;",
                             f"constexpr int {name} = {value};", src)
            if n != 1:
                raise RuntimeError(f"dropout.cu defines {name} {n} times")
        return src

    return patched_csrc(f"t{threads}_u{unroll}", edit)


CEILING = "ceiling"
PHILOX = "__device__ __forceinline__ uint4 philox(uint32_t g, uint32_t k0) {\n"


def ceiling_csrc() -> Path:
    """A copy of ``csrc/`` whose Philox returns all ones."""
    def edit(src):
        if src.count(PHILOX) != 1:
            raise RuntimeError("dropout.cu's philox() is not where the ceiling expects it")
        return src.replace(PHILOX, PHILOX + "  return make_uint4(~0u, ~0u, ~0u, ~0u);\n")

    return patched_csrc(CEILING, edit)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def child(csrc: str, label: str, turn: int, build_only: bool) -> None:
    _build.CSRC = Path(csrc).resolve()
    if build_only:
        path, logs = _build.build()
        log = logs.get("dropout.cu", (0, ""))[1]
        ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"[dropout] version={label} library={path.name} ptxas={' | '.join(ptxas)!r}",
              flush=True)
        return
    sites = time_sites(label, turn, check=label != CEILING)
    print("[dropout] " + json.dumps({"version": label, "turn": turn, "sites": sites}), flush=True)


def run(versions: dict, build_only: bool, turn: int = 0) -> list:
    """Each version's child process: all at once to build, one by one to
    time. Returns the parsed JSON lines."""
    cmd = lambda label, csrc: [  # noqa: E731
        sys.executable, "-m", "vln_bevbert_tpu_torch.cli.profile_dropout", "--child", str(csrc),
        "--label", label, "--turn", str(turn)] + (["--build_only"] if build_only else [])
    if build_only:
        procs = [subprocess.Popen(cmd(label, csrc)) for label, csrc in versions.items()]
        if any([p.wait() for p in procs]):
            raise RuntimeError("a version failed to build")
        return []
    results = []
    for label, csrc in versions.items():
        proc = subprocess.run(cmd(label, csrc), capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            raise RuntimeError(f"version {label} failed:\n{proc.stderr[-4000:]}")
        last = [ln for ln in proc.stdout.splitlines() if ln.startswith("[dropout] {")][-1]
        results.append(json.loads(last[len("[dropout] "):]))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", nargs="*", default=[], help="other csrc/ directories")
    ap.add_argument("--variants", default="", help="THREADSxUNROLL,... of this csrc/")
    ap.add_argument("--ceiling", action="store_true",
                    help="also time this csrc/ with Philox returning all ones")
    ap.add_argument("--out", default=None, help="file for the JSON summary")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--label", default="", help=argparse.SUPPRESS)
    ap.add_argument("--turn", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--build_only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child, args.label, args.turn, args.build_only)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_dropout needs a CUDA device")
    smi = card()
    print(f"[dropout] card={smi!r}", flush=True)
    versions = {"this": _build.CSRC}
    versions.update({f"csrc{i}:{d}": Path(d) for i, d in enumerate(args.csrc)})
    for spec in filter(None, args.variants.split(",")):
        threads, unroll = (int(v) for v in spec.split("x"))
        versions[spec] = variant_csrc(threads, unroll)
    if args.ceiling:
        versions[CEILING] = ceiling_csrc()
    run(versions, build_only=True)
    order = list(versions.items())
    results = run(dict(order), False, 0) + run(dict(order[::-1]), False, 1)
    summary = {"card": smi, "versions": {}}
    for label in versions:
        turns = [r["sites"] for r in results if r["version"] == label]
        per_site = summary["versions"][label] = {}
        for site in SITES:
            row = {key: sum(t[site][key] for t in turns) / len(turns) for key in (
                "device_us", "F_dropout_device_us", "F_dropout_ratio", "copy_device_us",
                "bound_share")}
            row["turns_device_us"] = [t[site]["device_us"] for t in turns]
            per_site[site] = row
    print("[dropout] " + json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
