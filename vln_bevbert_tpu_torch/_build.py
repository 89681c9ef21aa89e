"""Build and load the hand-written CUDA kernels as PyTorch operators.

``csrc/splat.cu``, ``csrc/dropout.cu`` and ``csrc/stamp.cu`` (the device
phase stamps of ``utils/profiling.py``) hold the kernels and plain C++
launch functions (``csrc/kernels.h``) that include no PyTorch header, so
``nvcc`` compiles them in seconds; ``csrc/ops.cpp`` binds them as
``torch.ops.bevbert.*`` operators with ``TORCH_LIBRARY`` (checks, outputs,
the current stream, the dropout's autograd, the launch counters). The
kernels count their own launches in device memory, so a CUDA graph's
replays are counted where they run.

At first use the four sources are compiled in parallel, one ``nvcc`` each
(``sm_90a`` for the kernels; the binding against the installed torch's
headers and C++ ABI), and linked into one shared library under ``build/`` at
the checkout's root. Its file name hashes the sources, the flags and
``torch.__version__``, so an edited source or another torch is rebuilt and a
stale library is never loaded; ``torch.ops.load_library`` loads it. Nothing
is compiled when this module is imported.
"""

from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
SOURCES = ("ops.cpp", "splat.cu", "dropout.cu", "stamp.cu")
KERNEL_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                "-Xptxas", "-v"]
BINDING_FLAGS = ["-std=c++20", "-O2"]
LIBS = ["-lc10", "-lc10_cuda", "-ltorch_cpu", "-ltorch"]


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _common_flags() -> list:
    from torch.utils import cpp_extension

    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    return (["-Xcompiler", "-fPIC", f"-D_GLIBCXX_USE_CXX11_ABI={abi}"]
            + [f"-I{p}" for p in cpp_extension.include_paths()])


def _link_flags() -> list:
    from torch.utils import cpp_extension

    return [f"-L{p}" for p in cpp_extension.library_paths()] + LIBS


def library_path() -> Path:
    digest = hashlib.sha256()
    for name in sorted(p.name for p in CSRC.iterdir()):
        digest.update(name.encode() + (CSRC / name).read_bytes())
    digest.update(" ".join([torch.__version__, *KERNEL_FLAGS, *BINDING_FLAGS, *LIBS]).encode())
    return BUILD_DIR / f"libbevbert_ops-{digest.hexdigest()[:12]}.so"


def _compile(source: str, obj: Path) -> tuple:
    flags = BINDING_FLAGS if source.endswith(".cpp") else KERNEL_FLAGS
    cmd = [nvcc_path(), *flags, *_common_flags(), "-c", str(CSRC / source), "-o", str(obj)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {source}:\n"
                           f"{proc.stdout}{proc.stderr}")
    return secs, proc.stdout + proc.stderr


def build() -> tuple:
    """Compile and link the library unless it exists.

    Returns (library path, {source: (seconds, compiler log)}); the kernels'
    logs hold ptxas's register and shared-memory report. The dict is empty
    when nothing was compiled."""
    out = library_path()
    if out.exists():
        return out, {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = {src: BUILD_DIR / f"{tag}.{src}.o" for src in SOURCES}
    with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc process per source
        logs = dict(zip(SOURCES, pool.map(_compile, SOURCES, objs.values())))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), "-shared", "-o", str(tmp),
                           *map(str, objs.values()), *_link_flags()],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) linking {out.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    logs["link"] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    for obj in objs.values():
        obj.unlink()
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    return out, logs


@functools.cache
def load():
    """Build (if needed) and load the library; returns ``torch.ops.bevbert``."""
    path, _ = build()
    torch.ops.load_library(str(path))
    return torch.ops.bevbert


def launches(kernel: str) -> int:
    """Launches of ``kernel`` ("splat" or "dropout", forward and backward)
    that ran on the current device since the library was loaded or the
    counts were reset, graph replays included; 0 before it is loaded, since
    nothing can have launched. Synchronises the device."""
    if load.cache_info().currsize == 0:
        return 0
    return torch.ops.bevbert.launch_count(kernel)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    if load.cache_info().currsize:
        torch.ops.bevbert.reset_launch_counts()

