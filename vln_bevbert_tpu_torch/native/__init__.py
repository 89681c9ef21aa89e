"""ctypes bindings for the native nav-graph engine (navgraph.cpp).

Compiled on demand with g++ into ``build/`` at the checkout's root, under a
name that carries a hash of the source, so an edited source is rebuilt and
a stale library is never loaded. Every binding has a pure-Python fallback
(data/nav_graph.NavGraph, nav/graph_map.FloydGraph), so the package works
without a toolchain; with it, the per-step Floyd relaxation and scan-level
all-pairs Dijkstra run in C++. This is host code: nothing here runs on the
card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "navgraph.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build")

_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"libnavgraph-{digest}.so")


def _build() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    try:
        so = _library_path()
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
                check=True, capture_output=True,
            )
            os.replace(tmp, so)  # atomic: concurrent builders never see a partial file
        lib = ctypes.CDLL(so)
    except (OSError, subprocess.CalledProcessError):
        _build_failed = True
        return None
    c_int, c_dbl, c_ptr = ctypes.c_int, ctypes.c_double, ctypes.c_void_p
    ip = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    dp = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.sg_create.restype = c_ptr
    lib.sg_create.argtypes = [c_int, ip, dp, c_int]
    lib.sg_destroy.argtypes = [c_ptr]
    lib.sg_distances.argtypes = [c_ptr, dp]
    lib.sg_distance.restype = c_dbl
    lib.sg_distance.argtypes = [c_ptr, c_int, c_int]
    lib.sg_path.restype = c_int
    lib.sg_path.argtypes = [c_ptr, c_int, c_int, ip, c_int]
    lib.fg_create.restype = c_ptr
    lib.fg_create.argtypes = [c_int]
    lib.fg_destroy.argtypes = [c_ptr]
    lib.fg_add_edge.argtypes = [c_ptr, c_int, c_int, c_dbl]
    lib.fg_update.argtypes = [c_ptr, c_int]
    lib.fg_distance.restype = c_dbl
    lib.fg_distance.argtypes = [c_ptr, c_int, c_int]
    lib.fg_visited.restype = c_int
    lib.fg_visited.argtypes = [c_ptr, c_int]
    lib.fg_path.restype = c_int
    lib.fg_path.argtypes = [c_ptr, c_int, c_int, ip, c_int]
    lib.dtw_positions.restype = c_dbl
    lib.dtw_positions.argtypes = [dp, c_int, dp, c_int]
    lib.dtw_costmatrix.restype = c_dbl
    lib.dtw_costmatrix.argtypes = [dp, c_int, c_int]
    _lib = lib
    return lib


def available() -> bool:
    return _build() is not None


class NativeStaticGraph:
    """All-pairs shortest paths over a full scan graph (C++ Dijkstra)."""

    def __init__(self, n_nodes: int, edges: np.ndarray, weights: np.ndarray):
        lib = _build()
        if lib is None:
            raise RuntimeError("native navgraph unavailable")
        self._lib = lib
        self.n = n_nodes
        edges = np.ascontiguousarray(edges, np.int32).reshape(-1)
        weights = np.ascontiguousarray(weights, np.float64)
        self._h = lib.sg_create(n_nodes, edges, weights, len(weights))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.sg_destroy(self._h)
            self._h = None

    def distances(self) -> np.ndarray:
        out = np.empty((self.n, self.n), np.float64)
        self._lib.sg_distances(self._h, out.reshape(-1))
        return out

    def distance(self, i: int, j: int) -> float:
        return self._lib.sg_distance(self._h, i, j)

    def path(self, i: int, j: int) -> list:
        buf = np.empty(self.n + 1, np.int32)
        n = self._lib.sg_path(self._h, i, j, buf, len(buf))
        if n < 0:
            raise ValueError(f"no path {i}->{j}")
        return buf[:n].tolist()


class NativeFloydGraph:
    """Incremental explored-subgraph shortest paths with the FloydGraph
    string-id surface (drop-in for nav/graph_map.FloydGraph)."""

    INF = 95959595.0

    def __init__(self, capacity: int = 256):
        lib = _build()
        if lib is None:
            raise RuntimeError("native navgraph unavailable")
        self._lib = lib
        self.capacity = capacity
        self._h = lib.fg_create(capacity)
        self._ids = {}
        self._names = []

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.fg_destroy(self._h)
            self._h = None

    def _id(self, name: str) -> int:
        i = self._ids.get(name)
        if i is None:
            i = len(self._names)
            assert i < self.capacity, "FloydGraph capacity exceeded"
            self._ids[name] = i
            self._names.append(name)
        return i

    def add_edge(self, x: str, y: str, dis: float):
        self._lib.fg_add_edge(self._h, self._id(x), self._id(y), dis)

    def update(self, k: str):
        self._lib.fg_update(self._h, self._id(k))

    def visited(self, k: str) -> bool:
        if k not in self._ids:
            return False
        return bool(self._lib.fg_visited(self._h, self._ids[k]))

    def distance(self, x: str, y: str) -> float:
        if x == y:
            return 0.0
        if x not in self._ids or y not in self._ids:
            return self.INF
        d = self._lib.fg_distance(self._h, self._ids[x], self._ids[y])
        return self.INF if d == float("inf") else d

    def path(self, x: str, y: str) -> list:
        if x == y:
            return []
        buf = np.empty(self.capacity, np.int32)
        n = self._lib.fg_path(self._h, self._ids[x], self._ids[y], buf, len(buf))
        if n < 0:
            raise ValueError(f"no path {x}->{y}")
        return [self._names[i] for i in buf[:n]]


def dtw_positions(a: np.ndarray, b: np.ndarray) -> Optional[float]:
    """Exact euclidean DTW between (n,3) and (m,3) position sequences in
    C++ (navgraph.cpp dtw_positions); None when the toolchain is absent.
    Role of the reference's fastdtw dep in the CE nDTW measure
    (habitat_extensions/measures.py:266-336) — exact, O(m) memory."""
    lib = _build()
    if lib is None:
        return None
    a = np.ascontiguousarray(np.asarray(a, np.float64).reshape(-1, 3))
    b = np.ascontiguousarray(np.asarray(b, np.float64).reshape(-1, 3))
    return float(lib.dtw_positions(a.reshape(-1), len(a), b.reshape(-1), len(b)))


def dtw_costmatrix(costs: np.ndarray) -> Optional[float]:
    """DTW over a precomputed (n, m) ground-cost matrix (graph geodesics in
    the discrete eval path, r2r/eval_utils.py:6-26)."""
    lib = _build()
    if lib is None:
        return None
    c = np.ascontiguousarray(costs, np.float64)
    n, m = c.shape
    return float(lib.dtw_costmatrix(c.reshape(-1), n, m))
