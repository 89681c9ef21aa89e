"""Per-viewpoint feature stores.

- ``H5FeatureDB``     : HDF5-backed keyed store with an in-memory LRU —
                        the reference's ImageFeaturesDB / get_scanvp_feature
                        (reference map_nav_src/utils/data.py:9-29,
                        pretrain_src/data/dataset.py:87-118) kept one open
                        handle per read; we hold the file open and memoise.
- ``DictFeatureDB``   : in-memory store for tests / synthetic data.
- ``write_synthetic_features`` : fabricate the four HDF5 products of the
                        offline pipeline (36-view pooled features, 14x14 CLIP
                        grids, depth, semantics) for a set of scans.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, Iterable, Optional

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None


def cast_rows(arr: np.ndarray, dtype) -> np.ndarray:
    """``arr`` as ``dtype``, by numpy (float16 rows widen exactly); an array
    that already has the type is returned as it is."""
    if arr.dtype == dtype:
        return arr
    return arr.astype(dtype)


class DictFeatureDB:
    def __init__(self, data: Optional[Dict[str, np.ndarray]] = None):
        self.data = data or {}

    def get(self, scan: str, viewpoint: str) -> np.ndarray:
        return self.data[f"{scan}_{viewpoint}"]

    def __contains__(self, key: str) -> bool:
        return key in self.data


def _h5_version(path: str) -> str:
    st = os.stat(path)
    return f"{st.st_size}-{st.st_mtime_ns}"


class H5FeatureDB:
    """HDF5 store keyed '<scan>_<viewpoint>' with an LRU cache.

    ``max_cache`` bounds host memory; None = unbounded (the reference's
    in_memory=True behaviour).

    Cold-start pack cache: per-key h5py dataset reads cost a B-tree walk +
    tiny read each, so a cold process ingests slowly.
    ``build_pack`` writes a versioned sidecar — one contiguous ``.pack.npy``
    (rows in sorted-key order) + a ``.pack.json`` index stamped with the
    HDF5's size+mtime — which ``get`` then serves by mmap slice: no upfront
    ingest at all, pages fault in on demand with OS readahead. A stale stamp
    (h5 rewritten) silently falls back to the h5 path. The precompute
    pipeline and ``write_synthetic_features`` emit packs beside every store.
    """

    def __init__(self, path: str, dtype=np.float32,
                 max_cache: Optional[int] = None, use_pack: bool = True):
        if h5py is None:
            raise RuntimeError("h5py unavailable")
        self.path = path
        self.dtype = dtype
        self.max_cache = max_cache
        self.use_pack = use_pack
        self._cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._file = None
        self._pid = None
        self._pack = None          # mmap'ed (N, ...) array
        self._pack_rows = None     # key -> row index
        self._pack_checked = False

    def _handle(self):
        # h5py handles must not be shared across fork (HDF5 file locking +
        # internal state); reopen per process so forked loader workers are
        # safe. The LRU cache is plain numpy and fork-shares fine (COW).
        pid = os.getpid()
        if self._file is None or self._pid != pid:
            self._file = h5py.File(self.path, "r")
            self._pid = pid
        return self._file

    # ------------------------------------------------------------- pack
    @property
    def pack_paths(self):
        return self.path + ".pack.npy", self.path + ".pack.json"

    def _open_pack(self):
        """mmap the sidecar if present and version-fresh (once per process;
        the mmap itself is fork-safe, pages share copy-on-write)."""
        if self._pack_checked or not self.use_pack:
            return
        self._pack_checked = True
        arr_p, meta_p = self.pack_paths
        if not (os.path.exists(arr_p) and os.path.exists(meta_p)):
            return
        import json

        try:
            with open(meta_p) as f:
                meta = json.load(f)
            if meta.get("version") != _h5_version(self.path):
                return  # stale: the HDF5 changed since the pack was built
            self._pack = np.load(arr_p, mmap_mode="r")
            self._pack_rows = {k: i for i, k in enumerate(meta["keys"])}
        except (OSError, ValueError, KeyError):  # unreadable sidecar: ignore
            self._pack = self._pack_rows = None

    #: rows bigger than this never pack: per-key h5py overhead (B-tree walk,
    #: ~0.2-0.7 ms) is already amortized by the bulk read, while the doubled
    #: on-disk footprint costs page-cache warmth — measured 6.3 ms/get (h5)
    #: vs 110 ms/get (mmap faulting under cache pressure) on the 3.6 MB-row
    #: grid store. The pack's win is the SMALL-row stores (depth/sem/views:
    #: 5-50x faster than h5 per get).
    PACK_MAX_ROW_BYTES = 1 << 20

    def build_pack(self) -> Optional[str]:
        """Write the sidecar from the HDF5 (one sweep; done offline by the
        precompute pipeline, not on the training hot path). Requires all
        keys to share one shape/dtype, which every product of the feature
        pipeline does (36xD views, Vx196xD grids, VxHxW depth/sem).

        Rows are stored in the CONSUMER dtype (``self.dtype``): per-key
        float16 -> float32 casts dominate a cold ``build_batch``, so casting
        once at pack time makes every pack read a pure mmap slice + memcpy. A reader with
        a different dtype still works — ``get`` casts whatever the pack
        holds. Returns None (no sidecar) for big-row stores, where packing
        is a measured loss (PACK_MAX_ROW_BYTES note)."""
        import json

        f = self._handle()
        keys = sorted(f.keys())
        first = f[keys[0]]
        row_bytes = int(np.prod(first.shape)) * np.dtype(self.dtype).itemsize
        if row_bytes > self.PACK_MAX_ROW_BYTES:
            # an older sidecar of this path, and the pack this store may
            # hold open, would go on serving the old rows: drop both
            for stale in self.pack_paths:
                if os.path.exists(stale):
                    os.remove(stale)
            self._pack_checked = False
            self._pack = self._pack_rows = None
            return None
        arr_p, meta_p = self.pack_paths
        out = np.lib.format.open_memmap(
            arr_p, mode="w+", dtype=np.dtype(self.dtype),
            shape=(len(keys),) + first.shape,
        )
        for i, k in enumerate(keys):
            out[i] = cast_rows(f[k][...], np.dtype(self.dtype))
        out.flush()
        del out
        with open(meta_p, "w") as fh:
            json.dump({"version": _h5_version(self.path), "keys": keys}, fh)
        self._pack_checked = False  # reopen lazily with the fresh stamp
        self._pack = self._pack_rows = None
        return arr_p

    # -------------------------------------------------------------- reads
    def get(self, scan: str, viewpoint: str) -> np.ndarray:
        key = f"{scan}_{viewpoint}"
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
            return hit
        self._open_pack()
        row = self._pack_rows.get(key) if self._pack_rows is not None else None
        if row is not None:
            arr = cast_rows(self._pack[row], self.dtype)
            if not arr.flags.writeable:  # no-cast path: detach from the mmap
                arr = arr.copy()
        else:
            arr = cast_rows(self._handle()[key][...], self.dtype)
        self._cache[key] = arr
        if self.max_cache is not None and len(self._cache) > self.max_cache:
            self._cache.popitem(last=False)
        return arr

    def __contains__(self, key: str) -> bool:
        self._open_pack()
        if self._pack_rows is not None and key in self._pack_rows:
            return True
        return key in self._handle()

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


def write_synthetic_features(
    directory: str,
    rng: np.random.Generator,
    scan_viewpoints: Dict[str, Iterable[str]],
    image_feat_size: int = 512,
    grid_feat_size: int = 768,
    grid_hw: int = 14,
    num_views: int = 12,
    num_sem: int = 40,
    pack: bool = True,
) -> Dict[str, str]:
    """Create the HDF5 files the pretrain pipeline consumes
    (configs/r2r_pretrain.json:39-43 file roles). Depth stored as metres/10,
    matching the reference's scaling (pretrain_cmt.py:125). ``pack`` also
    emits the mmap sidecars (as the real precompute pipeline does), so cold
    loader starts serve from the pack."""
    os.makedirs(directory, exist_ok=True)
    paths = {
        "img_ft": os.path.join(directory, "view_fts.hdf5"),
        "rgb": os.path.join(directory, "grid_fts.hdf5"),
        "depth": os.path.join(directory, "depth.hdf5"),
        "sem": os.path.join(directory, "sem.hdf5"),
    }
    files = {k: h5py.File(p, "w") for k, p in paths.items()}
    try:
        for scan, vps in scan_viewpoints.items():
            for vp in vps:
                key = f"{scan}_{vp}"
                files["img_ft"][key] = rng.normal(
                    size=(36, image_feat_size)
                ).astype(np.float32)
                files["rgb"][key] = rng.normal(
                    size=(num_views, grid_hw * grid_hw, grid_feat_size)
                ).astype(np.float16)
                files["depth"][key] = rng.uniform(
                    0.02, 0.9, (num_views, grid_hw, grid_hw)
                ).astype(np.float16)
                files["sem"][key] = rng.integers(
                    0, num_sem, (num_views, grid_hw, grid_hw)
                ).astype(np.uint8)
    finally:
        for f in files.values():
            f.close()
    if pack:
        # packs carry the TRAINING-consumer dtype per store (pathdata reads:
        # views/depth f32, grids f16, sem uint8) so pack reads never cast
        consumer_dtype = {"img_ft": np.float32, "rgb": np.float16,
                          "depth": np.float32, "sem": np.uint8}
        for k, p in paths.items():
            db = H5FeatureDB(p, dtype=consumer_dtype[k])
            db.build_pack()
            db.close()
    return paths
