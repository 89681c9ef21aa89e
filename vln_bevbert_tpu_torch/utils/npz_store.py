"""FIFO disk store of npz-serialised dicts — one file per item.

The shared persistence layer behind the two recollection stores
(nav/recollection.py, ce/dagger.py): the role of the reference's LMDB
recollection store (bevbert_ce/vlnce_baselines/
dagger_trainer.py:101-111, common/recollection_dataset.py:22-), except
capacity is enforced as a FIFO ring over shard files instead of one 1 TB
memory-mapped LMDB. Only filenames live in RAM, so capacity is disk-bound.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional

import numpy as np


class NpzShardStore:
    """One ``ep_<id>.npz`` per item under ``directory``; re-opens an existing
    directory resuming from the highest id. ``capacity`` evicts (unlinks) the
    oldest shards FIFO. Only files this store owns are ever deleted — imports
    copy foreign files in under fresh ids."""

    def __init__(self, directory: str, capacity: Optional[int] = None):
        self.directory = directory
        self.capacity = capacity
        os.makedirs(directory, exist_ok=True)
        self._names: List[str] = sorted(
            n for n in os.listdir(directory) if n.endswith(".npz")
        )
        self._next_id = int(self._names[-1][3:-4]) + 1 if self._names else 0

    def __len__(self) -> int:
        return len(self._names)

    def _fresh_name(self) -> str:
        name = f"ep_{self._next_id:08d}.npz"
        self._next_id += 1
        return name

    def append(self, item: Dict[str, np.ndarray]) -> str:
        name = self._fresh_name()
        np.savez_compressed(os.path.join(self.directory, name), **item)
        self._names.append(name)
        self._evict()
        return name

    def import_file(self, src_path: str) -> str:
        """Copy a foreign .npz in under a fresh id (the source file is left
        untouched — eviction only unlinks files inside ``directory``)."""
        name = self._fresh_name()
        dst = os.path.join(self.directory, name)
        if os.path.abspath(src_path) != os.path.abspath(dst):
            shutil.copyfile(src_path, dst)
        self._names.append(name)
        self._evict()
        return name

    def get(self, index: int) -> Dict[str, np.ndarray]:
        path = os.path.join(self.directory, self._names[index])
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    def _evict(self) -> None:
        while self.capacity is not None and len(self._names) > self.capacity:
            old = self._names.pop(0)
            os.unlink(os.path.join(self.directory, old))
