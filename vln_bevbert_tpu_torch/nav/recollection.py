"""Teacher-recollection training (off-policy imitation), port of
``vln_bevbert_tpu/nav/recollection.py``.

Role of the reference's "dagger" trainer + TeacherRecollectionDataset
(bevbert_ce/vlnce_baselines/dagger_trainer.py:98-188,
common/recollection_dataset.py:22-): collect trajectories once, persist the
per-step training inputs (the reference uses an LMDB with a 1 TB map), then
run supervised epochs from the store without touching the simulator.

An episode's training inputs are exactly one replay bundle (what the agent's
``_learn`` stacks from its ``StepRecord``s), so the store is a collection of
ready-to-train bundles and each training step is one ``learn_from_bundle``
update. With ``spill_dir`` set, bundles live on disk as one ``.npz`` each
(``utils/npz_store.py``) and are streamed back at training time; RAM holds
only filenames.

A bundle keeps the JAX bundle's keys and numpy dtypes. The one device tensor
of a record, its splatted ``bev_fts``, is stacked on the device and copied to
the host as a float32 array (the splat's output dtype), in RAM as on disk.

Under data parallelism each rank's store holds its own rows of every bundle,
spilled under ``<spill_dir>/rank<r>``; the ranks shuffle alike (their
``np_rng`` stays in step) and every update goes through
``learn_from_bundle``'s gradient all-reduce.
"""

from __future__ import annotations

import inspect
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..parallel import distributed
from ..utils.npz_store import NpzShardStore

Bundle = Dict[str, np.ndarray]


class TeacherRecollectionStore:
    def __init__(self, agent, capacity: int = 1024, spill_dir: Optional[str] = None):
        self.agent = agent
        self.capacity = capacity
        if spill_dir and distributed.world_size() > 1:
            spill_dir = os.path.join(spill_dir, f"rank{distributed.rank()}")
        self.spill_dir = spill_dir
        # in-RAM bundle list, or the shared FIFO shard store when spilled
        self.bundles: List[Bundle] = []
        self._disk: Optional[NpzShardStore] = (
            NpzShardStore(spill_dir, capacity) if spill_dir else None
        )

    def __len__(self) -> int:
        return len(self._disk) if self._disk is not None else len(self.bundles)

    # ------------------------------------------------------------- collection
    def collect(self, n_rollouts: int, beta: Optional[float] = None) -> int:
        """Rollouts contributing one replay bundle each. ``beta=None`` is
        pure teacher forcing; otherwise the executed action mixes teacher
        w.p. beta with the policy sample (the dagger collection mix,
        dagger_trainer.py:304-307), passed as ``sample_ratio`` to a rollout
        that takes it. The discrete rollout has no per-step mix (the
        reference's discrete DAgger interleaves whole teacher and sample
        rollouts instead), so it collects pure ``sample`` rollouts."""
        agent = self.agent
        orig_learn = agent._learn
        captured: List[Bundle] = []

        def capture(lang, records):
            captured.append(agent_build_bundle(agent, lang, records))
            return None

        if beta is None:
            kwargs = {"feedback": "teacher"}
        else:
            kwargs = {"feedback": "sample"}
            if "sample_ratio" in inspect.signature(agent.rollout).parameters:
                kwargs["sample_ratio"] = beta
        agent._learn = capture
        try:
            for _ in range(n_rollouts):
                agent.rollout(train=True, **kwargs)
        finally:
            agent._learn = orig_learn
        for b in captured:
            self._append(b)
        return len(captured)

    def _append(self, bundle: Bundle) -> None:
        if self._disk is not None:
            self._disk.append(bundle)
        else:
            self.bundles.append(bundle)
            self._evict()

    def _evict(self) -> None:
        while len(self.bundles) > self.capacity:
            self.bundles.pop(0)

    def _get(self, i: int) -> Bundle:
        return self._disk.get(i) if self._disk is not None else self.bundles[i]

    # --------------------------------------------------------------- training
    def train_epochs(self, epochs: int, rng: Optional[np.random.Generator] = None):
        """Supervised updates streamed from the store (ref dagger_trainer's
        epoch loop over the LMDB dataset)."""
        rng = rng or np.random.default_rng(0)
        losses = []
        for _ in range(epochs):
            order = rng.permutation(len(self))
            for i in order:
                losses.append(self.agent.learn_from_bundle(self._get(i)))
        return losses

    # ------------------------------------------------------------ persistence
    def save(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        for i in range(len(self)):
            np.savez_compressed(os.path.join(directory, f"ep_{i:06d}.npz"),
                                **self._get(i))

    def load(self, directory: str):
        """Import an archive written by ``save``. With ``spill_dir`` set the
        files are COPIED into the spill dir under fresh ids (never registered
        in place: eviction unlinks store entries, and the archive must stay
        intact — it is the user's saved dataset)."""
        for name in sorted(os.listdir(directory)):
            if not name.endswith(".npz"):
                continue
            src = os.path.join(directory, name)
            if self._disk is not None:
                self._disk.import_file(src)
            else:
                with np.load(src) as z:
                    self.bundles.append({k: z[k] for k in z.files})
        self._evict()
        return len(self)


def agent_build_bundle(agent, lang, records) -> Bundle:
    """Materialise the replay bundle an agent would train from (``_learn``'s
    packing, without the update), padded to ``max_action_len`` steps with
    zeros and IGNORE_ID targets. ``bev_fts`` (T, B, cells, D) float32 is
    stacked on the device, then copied to the host."""
    T = agent.cfg.max_action_len
    pad = T - len(records)

    def stack(attr, fill=0):
        arrs = [np.asarray(getattr(r, attr)) for r in records]
        if pad:
            pad_arr = np.full_like(arrs[0], fill) if fill else np.zeros_like(arrs[0])
            arrs = arrs + [pad_arr] * pad
        return np.stack(arrs)

    keys = ["view_fts", "loc_fts", "nav_types", "view_lens", "gmap_agg", "gmap_step_ids",
            "gmap_pos_fts", "gmap_masks", "gmap_pair_dists", "gmap_visited_masks"]
    use_bev = agent.cfg.model.use_bev
    if use_bev:
        keys += ["bev_nav_masks", "bev_cand_idxs", "local_masks", "fuse_map", "bev_pos_fts"]
    bundle: Bundle = {k: stack(k) for k in keys}
    if use_bev:
        bev = [r.bev_fts for r in records]
        bev = torch.stack(bev + [torch.zeros_like(bev[0])] * pad)
        bundle["bev_fts"] = bev.float().cpu().numpy()
    bundle["targets"] = stack("targets", fill=-100)
    bundle["step_idx"] = np.arange(T, dtype=np.int32)
    bundle["txt_ids"] = np.asarray(lang["txt_ids"])
    bundle["txt_masks"] = np.asarray(lang["txt_masks"])
    if agent.with_objects and records[0].obj_fts is not None:
        bundle["obj_fts"] = stack("obj_fts")
        bundle["obj_lens"] = stack("obj_lens")
        bundle["obj_targets"] = stack("obj_targets", fill=-100)
    return bundle
