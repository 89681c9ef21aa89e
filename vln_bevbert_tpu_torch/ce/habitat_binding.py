"""Optional real-Habitat binding for continuous environments (port of
``vln_bevbert_tpu/ce/habitat_binding.py``).

Implements the SyntheticContinuousEnv surface (reset/observations/teleport/
stop/geodesic/dist_to_goal/eval_episode) on top of habitat-sim + VLN-CE
episodes, replacing the open-plane synthetic world. Mirrors the reference's
env construction (bevbert_ce/vlnce_baselines/common/
environments.py:44-520, habitat_extensions/habitat_simulator.py:49-110):

- observations assemble the 12-camera ring (RGB through the frozen CLIP
  tower or precomputed, depth 14x14 grids, DDPPO depth features), agent
  position/orientation;
- ``teleport`` uses sim.set_agent_state (the reference's training-time
  action path; its low-level rotate/step 'tryout' controller for eval lives
  in habitat_extensions/nav.py:109-161 and can be layered on top);
- ``geodesic`` forwards to sim.geodesic_distance (the oracle the
  scheduled-sampling teacher queries, ss_trainer_BEV.py:317-345).

Requires habitat-sim/habitat-lab and MP3D scenes; constructing this class
without them raises ImportError.

One repair against the JAX original, whose agents cannot take a step over
it: the env exposes ``depth_feat_shape`` (read by the CE agents to size the
waypoint predictor and to reshape ``depth_features``) and
``view_feat_size``, and ``depth_features`` is the DDPPO tower's unpooled
spatial map ``(V, C, h, w)`` (``depth_encoder.spatial``), the layout the
waypoint predictor flattens into its 2048 inputs (the reference's
``depth_feat_size``). JAX's binding hands over the pooled ``(V, C)``
features, which are the precompute product only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np


class HabitatContinuousEnv:
    def __init__(self, habitat_config, episodes: Sequence, batch_size: int = 1,
                 clip_encoder=None, depth_encoder=None,
                 num_views: int = 12, grid_hw: int = 14, rank: int = 0, world: int = 1):
        """Under data parallelism rank ``rank`` of ``world`` builds b =
        ``batch_size / world`` simulators: ``reset`` cycles the global batch
        and keeps the rank's rows ``[rank * b, (rank + 1) * b)``."""
        import habitat  # external

        if batch_size % world or not 0 <= rank < world:
            raise ValueError(f"rank {rank} of {world} cannot hold a share of batch {batch_size}")
        self._habitat = habitat
        self.rank, self.world = rank, world
        slots = batch_size // world
        self.envs = [
            habitat.Env(config=habitat_config) for _ in range(slots)
        ]
        self.episodes = list(episodes)
        self.batch_size = batch_size
        self.num_views = num_views
        self.grid_hw = grid_hw
        self.clip_encoder = clip_encoder
        self.depth_encoder = depth_encoder
        # without a tower the ring carries the raw frames and the pooled
        # depth grids in their places
        self.depth_feat_shape = (
            tuple(depth_encoder.feat_shape) if depth_encoder is not None
            else (grid_hw, grid_hw)
        )
        self.view_feat_size = clip_encoder.feat_size if clip_encoder is not None else None
        self.ix = 0
        self.batch = []
        # habitat defaults the HIGHTOLOW controller drives
        # (habitat_extensions/nav.py: TURN 30deg units, 0.25m forward)
        self.turn_unit = math.radians(30.0)
        self.forward_unit = 0.25
        self.active = np.ones(slots, bool)
        self._collided = np.zeros(slots, bool)

    # The methods below intentionally mirror SyntheticContinuousEnv's
    # surface (conformance pinned in tests/test_binding_conformance.py);
    # ce.agent.CEAgent is agnostic to which backs it.

    def size(self) -> int:
        return len(self.episodes)

    def reset_epoch(self):
        self.ix = 0

    def reset(self) -> List[dict]:
        batch = self.episodes[self.ix : self.ix + self.batch_size]
        if self.world > 1 and len(batch) < self.batch_size:
            # one process runs a short last batch; ranks would hold uneven rows
            raise ValueError(f"a short batch of {len(batch)} of {self.batch_size} episodes at "
                             f"{self.ix}: under data parallelism the split's "
                             f"{len(self.episodes)} episodes must fill every global batch")
        self.ix = (self.ix + self.batch_size) % max(len(self.episodes), 1)
        b = self.batch_size // self.world
        self.batch = batch[self.rank * b:(self.rank + 1) * b]
        for i, (env, ep) in enumerate(zip(self.envs, self.batch)):
            env.current_episode = ep
            env.reset()
            self.active[i] = True
            self._collided[i] = False
        return self.observations()

    # --------------------------------------------------------- pose access
    @property
    def positions(self) -> np.ndarray:
        return np.stack([
            np.asarray(e.sim.get_agent_state().position) for e in self.envs
        ])

    @property
    def headings(self) -> np.ndarray:
        return np.asarray([
            self._heading(e.sim.get_agent_state()) for e in self.envs
        ])

    def get_positions(self) -> np.ndarray:
        return self.positions

    def get_headings(self) -> np.ndarray:
        return self.headings

    def get_batch(self):
        return list(self.batch)

    def observations(self) -> List[dict]:
        out = []
        for env, ep in zip(self.envs, self.batch):
            sim = env.sim
            state = sim.get_agent_state()
            rgb_ring, depth_ring, depth_feats = self._camera_ring(sim, state)
            out.append(
                {
                    "episode_id": ep.episode_id,
                    "instr_id": ep.episode_id,
                    "instr_encoding": np.asarray(
                        ep.instruction.instruction_tokens
                    ),
                    "position": np.asarray(state.position),
                    "orientation": np.asarray(
                        [state.rotation.x, state.rotation.y,
                         state.rotation.z, state.rotation.w]
                    ),
                    "heading": self._heading(state),
                    "view_fts": rgb_ring["pooled"],
                    "rgb": rgb_ring["grid"],
                    "depth": depth_ring,
                    "depth_features": depth_feats,
                    "gt_path": np.asarray(
                        [p for p in ep.reference_path]
                    ),
                    "goal": np.asarray(ep.goals[0].position),
                }
            )
        return out

    def _heading(self, state) -> float:
        from .geometry_ce import heading_from_quaternion

        q = state.rotation
        return heading_from_quaternion(np.array([q.x, q.y, q.z, q.w]))

    def _camera_ring(self, sim, state):
        """Render the 12-view ring with step_without_obs-style cheap rotation
        (ref habitat_simulator.py:49-110) and encode."""
        rgbs, raw_depths, depths = [], [], []
        base = self._heading(state)
        for k in range(self.num_views):
            heading = base + k * (2 * math.pi / self.num_views)
            obs = self._render_at(sim, state.position, heading)
            rgbs.append(obs["rgb"])
            raw_depths.append(obs["depth"])
            depths.append(self._pool_depth(obs["depth"]))
        # restore the pre-render pose: the ring render rotates the agent
        # through the 12 view headings, and leaving the last one applied
        # would corrupt every subsequent rotate/forward_step (the reference
        # renders through a fixed 12-camera sensor rig instead,
        # ss_trainer_BEV.py:107-179, so its agent never moves)
        sim.set_agent_state(
            np.asarray(state.position), state.rotation, reset_sensors=False
        )
        rgbs = np.stack(rgbs)
        depths = np.stack(depths)
        if self.clip_encoder is not None:
            ring = {
                "pooled": self.clip_encoder.encode_views(rgbs),
                "grid": self.clip_encoder.encode_grids(rgbs),
            }
        else:
            ring = {"pooled": rgbs, "grid": rgbs}
        # the DDPPO tower encodes the RAW depth frames (the reference feeds
        # the 256x256 depth sensor, resnet_encoders.py:13-108); the pooled
        # 14x14 grids are the BEV-lift product, not the tower input. The
        # waypoint predictor takes the unpooled (V, C, h, w) map.
        feats = (
            self.depth_encoder.spatial(np.stack(raw_depths))
            if self.depth_encoder is not None else depths
        )
        return ring, depths, feats

    def _render_at(self, sim, position, heading):
        from .geometry_ce import quaternion_from_heading

        q = quaternion_from_heading(heading)
        sim.set_agent_state(position, q, reset_sensors=False)
        return sim.get_sensor_observations()

    def _pool_depth(self, depth_img: np.ndarray) -> np.ndarray:
        """Masked-nonzero 14x14 pooling of the raw depth frame (ref
        precompute_features/grid_depth.py:58-110)."""
        h, w = depth_img.shape[:2]
        gh = self.grid_hw
        ph, pw = h // gh, w // gh
        d = depth_img[: ph * gh, : pw * gh].reshape(gh, ph, gh, pw)
        valid = d > 0
        s = (d * valid).sum((1, 3))
        n = valid.sum((1, 3))
        return np.where(n > 0, s / np.maximum(n, 1), 0.0).astype(np.float32)

    def teleport(self, slot: int, position, heading: Optional[float] = None):
        from .geometry_ce import quaternion_from_heading

        sim = self.envs[slot].sim
        q = quaternion_from_heading(heading or 0.0)
        sim.set_agent_state(np.asarray(position), q)

    def stop(self, slot: int):
        self.active[slot] = False  # episode termination is trainer-driven

    # ---------------------------------------------- low-level control
    # (the primitives ce/control.py's HIGHTOLOW controller drives; the
    # reference's nav.py:38-56 steps TURN_LEFT/TURN_RIGHT/MOVE_FORWARD via
    # step_without_obs and reads previous_step_collided)
    def rotate(self, slot: int, angle: float):
        from .geometry_ce import quaternion_from_heading

        sim = self.envs[slot].sim
        state = sim.get_agent_state()
        h = (self._heading(state) + angle) % (2 * math.pi)
        sim.set_agent_state(
            np.asarray(state.position), quaternion_from_heading(h),
            reset_sensors=False,
        )

    def forward_step(self, slot: int) -> bool:
        sim = self.envs[slot].sim
        state = sim.get_agent_state()
        h = self._heading(state)
        start = np.asarray(state.position, np.float64)
        target = start + self.forward_unit * np.array(
            [-math.sin(h), 0.0, -math.cos(h)]
        )
        # navmesh-filtered motion: collision iff the filtered end point falls
        # short of the target (habitat-sim's standard collided check)
        end = np.asarray(sim.step_filter(start, target))
        collided = bool(np.linalg.norm(end - target) > 1e-3)
        sim.set_agent_state(end, state.rotation, reset_sensors=False)
        self._collided[slot] = collided
        return collided

    def previous_step_collided(self, slot: int) -> bool:
        return bool(self._collided[slot])

    # ----------------------------------------------------------- oracle
    def geodesic(self, slot: int, a, b) -> float:
        return float(self.envs[slot].sim.geodesic_distance(list(a), list(b)))

    def dist_to_goal(self, slot: int, position=None) -> float:
        env = self.envs[slot]
        pos = (
            env.sim.get_agent_state().position if position is None else position
        )
        return self.geodesic(slot, pos, self.batch[slot].goals[0].position)

    def dists_to_goal(self, slot: int, positions) -> np.ndarray:
        """Batched oracle: geodesic-to-goal for MANY query positions in one
        call — under a subprocess env pool each oracle call is a pipe
        round-trip, and in habitat each a geodesic solve, so the teachers
        query all of a step's candidates at once (ref _teacher_action_new
        queries per candidate, ss_trainer_BEV.py:317-345; batched here)."""
        return np.asarray(
            [self.dist_to_goal(slot, p) for p in positions], np.float64
        )

    # ------------------------------------------------------------- eval
    def eval_episode(self, slot: int, walked: np.ndarray):
        from .env import compute_ce_episode_metrics

        gt = np.asarray([p for p in self.batch[slot].reference_path])
        return compute_ce_episode_metrics(
            walked, gt, lambda p: self.dist_to_goal(slot, p)
        )


def make_habitat_env(habitat_config_path: str, batch_size: int, *,
                     data_path: Optional[str] = None, split: str = "train",
                     clip_encoder=None, depth_encoder=None,
                     num_views: int = 12, grid_hw: int = 14, rank: int = 0, world: int = 1
                     ) -> "HabitatContinuousEnv":
    """Construct the real CE env from a habitat config YAML, the entry the
    CLI's ``--habitat_config`` flag drives (role of the reference's
    run.py get_config + env construction, bevbert_ce/
    vlnce_baselines/common/env_utils.py:35-126).

    ``data_path``/``split`` override TASK_CONFIG.DATASET (the reference's
    ``DATA_PATH`` with a {split} template); episodes come from habitat's own
    dataset registry so they carry scene ids and habitat goal/instruction
    objects, which this binding's observation assembly expects. ``rank``
    and ``world`` give a data-parallel rank its rows of the global batch.
    """
    import habitat  # external

    config = habitat.get_config(habitat_config_path)
    ds_cfg = getattr(config, "DATASET", None) or config.TASK_CONFIG.DATASET
    if data_path is not None:
        config.defrost()
        ds_cfg.DATA_PATH = data_path
        ds_cfg.SPLIT = split
        config.freeze()
    dataset = habitat.make_dataset(ds_cfg.TYPE, config=ds_cfg)
    return HabitatContinuousEnv(
        config, dataset.episodes, batch_size=batch_size,
        clip_encoder=clip_encoder, depth_encoder=depth_encoder,
        num_views=num_views, grid_hw=grid_hw, rank=rank, world=world,
    )
