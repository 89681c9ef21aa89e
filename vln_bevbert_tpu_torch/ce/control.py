"""Low-level action execution for continuous environments.

Re-implements the reference's HIGHTOLOW turn-discretized control with
``tryout`` collision recovery (bevbert_ce/habitat_extensions/
nav.py:109-161; vlnce_baselines/common/environments.py:363-466
``single_step_control``/``multi_step_control``/``step``) against the narrow
``ContinuousEnvBatch`` low-level surface (rotate / forward_step / teleport),
so it runs identically on the synthetic env (with injected circular
obstacles) and on a real habitat binding.

Semantics, matching the reference exactly:
- turns are discretized to the simulator's turn unit (30 deg) and applied as
  unit steps; angles wrap to (-180, 180];
- forward motion is ``distance // forward_unit`` MOVE_FORWARD unit steps; a
  collision leaves the agent in place;
- with ``tryout``, a collision triggers a sweep over +-90/60/30 degree probe
  directions (starting left or right at random); the first direction whose
  probe step moves the agent is taken, the heading is restored toward the
  target by the tail turns, and the remaining steps are walked until the next
  collision (environments.py:385-423 turn_seq tables).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

TWO_PI = 2.0 * math.pi

# (head_turn_deg, tail_turn_deg) probe tables — environments.py:390-407.
# After the initial +90deg turn, probes sweep left-to-right; after -90 (270),
# right-to-left. Turns are counterclockwise-positive degrees.
_TURN_SEQS_LEFT = [(0, 270), (330, 300), (330, 330), (300, 30), (330, 60), (330, 90)]
_TURN_SEQS_RIGHT = [(0, 90), (30, 60), (30, 30), (60, 330), (30, 300), (30, 270)]


def rel_angle_dist(pos, target, heading: float) -> Tuple[float, float]:
    """Signed turn angle (toward target) and planar distance.

    Heading convention: forward = (-sin h, _, -cos h) (habitat's -z forward;
    ref calculate_vp_rel_pos, environments.py:368-369).
    """
    dx = float(target[0] - pos[0])
    dz = float(target[2] - pos[2])
    target_heading = math.atan2(-dx, -dz) % TWO_PI
    ang = (target_heading - heading) % TWO_PI
    if ang > math.pi:
        ang -= TWO_PI
    return ang, math.hypot(dx, dz)


class LowLevelController:
    """Drives one env slot with unit-discretized turn/forward actions.

    Every position change is appended to ``self.visited`` so callers can
    extend the episode's walked path (the reference's Position measure
    records per-sim-step positions, habitat_extensions/measures.py:43-58).
    """

    def __init__(self, env, rng: Optional[np.random.Generator] = None):
        self.env = env
        self.rng = rng or np.random.default_rng(0)
        self.visited: List[np.ndarray] = []

    # ------------------------------------------------------------ primitives
    def _state(self, slot: int) -> Tuple[np.ndarray, float]:
        return self.env.positions[slot].copy(), float(self.env.headings[slot])

    def turn(self, slot: int, angle: float):
        """Turn by ``angle`` rad, discretized to the env's turn unit
        (ref environments.py:340-358 ``turn``)."""
        unit = self.env.turn_unit
        n = round(angle / unit)
        # wrap to (-6, 6] unit steps, i.e. (-180, 180]
        half = round(math.pi / unit)
        n = ((n + half - 1) % (2 * half)) - half + 1
        step = unit if n >= 0 else -unit
        for _ in range(abs(int(n))):
            self.env.rotate(slot, step)

    def _forward(self, slot: int, ksteps: int, stop_on_collision: bool) -> int:
        """Walk up to ksteps; returns number of successful unit steps."""
        done = 0
        for _ in range(ksteps):
            collided = self.env.forward_step(slot)
            if not collided:
                self.visited.append(self.env.positions[slot].copy())
                done += 1
            if collided and stop_on_collision:
                break
        return done

    # --------------------------------------------------------------- control
    def single_step_control(self, slot: int, target_pos, tryout: bool):
        """(ref environments.py:363-423)."""
        pos, heading = self._state(slot)
        ang, dis = rel_angle_dist(pos, target_pos, heading)
        self.turn(slot, ang)
        ksteps = int(dis // self.env.forward_unit)
        if not tryout:
            self._forward(slot, ksteps, stop_on_collision=False)
            return
        cnt = self._forward(slot, ksteps, stop_on_collision=True)
        remaining = ksteps - cnt
        if remaining <= 0:
            return
        # collision recovery: probe +-90/60/30 around the blocked direction
        go_left = bool(self.rng.choice([True, False]))
        self.turn(slot, math.radians(90.0 if go_left else 270.0))
        turn_seqs = _TURN_SEQS_LEFT if go_left else _TURN_SEQS_RIGHT
        for head_deg, tail_deg in turn_seqs:
            self.turn(slot, math.radians(head_deg))
            prev = self.env.positions[slot].copy()
            self.env.forward_step(slot)
            post = self.env.positions[slot]
            if not np.array_equal(prev, post):
                self.visited.append(post.copy())
                self.turn(slot, math.radians(tail_deg))
                self._forward(slot, remaining, stop_on_collision=True)
                break

    def multi_step_control(self, slot: int, path: Sequence, tryout: bool):
        """Follow a [(vp, position), ...] back-path node by node
        (ref environments.py:425-427)."""
        for _, vp_pos in path:
            self.single_step_control(slot, vp_pos, tryout)

    # ---------------------------------------------------------------- action
    def execute(self, slot: int, action: Dict) -> List[np.ndarray]:
        """Run one high-level action dict; returns positions visited.

        ``action``: {"act": 0|4, "back_path": [(vp,pos)...] | None,
        "front_pos"/"ghost_pos" (act 4) or "stop_pos" (act 0),
        "tryout": bool} — the reference's structured step
        (environments.py:437-479).
        """
        self.visited = []
        tryout = bool(action.get("tryout", True))
        if action["act"] == 4:
            if action.get("back_path") is None:
                self.env.teleport(slot, action["front_pos"])
                self.visited.append(np.asarray(action["front_pos"], np.float64))
            else:
                self.multi_step_control(slot, action["back_path"], tryout)
            self.single_step_control(slot, action["ghost_pos"], tryout)
        elif action["act"] == 0:
            if action.get("back_path") is None:
                if action.get("stop_pos") is not None:
                    self.env.teleport(slot, action["stop_pos"])
                    self.visited.append(np.asarray(action["stop_pos"], np.float64))
            else:
                self.multi_step_control(slot, action["back_path"], tryout)
            self.env.stop(slot)
        else:
            raise ValueError(f"unknown act {action['act']}")
        return self.visited
