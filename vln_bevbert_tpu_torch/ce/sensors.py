"""CE sensor suite: the reference's habitat Sensor registry as plain
functions over the env surface.

The reference registers GlobalGPS / Heading(Orien) / ShortestPathSensor /
ProgressSensor / RxRInstructionSensor as habitat Sensors
(bevbert_ce/habitat_extensions/sensors.py:18-197); in this
framework observations are plain dicts, so the sensors are pure functions
an env (or trainer) calls to enrich an observation. ``attach_sensors``
mirrors the reference's per-step sensor pass.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

from .geometry_ce import heading_from_quaternion


def global_gps(position: np.ndarray, dimensionality: int = 3) -> np.ndarray:
    """GlobalGPSSensor (sensors.py:18-43): agent position in world frame."""
    pos = np.asarray(position, np.float32)
    return pos if dimensionality == 3 else pos[[0, 2]]


def heading_sensor(orientation: np.ndarray) -> float:
    """OrienSensor: scalar heading from the agent quaternion."""
    return float(heading_from_quaternion(np.asarray(orientation)))


def shortest_path_sensor(env, slot: int, step_size: float = 0.25) -> np.ndarray:
    """ShortestPathSensor (sensors.py:70-101): the next oracle waypoint —
    here the first gt-path point not yet within a step of the agent."""
    obs_pos = env.positions[slot]
    gt = np.asarray(env.batch[slot].gt_positions
                    if hasattr(env.batch[slot], "gt_positions")
                    else env.batch[slot].reference_path, np.float64)
    for p in gt:
        if np.linalg.norm(p - obs_pos) > step_size:
            return np.asarray(p, np.float32)
    return np.asarray(gt[-1], np.float32)


def progress_sensor(env, slot: int) -> float:
    """ProgressSensor (sensors.py:103-130): fraction of the start->goal
    geodesic already covered."""
    ep = env.batch[slot]
    start = np.asarray(
        ep.start_pos if hasattr(ep, "start_pos") else ep.start_position
    )
    total = env.geodesic(slot, start, np.asarray(ep.goal if hasattr(ep, "goal")
                                                 else ep.goals[0].position))
    left = env.dist_to_goal(slot)
    if total <= 0:
        return 1.0
    return float(np.clip(1.0 - left / total, 0.0, 1.0))


def rxr_instruction(ep) -> np.ndarray:
    """RxRInstructionSensor (sensors.py:166-197): precomputed text features
    when present, else the token encoding."""
    for attr in ("instruction_features", "instr_features"):
        if hasattr(ep, attr):
            return np.asarray(getattr(ep, attr), np.float32)
    enc = ep.instr_encoding if hasattr(ep, "instr_encoding") else \
        ep.instruction.instruction_tokens
    return np.asarray(enc)


def attach_sensors(env, obs: List[Dict]) -> List[Dict]:
    """Enrich a batch of observation dicts with the sensor suite."""
    for i, ob in enumerate(obs):
        ob["globalgps"] = global_gps(ob["position"])
        ob["heading_sensor"] = heading_sensor(ob["orientation"])
        ob["shortest_path_sensor"] = shortest_path_sensor(env, i)
        ob["progress"] = progress_sensor(env, i)
    return obs


# ------------------------------------------------------------ top-down map


def render_top_down_map(walked: Sequence, gt: Sequence, goal,
                        resolution: int = 256, margin: float = 1.0,
                        success_distance: float = 3.0) -> np.ndarray:
    """TopDownMapVLNCE's trainer-side equivalent
    (habitat_extensions/measures.py TopDownMapVLNCE + maps.py): rasterise the
    reference path (green), the walked trajectory (blue), the agent start
    (white) and the goal disc (red ring) into an RGB image. Pure numpy — no
    sim renderer needed."""
    walked = np.asarray(walked, np.float64)
    gt = np.asarray(gt, np.float64)
    goal = np.asarray(goal, np.float64)
    pts = np.concatenate([walked, gt, goal[None]], axis=0)
    lo = pts[:, [0, 2]].min(axis=0) - margin
    hi = pts[:, [0, 2]].max(axis=0) + margin
    span = np.maximum(hi - lo, 1e-3)

    img = np.full((resolution, resolution, 3), 255, np.uint8)

    def to_px(p):
        xy = (np.asarray([p[0], p[2]]) - lo) / span
        return np.clip((xy * (resolution - 1)).astype(int), 0, resolution - 1)

    def draw_line(img, a, b, color, thickness=1):
        a, b = to_px(a), to_px(b)
        n = int(np.abs(b - a).max()) + 1
        for s in np.linspace(0.0, 1.0, n * 2 + 1):
            x, y = np.round(a + (b - a) * s).astype(int)
            img[max(y - thickness + 1, 0): y + thickness,
                max(x - thickness + 1, 0): x + thickness] = color

    # goal success disc
    r_px = int(success_distance / span.max() * (resolution - 1))
    gx, gy = to_px(goal)
    yy, xx = np.ogrid[:resolution, :resolution]
    ring = np.abs(np.hypot(xx - gx, yy - gy) - r_px) <= 1
    img[ring] = (220, 80, 80)

    for a, b in zip(gt[:-1], gt[1:]):
        draw_line(img, a, b, (60, 180, 75), thickness=2)
    for a, b in zip(walked[:-1], walked[1:]):
        draw_line(img, a, b, (0, 90, 200), thickness=2)
    sx, sy = to_px(walked[0])
    img[max(sy - 3, 0): sy + 3, max(sx - 3, 0): sx + 3] = (0, 0, 0)
    return img
