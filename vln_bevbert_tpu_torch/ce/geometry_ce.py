"""Habitat-convention geometry (continuous environments).

Habitat's frame is y-up with the camera looking down -z; headings come from
orientation quaternions. Parity with
bevbert_ce/vlnce_baselines/models/graph_utils.py:14-77
(which binds habitat's quaternion utils); the quaternion math is implemented
directly in numpy here.
"""

from __future__ import annotations

import math

import numpy as np


def quaternion_from_heading(heading: float) -> np.ndarray:
    """Habitat coefficient order (x, y, z, w): rotation of `heading` radians
    about +y. heading 0 faces -z; positive turns left (counter-clockwise
    looking down)."""
    return np.array(
        [0.0, math.sin(heading / 2.0), 0.0, math.cos(heading / 2.0)],
        dtype=np.float64,
    )


def _quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vector v by quaternion q = (x, y, z, w)."""
    x, y, z, w = q
    u = np.array([x, y, z])
    return (
        2.0 * np.dot(u, v) * u
        + (w * w - np.dot(u, u)) * v
        + 2.0 * w * np.cross(u, v)
    )


def heading_from_quaternion(quat: np.ndarray) -> float:
    """Heading in [0, 2pi) from an (x, y, z, w) orientation quaternion
    (ref graph_utils.py:59-64: rotate -z by the inverse quaternion, take the
    polar angle of (-z', x'))."""
    q = np.asarray(quat, np.float64)
    q_inv = np.array([-q[0], -q[1], -q[2], q[3]])
    v = _quat_rotate(q_inv, np.array([0.0, 0.0, -1.0]))
    phi = math.atan2(v[0], -v[2])
    return phi % (2.0 * math.pi)


def estimate_cand_pos(pos, ori, ang, dis) -> np.ndarray:
    """Predicted-waypoint world positions from clockwise angles + distances
    (ref graph_utils.py:67-77). ang: relative clockwise angle from the agent
    heading; dis: metres."""
    pos = np.asarray(pos, np.float64)
    ang = np.asarray(ang, np.float64)
    dis = np.asarray(dis, np.float64)
    heading = heading_from_quaternion(ori) if np.ndim(ori) else float(ori)
    a = (heading + ang) % (2.0 * math.pi)
    out = np.zeros((len(a), 3))
    out[:, 0] = pos[0] - dis * np.sin(a)
    out[:, 1] = pos[1]
    out[:, 2] = pos[2] - dis * np.cos(a)
    return out


def rel_pos_features_ce(a, b, base_heading: float = 0.0,
                        base_elevation: float = 0.0, to_clock: bool = False,
                        return_xz_dist: bool = False):
    """Relative (heading, elevation, dist) in the habitat frame
    (ref calculate_vp_rel_pos_fts, graph_utils.py:22-48): heading from
    arcsin(-dx/xz) reflected when dz > 0, optionally converted to clockwise.
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = b - a
    xz = max(math.hypot(d[0], d[2]), 1e-8)
    xyz = max(float(np.linalg.norm(d)), 1e-8)
    heading = math.asin(max(-1.0, min(1.0, -d[0] / xz)))
    if d[2] > 0:
        heading = math.pi - heading
    heading -= base_heading
    if to_clock:
        heading = 2.0 * math.pi - heading
    # NB: the reference derives 'elevation' from the z (horizontal) component
    # (graph_utils.py:42, a convention carried over from the MP3D frame where
    # index 2 is up). Kept for checkpoint-parity: the features feed a learned
    # linear layer, so any consistent convention trains equivalently.
    elevation = math.asin(max(-1.0, min(1.0, d[2] / xyz))) - base_elevation
    return heading, elevation, (xz if return_xz_dist else xyz)
