"""Compile-time constants of a straight parallel-lane network.

On a network whose lanes are all straight, parallel, co-linear in arc length
and successor-free (highway-v0/-fast: one edge of N parallel lanes) the lane
projection collapses to

    s_j       = (p_j - origin) . u          (lane-independent)
    lat_j(l)  = (p_j - origin) . n - off_l
    closest l = argmin_l |lat_j - off_l|

so a frame needs no lane tables; ``ops/straight_frames.py`` runs on these
constants.  Counterpart of ``highwayenv_tpu/ops/straight_fast.py:43-100``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class StraightGeo(NamedTuple):
    """Compile-time constants of a straight parallel-lane network."""

    origin: np.ndarray  # (2,) lane 0 start
    u: np.ndarray  # (2,) unit direction
    n: np.ndarray  # (2,) unit left-normal
    theta: float  # lane heading
    offsets: np.ndarray  # (L,) lateral offset of each lane
    width: float
    length: float
    speed_limit: float  # or inf


def try_compile(net) -> "StraightGeo | None":
    """Return StraightGeo if the network qualifies, else None."""
    from highwayenv_tpu_torch.road.network import StraightLane

    lanes = [lane for ls in net.edges.values() for lane in ls]
    if not lanes:
        return None
    first = lanes[0]
    u = first.direction
    sl0 = np.inf if first.speed_limit is None else first.speed_limit
    for lane in lanes:
        # a poly lane's network goes to the general gate, which refuses it
        if type(lane) is not StraightLane:
            return None
        if not np.allclose(lane.direction, u, atol=1e-9):
            return None
        if abs(lane.length - first.length) > 1e-6:
            return None
        if abs(lane.width - first.width) > 1e-9:
            return None
        sl = np.inf if lane.speed_limit is None else lane.speed_limit
        if sl != sl0 or lane.forbidden:
            return None
        # arc-length co-linearity: same start projection on u
        if abs(np.dot(lane.start - first.start, u)) > 1e-6:
            return None
    if len(net.edges) != 1:  # successor-free
        return None
    n = first.direction_lateral
    offsets = np.array([np.dot(lane.start - first.start, n) for lane in lanes])
    return StraightGeo(
        origin=np.asarray(first.start, np.float32),
        u=np.asarray(u, np.float32),
        n=np.asarray(n, np.float32),
        theta=float(first.heading),
        offsets=np.asarray(offsets, np.float32),
        width=float(first.width),
        length=float(first.length),
        speed_limit=float(sl0),
    )
