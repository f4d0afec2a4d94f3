"""RegulatedRoad: the intersection right-of-way pass over a batch of envs.

PyTorch counterpart of ``highwayenv_tpu/road/regulation.py`` (reference
highway_env/road/regulation.py).  On a tick frame (every
``sim_freq // REGULATION_FREQUENCY`` frames) each env (1) releases its
yielding vehicles whose timer expired to their lane's speed limit, (2)
predicts every vehicle's constant-speed positions along its route at
``TIMES``, (3) tests every pair of vehicles for a future overlap of 1.5x
length, 0.9x width probe rectangles, and (4) makes the lower-priority (on a
tie the trailing) vehicle of each conflicting pair yield with target speed 0.

This is the plain version of the regulated block of the general frame kernel
K5 (``csrc/general_frames.cu``, ``kRegulated``): batched over (B, V) with
the (B, V, V, T) pair tests written out, the lane lookups as gathers.
"""

from __future__ import annotations

import numpy as np
import torch

from highwayenv_tpu_torch.road import lane as lane_ops
from highwayenv_tpu_torch.road.lane import LaneGeometry
from highwayenv_tpu_torch.vehicle.state import KIND_IDM, KIND_LINEAR, VehicleState

REGULATION_FREQUENCY = 2
YIELD_DURATION = 0.0
CONFLICT_HORIZON = 3.0
CONFLICT_STEP = 0.25
#: the prediction times, 0.25 to 2.75 s (T = 11)
TIMES = np.arange(CONFLICT_STEP, CONFLICT_HORIZON, CONFLICT_STEP).astype(np.float32)

#: probe points of a rectangle (``rect_corners`` with midpoints and centre)
#: as (length, width) fractions
PROBES = (
    (-0.5, -0.5), (-0.5, 0.5), (0.5, 0.5), (0.5, -0.5), (0.0, 0.0),
    (-0.5, 0.0), (0.5, 0.0), (0.0, -0.5), (0.0, 0.5),
)


def predict_route_positions(geo: LaneGeometry, state: VehicleState, times=TIMES):
    """Constant-speed positions and headings along each vehicle's route
    (reference ``predict_trajectory_constant_speed`` and
    ``position_heading_along_route``): (B, V, T, 2) and (B, V, T).

    The route walk covers the remaining segments ``[route_ptr, route_len)``;
    a vehicle with none keeps its current lane.  A segment without an
    explicit lane id keeps the current lane id when the segment's edge has
    that many lanes, else lane 0.  The last valid segment absorbs what is
    left of the distance."""
    R = state.route_base.shape[-1]
    dev = state.speed.device
    seg = torch.arange(R, device=dev)
    t = torch.as_tensor(times, dtype=torch.float32, device=dev)

    s0, _ = lane_ops.local_coordinates(geo, state.lane, state.pos)
    target = s0[..., None] + state.speed[..., None] * t  # (B, V, T)

    ptr = state.route_ptr[..., None]
    has_route = (state.route_ptr < state.route_len)[..., None]
    valid = has_route & (seg >= ptr) & (seg < state.route_len[..., None])  # (B, V, R)
    cur_id = geo.lane_id[lane_ops._gather(geo, state.lane)][..., None]
    fallback = torch.where(cur_id < state.route_n, cur_id, 0)
    seg_id = torch.where(state.route_id >= 0, state.route_id, fallback)
    seg_lane = (state.route_base + seg_id).clamp(0, geo.num_lanes - 1)
    seg_lane = torch.where(valid, seg_lane, state.lane[..., None])

    # cumulative segment lengths, summed in segment order as the kernel does
    seg_len = torch.where(valid, geo.length[lane_ops._gather(geo, seg_lane)], 0.0)
    sums, acc = [], torch.zeros_like(seg_len[..., 0])
    for r in range(R):
        acc = acc + seg_len[..., r]
        sums.append(acc)
    cum = torch.stack(sums, dim=-1)  # (B, V, R)

    n_valid = valid.sum(dim=-1)
    first = torch.where(n_valid > 0, valid.int().argmax(dim=-1), 0)
    last = torch.where(n_valid > 0, first + n_valid - 1, 0)
    # k: the segments fully passed before the target, the last valid one
    # taking the remainder
    passed = (
        (target[..., None, :] > cum[..., :, None])
        & (seg[:, None] < last[..., None, None])
        & valid[..., None]
    )  # (B, V, R, T)
    k = torch.minimum(first[..., None] + passed.sum(dim=-2), last[..., None])
    lane_k = torch.gather(seg_lane, -1, k)
    prev = torch.gather(cum, -1, (k - 1).clamp(min=0))
    base = torch.where(k > first[..., None], prev, 0.0)
    s_local = target - base
    pos = lane_ops.position(geo, lane_k, s_local, torch.zeros_like(s_local))
    heading = lane_ops.heading_at(geo, lane_k, s_local)
    return pos, heading


def _one_way(a, b):
    """Any probe point of rectangle ``a`` inside rectangle ``b``: each is
    (x, y, probe length, probe width, cos, sin) broadcast together."""
    ax, ay, la, wa, ca, sa = a
    bx, by, lb, wb, cb, sb = b
    out = None
    for fx, fy in PROBES:
        lx = fx * la
        ly = fy * wa
        ppx = ax + ca * lx - sa * ly
        ppy = ay + sa * lx + ca * ly
        dxp = ppx - bx
        dyp = ppy - by
        rx = cb * dxp - sb * dyp
        ry = sb * dxp + cb * dyp
        ins = (-lb / 2 <= rx) & (rx <= lb / 2) & (-wb / 2 <= ry) & (ry <= wb / 2)
        out = ins if out is None else out | ins
    return out


def enforce_road_rules(geo: LaneGeometry, state: VehicleState) -> VehicleState:
    """One regulation pass (reference ``RegulatedRoad.enforce_road_rules``):
    writes ``target_speed``, ``is_yielding`` and ``yield_timer`` only."""
    V = state.kind.shape[-1]
    dev = state.speed.device
    li = lane_ops._gather(geo, state.lane)

    # 1. release expired yielders to their lane's speed limit
    expired = state.is_yielding & (
        state.yield_timer >= YIELD_DURATION * REGULATION_FREQUENCY
    )
    target_speed = torch.where(expired, geo.speed_limit[li], state.target_speed)
    yield_timer = torch.where(
        state.is_yielding & ~expired, state.yield_timer + 1, state.yield_timer
    )
    is_yielding = state.is_yielding & ~expired

    # 2. future overlaps of every ordered pair (i, j) at every time
    pos, heading = predict_route_positions(geo, state)
    px, py = pos[..., 0], pos[..., 1]  # (B, V, T)
    cos_h, sin_h = torch.cos(heading), torch.sin(heading)

    def rows(x):  # (B, V, T) -> the pair's i side and j side, (B, V, V, T)
        return x[..., :, None, :], x[..., None, :, :]

    px_i, px_j = rows(px)
    py_i, py_j = rows(py)
    c_i, c_j = rows(cos_h)
    s_i, s_j = rows(sin_h)
    l_i = state.length[..., :, None, None]
    l_j = state.length[..., None, :, None]
    w_i = state.width[..., :, None, None]
    w_j = state.width[..., None, :, None]
    dx = px_j - px_i
    dy = py_j - py_i
    close = dx * dx + dy * dy <= l_i * l_i  # the lower index's length
    rect_i = (px_i, py_i, 1.5 * l_i, 0.9 * w_i, c_i, s_i)
    rect_j = (px_j, py_j, 1.5 * l_j, 0.9 * w_j, c_j, s_j)
    hit = close & (_one_way(rect_i, rect_j) | _one_way(rect_j, rect_i))

    idx = torch.arange(V, device=dev)
    upper = idx[:, None] < idx[None, :]
    vh = state.is_vehicle
    conflict = upper & vh[..., :, None] & vh[..., None, :] & hit.any(dim=-1)  # (B, V, V)

    # 3. who yields: the lower current-lane priority; on a tie the trailing
    # vehicle, the one less far ahead of the other along its heading
    prio = geo.priority[li]
    p_i, p_j = prio[..., :, None], prio[..., None, :]
    d = state.pos[..., None, :, :] - state.pos[..., :, None, :]  # pos_j - pos_i
    cos0, sin0 = torch.cos(state.heading), torch.sin(state.heading)
    front_ij = d[..., 0] * cos0[..., :, None] + d[..., 1] * sin0[..., :, None]
    front_ji = (-d[..., 0]) * cos0[..., None, :] + (-d[..., 1]) * sin0[..., None, :]
    i_yields = torch.where(
        p_i > p_j, False, torch.where(p_i < p_j, True, front_ij > front_ji)
    )
    can_yield = (state.kind == KIND_IDM) | (state.kind == KIND_LINEAR)
    new_yield = (
        (conflict & i_yields).any(dim=-1) | (conflict & ~i_yields).any(dim=-2)
    ) & can_yield
    return state.replace(
        target_speed=torch.where(new_yield, 0.0, target_speed),
        yield_timer=torch.where(new_yield, 0, yield_timer).to(torch.int32),
        is_yielding=is_yielding | new_yield,
    )
