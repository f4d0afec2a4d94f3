"""IDM longitudinal model and the MOBIL lane-change policy of the NPCs.

PyTorch counterpart of ``highwayenv_tpu/vehicle/behavior.py`` (reference
vehicle/behavior.py ``IDMVehicle``):

  - IDM:   a = a_c [1 - (v/v0)^delta - (d*/d)^2],
           d* = d0 + vT + v dv / (2 sqrt(ab))
  - MOBIL: safety (imposed braking >= -max_braking) + incentive
           (jerk >= gain) or, on a route with an explicit lane, the
           route-directed override; abort-on-conflict, timer gating.
  - LinearVehicle (the Linear, Aggressive and Defensive presets, kind
           ``KIND_LINEAR``): the same decisions, with the acceleration
           theta . [v0 - v, min(v_f - v, 0), min(d - d_safe, 0)] in place
           of IDM's wherever the deciding row is Linear.

``idm_acceleration`` is shared by both paths.  The straight frame
(ops/straight_frames.py) runs its own decision pass on the road axis; the
general pass below (``idm_act``) is the JAX package's default decision pass
on the (B, L, V) projection table of every object on every lane, with
neighbour slots as indices (-1 = none).  With ``connected`` (the -v1 and
-v2 ids' ``neighbour_vehicles_connected_lanes``) every neighbour query goes
through ``neighbours_connected``, which also searches the query lane's
successor and predecessor lanes.  ``idm_act_sequential`` is the
reference's exact decision order (``sequential_decisions``, PARITY.md #1):
slot after slot, each reading the targets the slots before it wrote.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from highwayenv_tpu_torch.road import lane as lane_ops
from highwayenv_tpu_torch.road.lane import VEHICLE_LENGTH, LaneGeometry
from highwayenv_tpu_torch.utils.math import not_zero
from highwayenv_tpu_torch.vehicle import controller
from highwayenv_tpu_torch.vehicle.controller import table_row
from highwayenv_tpu_torch.vehicle.state import (
    KIND_IDM,
    KIND_LANDMARK,
    KIND_LINEAR,
    VehicleState,
)

#: LinearVehicle's time headway of its safe distance (reference
#: ``LinearVehicle.TIME_WANTED``), not ``IDMParams.time_wanted``
LINEAR_TIME_WANTED = 2.5


@dataclasses.dataclass(frozen=True)
class IDMParams:
    """IDMVehicle class constants (reference vehicle/behavior.py)."""

    acc_max: float = 6.0
    comfort_acc_max: float = 3.0
    comfort_acc_min: float = -5.0
    distance_wanted: float = 5.0 + 5.0  # 5.0 + ControlledVehicle.LENGTH
    time_wanted: float = 1.5
    delta: float = 4.0
    politeness: float = 0.0
    lane_change_min_acc_gain: float = 0.2
    lane_change_max_braking_imposed: float = 2.0
    lane_change_delay: float = 1.0

    @property
    def inv_two_sqrt_ab(self) -> float:
        """``1 / (2 sqrt(a b))`` of the IDM gap term in float32.  The gap
        term multiplies by it: a multiplication by a scalar rounds the same
        in every torch backend and in the CUDA kernel, where torch's CUDA
        division by a scalar silently multiplies by its reciprocal."""
        ab = np.float32(-self.comfort_acc_max * self.comfort_acc_min)
        two_sqrt_ab = np.float32(2.0) * np.float32(math.sqrt(ab))
        return float(np.float32(1.0) / two_sqrt_ab)


def is_driven(state: VehicleState) -> torch.Tensor:
    """(B, V) rows the NPC decision pass drives: uncrashed IDM and Linear
    NPCs."""
    return ((state.kind == KIND_IDM) | (state.kind == KIND_LINEAR)) & ~state.crashed


def linear_acceleration(
    p: IDMParams, accel_params, ego_speed, ego_target_speed, ego_s,
    front_s, front_speed, front_exists,
):
    """LinearVehicle's acceleration of an ego row behind a front row
    (reference ``LinearVehicle.acceleration``): theta . [vt, dv, dp] with
    vt = v0 - v on the unclipped target speed, dv = min(v_f - v, 0) on the
    front row's scalar speed, dp = min(d - d_safe, 0) with d_safe =
    d0 + max(v, 0) ``LINEAR_TIME_WANTED``; dv and dp are 0 where no front
    row exists.  ``accel_params`` (..., 3) is the deciding row's theta."""
    vt = ego_target_speed - ego_speed
    d_safe = p.distance_wanted + ego_speed.clamp(min=0.0) * LINEAR_TIME_WANTED
    dv = (front_speed - ego_speed).clamp(max=0.0)
    dp = ((front_s - ego_s) - d_safe).clamp(max=0.0)
    return (
        accel_params[..., 0] * vt
        + accel_params[..., 1] * torch.where(front_exists, dv, 0.0)
    ) + accel_params[..., 2] * torch.where(front_exists, dp, 0.0)


def idm_acceleration(
    p: IDMParams, speed_limit: float, delta,
    ego_speed, ego_target_speed, ego_s, ego_cos, ego_sin,
    front_s, front_vx, front_vy, front_exists, linear, front_speed,
):
    """IDM acceleration of an ego row behind a front row.

    ``delta`` is the deciding vehicle's exponent even when the ego row is a
    neighbour (the reference evaluates ``self.DELTA``).  Rows are tensors of
    one shape; ``front_exists`` masks the interaction term.  ``speed_limit``
    is one float for the road or a tensor of the ego row's lane limits
    (+inf where unlimited).  ``linear`` is the deciding rows'
    ``(mask, accel_params)``: where the mask is set the acceleration is
    ``linear_acceleration`` with their parameters, which reads the front
    row's ``front_speed`` (the decider's law, as the reference calls
    ``self.acceleration`` on a neighbour).
    """
    if torch.is_tensor(speed_limit):
        ego_ts = torch.where(
            torch.isinf(speed_limit), ego_target_speed,
            torch.minimum(ego_target_speed.clamp(min=0.0), speed_limit),
        )
    else:
        ego_ts = (
            ego_target_speed
            if math.isinf(speed_limit)
            else ego_target_speed.clamp(0.0, speed_limit)
        )
    free = p.comfort_acc_max * (
        1.0 - torch.pow(ego_speed.clamp(min=0.0) / not_zero(ego_ts).abs(), delta)
    )
    d = front_s - ego_s
    dv = (ego_speed * ego_cos - front_vx) * ego_cos + (
        ego_speed * ego_sin - front_vy
    ) * ego_sin
    d_star = (
        p.distance_wanted
        + ego_speed * p.time_wanted
        + ego_speed * dv * p.inv_two_sqrt_ab
    )
    q = d_star / not_zero(d)
    interaction = p.comfort_acc_max * (q * q)
    acc = free - torch.where(front_exists, interaction, 0.0)
    mask, accel_params = linear
    return torch.where(mask, linear_acceleration(
        p, accel_params, ego_speed, ego_target_speed, ego_s, front_s, front_speed,
        front_exists,
    ), acc)


# --------------------------------------------------------------------------- #
# the general decision pass on the projection table
# --------------------------------------------------------------------------- #


def eligible_on_lane(geo: LaneGeometry, state: VehicleState, table_s, table_lat):
    """(B, L, V) mask: object j occupies lane l (1 m margin) for the
    neighbour search (reference road/road.py ``neighbour_vehicles``)."""
    width = geo.width[:, None]
    length = geo.length[:, None]
    on = (
        (table_lat.abs() <= width / 2 + 1.0)
        & (-VEHICLE_LENGTH <= table_s)
        & (table_s < length + VEHICLE_LENGTH)
    )
    return on & (state.active & (state.kind != KIND_LANDMARK))[:, None, :]


def pair_table(table: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
    """``out[b, i, j] = table[b, lane[b, i], j]``: every object projected on
    each row's query lane (JAX ``lane_ops.pair_project``)."""
    V = table.shape[-1]
    li = lane.clamp(0, table.shape[-2] - 1).long()
    return torch.gather(table, 1, li[..., None].expand(-1, -1, V))


def front_pick(ok, s_c):
    """Front neighbour among the columns where ``ok`` (..., V, V): the
    smallest key ``s_c``, the LAST column among equal keys; -1 = none."""
    cols = torch.arange(ok.shape[-1], device=ok.device)
    key = torch.where(ok, s_c, math.inf)
    hit = ok & (key == key.amin(dim=-1, keepdim=True))
    return torch.where(hit, cols, -1).amax(dim=-1)


def rear_pick(ok, s_c):
    """Rear neighbour among the columns where ``ok``: the largest key, the
    FIRST column among equal keys; -1 = none."""
    V = ok.shape[-1]
    cols = torch.arange(V, device=ok.device)
    key = torch.where(ok, s_c, -math.inf)
    hit = ok & (key == key.amax(dim=-1, keepdim=True))
    idx = torch.where(hit, cols, V).amin(dim=-1)
    return torch.where(idx == V, -1, idx)


def neighbours(state: VehicleState, query_lane, table_s, elig):
    """Front / rear object of each row on its query lane, (B, V) slot
    indices, -1 = none: front = smallest s_j >= s_i keeping the LAST column
    among ties, rear = largest s_j < s_i keeping the FIRST (PARITY #3)."""
    V = state.num_slots
    eye = torch.eye(V, dtype=torch.bool, device=table_s.device)
    s_self = table_row(table_s, query_lane)[..., None]
    s_pairs = pair_table(table_s, query_lane)
    ok = pair_table(elig, query_lane) & ~eye
    return (
        front_pick(ok & (s_self <= s_pairs), s_pairs),
        rear_pick(ok & (s_pairs < s_self), s_pairs),
    )


def neighbours_connected(geo: LaneGeometry, state: VehicleState, query_lane, table_s,
                         table_lat):
    """Front / rear object of each row on its query lane and the lanes
    connected to it (reference road/road.py ``neighbour_vehicles`` with
    ``neighbour_vehicles_connected_lanes``), (B, V) slot indices, -1 = none.

    The candidates of the query lane q are ``geo.conn_lanes[q]`` (q itself,
    its successor lanes, its predecessor lanes).  Each object takes the
    FIRST candidate it is on (the 1 m margin and ``-VEHICLE_LENGTH <= s <
    length + VEHICLE_LENGTH``), and its s there shifted by that candidate's
    offset is its key; eligibility and the tie rules are ``neighbours``':
    front = smallest key >= s_i keeping the LAST column among ties, rear =
    largest key < s_i keeping the FIRST.  ``s_i`` is the row's own s on q."""
    Bn, L, V = table_s.shape
    q = lane_ops._gather(geo, query_lane)
    cand = geo.conn_lanes[q]  # (B, V, K)
    K = cand.shape[-1]
    cl = cand.clamp(0, L - 1).long()
    rows = cl.flatten(1)[..., None].expand(-1, -1, V)  # (B, V K, V)
    s_k = torch.gather(table_s, 1, rows).view(Bn, V, K, V)
    lat_k = torch.gather(table_lat, 1, rows).view(Bn, V, K, V)
    on = (
        (lat_k.abs() <= (geo.width[cl] / 2 + 1.0)[..., None])
        & (-VEHICLE_LENGTH <= s_k)
        & (s_k < (geo.length[cl] + VEHICLE_LENGTH)[..., None])
        & (cand >= 0)[..., None]
    )
    # the first candidate each object is on (0 where it is on none)
    first = on.to(torch.uint8).argmax(dim=-2, keepdim=True)  # (B, V, 1, V)
    key = torch.gather(s_k, 2, first)[..., 0, :] + torch.gather(
        geo.conn_offsets[q], 2, first[..., 0, :])
    eye = torch.eye(V, dtype=torch.bool, device=table_s.device)
    ok = on.any(dim=-2) & ~eye & (state.active & (state.kind != KIND_LANDMARK))[:, None, :]
    s_self = table_row(table_s, query_lane)[..., None]
    return front_pick(ok & (s_self <= key), key), rear_pick(ok & (key < s_self), key)


def query_neighbours(geo, state, query_lane, table_s, table_lat, elig, connected: bool):
    """``neighbours_connected`` with ``connected``, else ``neighbours`` (the
    JAX package's ``_query_neighbours``)."""
    if connected:
        return neighbours_connected(geo, state, query_lane, table_s, table_lat)
    return neighbours(state, query_lane, table_s, elig)


class Rows:
    """The frame-start fields an IDM pair fetches by slot index, and the
    deciding rows' law (``linear``: their Linear mask and parameters)."""

    def __init__(self, geo: LaneGeometry, state: VehicleState, table_s):
        self.geo, self.table_s = geo, table_s
        cos_h, sin_h = torch.cos(state.heading), torch.sin(state.heading)
        self.fields = {
            "speed": state.speed, "target_speed": state.target_speed,
            "lane": state.lane, "cos": cos_h, "sin": sin_h,
            "vx": state.speed * cos_h, "vy": state.speed * sin_h,
            "is_vehicle": state.is_vehicle,
        }
        self.delta = state.delta
        self.linear = (state.kind == KIND_LINEAR, state.accel_params)
        self.self_idx = torch.arange(
            state.num_slots, device=table_s.device
        ).expand_as(state.lane)

    def get(self, name, idx):
        return torch.gather(self.fields[name], 1, idx.clamp(min=0))

    def accel(self, p: IDMParams, ego_idx, front_idx):
        """IDM acceleration of row ``ego_idx`` behind row ``front_idx``
        (-1 = none), with the deciding row's exponent, the ego's target
        speed clipped by its current lane's limit and the gap measured on
        the ego's current lane, or the deciding row's linear law; 0 where
        the ego is absent or no vehicle (reference
        ``IDMVehicle.acceleration``)."""
        e_lane = self.get("lane", ego_idx)
        L, V = self.table_s.shape[-2:]
        flat = self.table_s.flatten(1)
        lane_off = e_lane.clamp(0, L - 1).long() * V

        def s_on_ego_lane(idx):
            return torch.gather(flat, 1, lane_off + idx.clamp(min=0))

        acc = idm_acceleration(
            p, self.geo.speed_limit[lane_ops._gather(self.geo, e_lane)], self.delta,
            self.get("speed", ego_idx), self.get("target_speed", ego_idx),
            s_on_ego_lane(ego_idx), self.get("cos", ego_idx),
            self.get("sin", ego_idx), s_on_ego_lane(front_idx),
            self.get("vx", front_idx), self.get("vy", front_idx), front_idx >= 0,
            self.linear, self.get("speed", front_idx),
        )
        return torch.where(
            (ego_idx >= 0) & self.get("is_vehicle", ego_idx), acc, 0.0
        )


def _mobil(geo, p, state, rows: Rows, cand, cur_front, cur_rear, table, elig,
           connected: bool):
    """Reference ``IDMVehicle.mobil`` toward lane ``cand`` (B, V)."""
    me = rows.self_idx
    new_front, new_rear = query_neighbours(geo, state, cand, *table, elig, connected)
    a_nf_pred = rows.accel(p, new_rear, me)
    safe = a_nf_pred >= -state.mobil_max_braking
    a_self_pred = rows.accel(p, me, new_front)

    # route-directed branch: the route head names a lane
    head_id = torch.gather(
        state.route_id, -1,
        state.route_ptr.clamp(0, state.route_id.shape[-1] - 1).long()[..., None],
    )[..., 0]
    has_route_id = (state.route_ptr < state.route_len) & (head_id >= 0)
    tgt_id = geo.lane_id[lane_ops._gather(geo, state.target_lane)]
    cand_id = geo.lane_id[lane_ops._gather(geo, cand)]
    route_ok = (torch.sign(cand_id - tgt_id) == torch.sign(head_id - tgt_id)) & (
        a_self_pred >= -state.mobil_max_braking
    )

    # incentive branch
    a_nf = rows.accel(p, new_rear, new_front)
    a_self = rows.accel(p, me, cur_front)
    a_of = rows.accel(p, cur_rear, me)
    a_of_pred = rows.accel(p, cur_rear, cur_front)
    jerk = a_self_pred - a_self + p.politeness * (
        a_nf_pred - a_nf + a_of_pred - a_of
    )
    return safe & torch.where(has_route_id, route_ok, jerk >= state.mobil_gain)


def conflict_pairs(p: IDMParams, state: VehicleState, rows: Rows, table_s) -> torch.Tensor:
    """The frame-start part of the abort-on-conflict test, (B, V, V):
    ``[b, i, j]`` row j is another controlled vehicle within row i's safe
    distance ahead of it, measured on row i's current lane."""
    V = state.num_slots
    lane = state.lane
    s_pairs = pair_table(table_s, lane)
    d_ij = s_pairs - table_row(table_s, lane)[..., None]
    vx, vy = rows.fields["vx"], rows.fields["vy"]
    dv_ij = (vx[..., :, None] - vx[..., None, :]) * rows.fields["cos"][..., None] + (
        vy[..., :, None] - vy[..., None, :]
    ) * rows.fields["sin"][..., None]
    speed = state.speed[..., None]
    d_star_ij = p.distance_wanted + speed * p.time_wanted + speed * dv_ij * (
        p.inv_two_sqrt_ab
    )
    eye = torch.eye(V, dtype=torch.bool, device=lane.device)
    return ~eye & state.is_controlled[:, None, :] & (0.0 < d_ij) & (d_ij < d_star_ij)


def may_abort(geo: LaneGeometry, state: VehicleState) -> torch.Tensor:
    """(B, V) the rows whose lane change an abort can stop: driven rows
    changing lanes on their own road."""
    li = lane_ops._gather(geo, state.lane)
    tli = lane_ops._gather(geo, state.target_lane)
    return (is_driven(state) & (state.lane != state.target_lane)
            & (geo.edge_base[li] == geo.edge_base[tli]))


def lane_decision(geo: LaneGeometry, p: IDMParams, state: VehicleState, rows: Rows,
                  table, elig, cur_front, cur_rear, connected: bool):
    """The timer-gated MOBIL choice of the left then the right lane of every
    IDM and Linear row not changing lanes (reference
    ``IDMVehicle.change_lane_policy`` after its abort test).  Reads each
    row's own target lane and route cursor, the frame-start ``rows`` and
    ``elig`` and the current lane's neighbours ``cur_front`` / ``cur_rear``,
    never another row's target.  Returns (target lanes, timers)."""
    table_s, table_lat = table
    li = lane_ops._gather(geo, state.lane)
    deciding = (
        is_driven(state) & (state.lane == state.target_lane)
        & (state.timer > p.lane_change_delay) & state.enable_lane_change
    )
    moving = state.speed.abs() >= 1.0
    target = state.target_lane
    for delta_id in (-1, 1):
        cand_id = geo.lane_id[li] + delta_id
        exists = (cand_id >= 0) & (cand_id < geo.edge_n[li])
        cand = (geo.edge_base[li] + cand_id).clamp(0, geo.num_lanes - 1)
        reachable = lane_ops.reachable_from_coords(
            geo, cand, table_row(table_s, cand), table_row(table_lat, cand)
        )
        ok = deciding & exists & reachable & moving & _mobil(
            geo, p, state, rows, cand, cur_front, cur_rear, table, elig, connected
        )
        target = torch.where(ok, cand, target)
    return target, torch.where(deciding, 0.0, state.timer)


def change_lane_policy(geo: LaneGeometry, p: IDMParams, state: VehicleState,
                       rows: Rows, table, elig, cur_front, cur_rear,
                       connected: bool) -> VehicleState:
    """The decision of every IDM and Linear vehicle on the frame-start table
    (reference ``IDMVehicle.change_lane_policy``): abort a lane change into
    a gap another controlled vehicle is closing (same road only), else the
    timer-gated MOBIL choice (``lane_decision``).  Every row reads the
    others' targets as ``state`` holds them.  Returns the state with the new
    target lanes and timers."""
    lane, tlane = state.lane, state.target_lane
    conflict = (
        conflict_pairs(p, state, rows, table[0])
        & (lane[:, None, :] != tlane[:, :, None])
        & (tlane[:, None, :] == tlane[:, :, None])
    )
    abort = may_abort(geo, state) & conflict.any(dim=-1)
    target, timer = lane_decision(geo, p, state, rows, table, elig, cur_front, cur_rear,
                                  connected)
    return state.replace(target_lane=torch.where(abort, lane, target), timer=timer)


def idm_accel(geo: LaneGeometry, p: IDMParams, state: VehicleState, rows: Rows,
              table, elig, cur_front, connected: bool) -> torch.Tensor:
    """The IDM (or Linear) acceleration of every row toward ``state``'s
    target lanes: behind the current lane's front row, the minimum with the
    target lane's front row while changing lanes; clipped to +-acc_max."""
    me = rows.self_idx
    accel = rows.accel(p, me, cur_front)
    target = state.target_lane
    target_front, _ = query_neighbours(geo, state, target, *table, elig, connected)
    accel = torch.where(
        state.lane != target, torch.minimum(accel, rows.accel(p, me, target_front)), accel
    )
    return accel.clamp(-p.acc_max, p.acc_max)


def idm_act(geo: LaneGeometry, p: IDMParams, state: VehicleState, table_s,
            table_lat, connected: bool = False):
    """The decision pass of every IDM and Linear vehicle on the frame-start
    table (reference ``IDMVehicle.act``), each row deciding on the
    frame-start targets (``change_lane_policy``); then the IDM acceleration,
    the minimum of the current and the target lane's while changing lanes
    (``idm_accel``).  ``connected``: every neighbour query searches the
    connected lanes too (``neighbours_connected``); the gaps stay measured
    on the ego's own lane.  Returns the state with the new target lanes and
    timers, and the IDM acceleration (B, V)."""
    rows = Rows(geo, state, table_s)
    elig = eligible_on_lane(geo, state, table_s, table_lat)
    table = (table_s, table_lat)
    cur_front, cur_rear = query_neighbours(geo, state, state.lane, *table, elig, connected)
    state = change_lane_policy(geo, p, state, rows, table, elig, cur_front, cur_rear,
                               connected)
    return state, idm_accel(geo, p, state, rows, table, elig, cur_front, connected)


def idm_act_sequential(geo: LaneGeometry, p: IDMParams, state: VehicleState, table_s,
                       table_lat, max_edge_lanes: int, connected: bool = False):
    """The decision pass in the reference's act() order (road/road.py
    ``act``: vehicle after vehicle), the JAX package's
    ``idm_act_sequential``: slot by slot in index order, the slot's
    ``follow_road``, then its ``change_lane_policy`` reading the other
    rows' target lanes as they stand, the slots before it done and the
    slots after it not yet moved by their own ``follow_road``.

    Only the abort test reads another row's target, so the rest is computed
    once for every row: ``follow_road`` and the MOBIL choice read each row's
    own fields (``lane_decision``), and a row that is changing lanes cannot
    also decide.  The slot loop then runs the abort test alone, row i
    against the targets of the rows before it (final) and after it (as the
    frame began): the JAX package's scan, in a few operations a slot.  The
    accelerations read positions, speeds and each row's own final target,
    so they follow the loop once, on every row.  Returns the state and the
    IDM acceleration (B, V)."""
    rows = Rows(geo, state, table_s)
    elig = eligible_on_lane(geo, state, table_s, table_lat)
    table = (table_s, table_lat)
    cur_front, cur_rear = query_neighbours(geo, state, state.lane, *table, elig, connected)
    pairs = conflict_pairs(p, state, rows, table_s)
    before = state.target_lane
    state = controller.follow_road(geo, state, max_edge_lanes, table_s)
    decided, timer = lane_decision(geo, p, state, rows, table, elig, cur_front, cur_rear,
                                   connected)
    lane, own = state.lane, state.target_lane
    aborts = may_abort(geo, state)
    target = before.clone()
    for i in range(state.num_slots):
        mine = own[:, i, None]
        hit = (pairs[:, i] & (lane != mine) & (target == mine)).any(dim=-1)
        target[:, i] = torch.where(aborts[:, i] & hit, lane[:, i], decided[:, i])
    state = state.replace(target_lane=target, timer=timer)
    return state, idm_accel(geo, p, state, rows, table, elig, cur_front, connected)
