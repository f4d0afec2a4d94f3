"""Low-level controllers, lane following and the discrete meta-action.

PyTorch counterpart of ``highwayenv_tpu/vehicle/controller.py`` (reference
vehicle/controller.py ``ControlledVehicle``/``MDPVehicle``): the steering
P-cascade, the speed P controller, the end-of-lane ``follow_road`` /
``next_lane`` advance on the lane graph with the route cursor, the MDP
speed index and the meta-action target updates.  Batched over (B, V); the
lane queries of a frame read the (B, L, V) projection table of
``road/lane.py::projection_table``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from highwayenv_tpu_torch.road import lane as lane_ops
from highwayenv_tpu_torch.road.lane import LaneGeometry
from highwayenv_tpu_torch.utils.math import not_zero, wrap_to_pi
from highwayenv_tpu_torch.vehicle.state import VehicleState

# ControlledVehicle constants (reference vehicle/controller.py)
TAU_ACC = 0.6
TAU_HEADING = 0.2
TAU_LATERAL = 0.6
TAU_PURSUIT = 0.5 * TAU_HEADING
KP_A = 1 / TAU_ACC
KP_HEADING = 1 / TAU_HEADING
KP_LATERAL = 1 / TAU_LATERAL
MAX_STEERING_ANGLE = np.pi / 3

DEFAULT_TARGET_SPEEDS = np.linspace(20, 30, 3)

# DiscreteMetaAction indices (reference envs/common/action.py)
LANE_LEFT, IDLE, LANE_RIGHT, FASTER, SLOWER = 0, 1, 2, 3, 4


def steering_from_coords(lane_heading, lat, heading, speed, vehicle_length):
    """P-cascade lateral controller from lane coordinates (reference
    vehicle/controller.py ``steering_control``).  ``lane_heading`` is the
    target lane's heading ahead of the vehicle; on a straight lane a
    constant.  Returns the clipped steering angle."""
    lateral_speed_command = -KP_LATERAL * lat
    heading_command = torch.asin(
        (lateral_speed_command / not_zero(speed)).clamp(-1.0, 1.0)
    )
    heading_ref = lane_heading + heading_command.clamp(-math.pi / 4, math.pi / 4)
    heading_rate_command = KP_HEADING * wrap_to_pi(heading_ref - heading)
    slip_angle = torch.asin(
        (vehicle_length / 2 / not_zero(speed) * heading_rate_command).clamp(
            -1.0, 1.0
        )
    )
    # arctan(2 tan(slip)) as arctan2(2 sin, cos): equal on (-pi/2, pi/2)
    # and safe at slip = +/- pi/2, where float32 tan() flips sign
    steering_angle = torch.atan2(2 * torch.sin(slip_angle), torch.cos(slip_angle))
    return steering_angle.clamp(-MAX_STEERING_ANGLE, MAX_STEERING_ANGLE)


def linear_steering(lane_heading, lat, heading, speed, vehicle_length, steer_params):
    """LinearVehicle's lateral controller (reference
    ``LinearVehicle.steering_control``), linear in its ``steer_params``
    (..., 2): p0 wrap(lane_heading - heading) length / v + p1 (-lat length
    / v^2), v = not_zero(speed), clipped as the P-cascade's angle.
    ``lane_heading`` is the target lane's heading a pursuit distance ahead
    and ``lat`` the lateral offset from it."""
    v = not_zero(speed)
    feat_h = wrap_to_pi(lane_heading - heading) * vehicle_length / v
    feat_lat = -lat * vehicle_length / (v * v)
    steering_angle = steer_params[..., 0] * feat_h + steer_params[..., 1] * feat_lat
    return steering_angle.clamp(-MAX_STEERING_ANGLE, MAX_STEERING_ANGLE)


def steering_control(geo: LaneGeometry, target_lane, pos, heading, speed, length):
    """Steering toward ``target_lane`` (straight lanes: constant heading)."""
    _s, lat = lane_ops.local_coordinates(geo, target_lane, pos)
    lane_heading = geo.heading0[lane_ops._gather(geo, target_lane)]
    return steering_from_coords(lane_heading, lat, heading, speed, length)


def table_row(table: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
    """Row-aligned lane lookup: ``table[b, lane[b, i], i]`` of a (B, L, V)
    table and (B, V) lanes (JAX ``lane_ops.row_lookup``)."""
    li = lane.clamp(0, table.shape[-2] - 1).long()
    return torch.gather(table, -2, li[..., None, :])[..., 0, :]


def steering_from_table(geo: LaneGeometry, lane, state: VehicleState, table_s,
                        table_lat, linear):
    """Steering toward ``lane`` (B, V) with its (s, lat) read from the
    projection table; the lane heading is taken a pursuit distance ahead
    (JAX ``steering_control_from_table``).  Where the (B, V) mask ``linear``
    is set, LinearVehicle's law (``linear_steering``) instead."""
    s = table_row(table_s, lane)
    lat = table_row(table_lat, lane)
    future = lane_ops.heading_at(geo, lane, s + state.speed * TAU_PURSUIT)
    steer = steering_from_coords(
        future, lat, state.heading, state.speed, state.length
    )
    return torch.where(linear, linear_steering(
        future, lat, state.heading, state.speed, state.length, state.steer_params
    ), steer)


def speed_control(target_speed, speed):
    """Reference vehicle/controller.py ``speed_control``."""
    return KP_A * (target_speed - speed)


def speed_to_index(speed: torch.Tensor, target_speeds) -> torch.Tensor:
    """Reference ``speed_to_index`` (uniform grid, banker's rounding)."""
    ts = np.asarray(target_speeds)
    x = (speed - ts[0]) / (ts[-1] - ts[0])
    return torch.round(x * (len(ts) - 1)).clamp(0, len(ts) - 1).to(torch.int32)


def ego_speed_init(action_type, speed):
    """Meta-action egos snap to the nearest ``target_speeds`` entry;
    raw-control egos (ContinuousAction, DiscreteAction) keep their spawn
    speed and carry no speed index.

    Returns ``(speed_index_i32, target_speed)`` with ``speed``'s shape.
    """
    if action_type.stores_raw_controls:
        return torch.zeros_like(speed, dtype=torch.int32), speed
    idx = speed_to_index(speed, action_type.target_speeds)
    return idx, action_type.speed_table(speed.device)[idx.long()]


# --------------------------------------------------------------------------- #
# lane-graph following
# --------------------------------------------------------------------------- #


def next_lane_given_next_edge(geo: LaneGeometry, cur_lane, cand_base, cand_n,
                              next_id, projected, max_edge_lanes: int):
    """The lane to take on a given next edge (reference road/road.py
    ``next_lane``'s lane choice).  ``cand_base`` / ``cand_n`` / ``next_id``
    (...,): the edge's base lane, lane count and explicit lane id (-1 =
    none); ``projected`` (..., 2).  When the lane counts match an explicit id
    is honoured, else the current id is kept; when they differ the lane
    closest to ``projected`` wins (first minimum).  Returns (lane, distance
    of ``projected`` to it, inf for an empty edge)."""
    li = lane_ops._gather(geo, cur_lane)
    ids = torch.arange(max_edge_lanes, device=cand_base.device)
    valid = ids < cand_n[..., None]
    d = lane_ops.distance(geo, cand_base[..., None] + ids, projected[..., None, :])
    d = torch.where(valid, d, math.inf)
    closest_id = torch.argmin(d, dim=-1)
    chosen_id = torch.where(
        geo.edge_n[li] == cand_n,
        torch.where(next_id >= 0, next_id, geo.lane_id[li]).long(),
        closest_id,
    )
    chosen_id = torch.minimum(
        chosen_id.clamp(min=0), (cand_n - 1).clamp(min=0).long()
    )
    dist = torch.gather(d, -1, chosen_id[..., None])[..., 0]
    return (cand_base + chosen_id).to(torch.int32), dist


def _route_entry(field: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """``field[..., clip(ptr)]`` of (B, V, R) route arrays."""
    p = ptr.clamp(0, field.shape[-1] - 1).long()
    return torch.gather(field, -1, p[..., None])[..., 0]


def next_lane(geo: LaneGeometry, state: VehicleState, cur_lane, s,
              max_edge_lanes: int):
    """The lane to follow after ``cur_lane`` (at longitudinal ``s``) ends,
    and the advanced route cursor (reference road/road.py ``next_lane``):
    pop the route head when it is the edge being finished; follow the route
    when its head leaves the end node; else pick among the edges leaving the
    end node the one whose chosen lane is closest to the position projected
    on the lane centre (first minimum); with no successor keep the lane."""
    li = lane_ops._gather(geo, cur_lane)
    projected = lane_ops.position(geo, cur_lane, s, torch.zeros_like(s))

    ptr = state.route_ptr
    pop = (ptr < state.route_len) & (
        _route_entry(state.route_base, ptr) == geo.edge_base[li]
    )
    new_ptr = torch.where(pop, ptr + 1, ptr)
    head_base = _route_entry(state.route_base, new_ptr)
    follow_route = (new_ptr < state.route_len) & (
        geo.from_node[lane_ops._gather(geo, head_base)] == geo.to_node[li]
    )
    route_lane, _ = next_lane_given_next_edge(
        geo, cur_lane, head_base, _route_entry(state.route_n, new_ptr),
        _route_entry(state.route_id, new_ptr), projected, max_edge_lanes,
    )

    succ_base, succ_n = geo.succ_edge_base[li], geo.succ_edge_n[li]  # (..., S)
    cand_lane, cand_dist = next_lane_given_next_edge(
        geo, cur_lane[..., None], succ_base, succ_n,
        torch.full_like(succ_base, -1), projected[..., None, :], max_edge_lanes,
    )
    cand_dist = torch.where(succ_base >= 0, cand_dist, math.inf)
    best = torch.argmin(cand_dist, dim=-1, keepdim=True)
    best_lane = torch.gather(cand_lane, -1, best)[..., 0]
    chosen = torch.where(
        follow_route, route_lane,
        torch.where((succ_base >= 0).any(dim=-1), best_lane, cur_lane),
    )
    return chosen.to(torch.int32), new_ptr


def follow_road(geo: LaneGeometry, state: VehicleState, max_edge_lanes: int,
                table_s) -> VehicleState:
    """Controlled vehicles whose target lane ends take the next lane
    (reference vehicle/controller.py ``follow_road``)."""
    tl = state.target_lane
    s = table_row(table_s, tl)
    ended = s > geo.length[lane_ops._gather(geo, tl)] - lane_ops.VEHICLE_LENGTH / 2
    nxt, new_ptr = next_lane(geo, state, tl, s, max_edge_lanes)
    apply = ended & state.is_controlled
    return state.replace(
        target_lane=torch.where(apply, nxt, tl),
        route_ptr=torch.where(apply, new_ptr, state.route_ptr),
    )


# --------------------------------------------------------------------------- #
# MDP (discrete meta-action) ego control
# --------------------------------------------------------------------------- #


def apply_meta_action(
    geo: LaneGeometry,
    state: VehicleState,
    ego_mask: torch.Tensor,
    action: torch.Tensor,
    action_type,
) -> VehicleState:
    """Apply the DiscreteMetaAction ``action_type`` to the masked controlled
    vehicles.

    action: (B, V) int slot actions.  Updates target_lane / speed_index /
    target_speed (reference vehicle/controller.py ``act``).
    """
    target_speeds = action_type.target_speeds
    longitudinal, lateral = action_type.longitudinal, action_type.lateral
    ts = action_type.speed_table(action.device)
    n_speeds = ts.shape[0]
    if longitudinal and lateral:
        lane_left, lane_right = action == LANE_LEFT, action == LANE_RIGHT
        faster, slower = action == FASTER, action == SLOWER
    elif longitudinal:  # {0: SLOWER, 1: IDLE, 2: FASTER}
        lane_left = lane_right = torch.zeros_like(action, dtype=torch.bool)
        faster, slower = action == 2, action == 0
    else:  # {0: LANE_LEFT, 1: IDLE, 2: LANE_RIGHT}
        lane_left, lane_right = action == 0, action == 2
        faster = slower = torch.zeros_like(action, dtype=torch.bool)
    lane_left, lane_right = lane_left & ego_mask, lane_right & ego_mask
    faster, slower = faster & ego_mask, slower & ego_mask

    # the speed index steps from the *current* speed
    cur_index = speed_to_index(state.speed, target_speeds)
    new_index = torch.where(
        faster, cur_index + 1, torch.where(slower, cur_index - 1, state.speed_index)
    ).clamp(0, n_speeds - 1)
    speed_changed = faster | slower
    new_target_speed = torch.where(
        speed_changed, ts[new_index.long()], state.target_speed
    )

    # lane change on the *target* lane's edge
    li = lane_ops._gather(geo, state.target_lane)
    delta_id = torch.where(
        lane_right, 1, torch.where(lane_left, -1, 0)
    ).to(torch.int32)
    cand_id = torch.minimum(
        torch.clamp(geo.lane_id[li] + delta_id, min=0), geo.edge_n[li] - 1
    )
    cand_lane = geo.edge_base[li] + cand_id
    reachable = lane_ops.is_reachable_from(geo, cand_lane, state.pos)
    new_target_lane = torch.where(
        (lane_left | lane_right) & reachable, cand_lane, state.target_lane
    )
    return state.replace(
        speed_index=torch.where(ego_mask, new_index, state.speed_index),
        target_speed=torch.where(ego_mask, new_target_speed, state.target_speed),
        target_lane=torch.where(ego_mask, new_target_lane, state.target_lane),
    )
