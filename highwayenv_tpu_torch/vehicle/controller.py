"""Low-level controllers and the discrete meta-action on a straight road.

PyTorch counterpart of the straight subset of
``highwayenv_tpu/vehicle/controller.py:36-352`` (reference
vehicle/controller.py ``ControlledVehicle``/``MDPVehicle``): the steering
P-cascade, the speed P controller, the MDP speed index and the meta-action
target updates.  Lane following at lane ends (``follow_road``) is absent:
straight networks have no successor lanes.
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


def steering_control(geo: LaneGeometry, target_lane, pos, heading, speed, length):
    """Steering toward ``target_lane`` (straight lanes: constant heading)."""
    _s, lat = lane_ops.local_coordinates(geo, target_lane, pos)
    lane_heading = geo.heading0[lane_ops._gather(geo, target_lane)]
    return steering_from_coords(lane_heading, lat, heading, speed, length)


def speed_control(target_speed, speed):
    """Reference vehicle/controller.py ``speed_control``."""
    return KP_A * (target_speed - speed)


def speed_to_index(speed: torch.Tensor, target_speeds) -> torch.Tensor:
    """Reference ``speed_to_index`` (uniform grid, banker's rounding)."""
    ts = np.asarray(target_speeds)
    x = (speed - ts[0]) / (ts[-1] - ts[0])
    return torch.round(x * (len(ts) - 1)).clamp(0, len(ts) - 1).to(torch.int32)


def ego_speed_init(action_type, speed):
    """Meta-action egos snap to the nearest ``target_speeds`` entry.

    Returns ``(speed_index_i32, target_speed)`` with ``speed``'s shape.
    """
    ts = torch.as_tensor(
        np.asarray(action_type.target_speeds, np.float32), device=speed.device
    )
    idx = speed_to_index(speed, action_type.target_speeds)
    return idx, ts[idx.long()]


def apply_meta_action(
    geo: LaneGeometry,
    state: VehicleState,
    ego_mask: torch.Tensor,
    action: torch.Tensor,
    target_speeds,
    longitudinal: bool = True,
    lateral: bool = True,
) -> VehicleState:
    """Apply a DiscreteMetaAction to the masked controlled vehicles.

    action: (B, V) int slot actions.  Updates target_lane / speed_index /
    target_speed (reference vehicle/controller.py ``act``).
    """
    ts = torch.as_tensor(
        np.asarray(target_speeds, dtype=np.float32), device=action.device
    )
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
