"""Dynamical bicycle model: tire slip and one RK4 step, over masked slots.

PyTorch counterpart of ``highwayenv_tpu/vehicle/dynamics.py`` (reference
``BicycleVehicle``, Rajamani ch. 2): the 6-state [x, y, psi, v, v_lat, r]
with the front and rear tire lateral forces, a low-speed damping branch,
one RK4 step, and the extra action clips (steering +-pi/2, yaw rate +-2pi on
the input).

The expressions keep the JAX package's order of operations, which
``csrc/general_frames.cu``'s ``kDynamical`` branch follows bit for bit on
the card (``kernel_constants`` gives it the float32 factors torch applies).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from highwayenv_tpu_torch.vehicle import kinematics
from highwayenv_tpu_torch.vehicle.state import VEHICLE_LENGTH, VEHICLE_WIDTH, VehicleState

MASS = 1.0
LENGTH_A = VEHICLE_LENGTH / 2
LENGTH_B = VEHICLE_LENGTH / 2
INERTIA_Z = 1 / 12 * MASS * (VEHICLE_LENGTH**2 + VEHICLE_WIDTH**2)
FRICTION_FRONT = 15.0 * MASS
FRICTION_REAR = 15.0 * MASS
MAX_ANGULAR_SPEED = 2 * np.pi


def kernel_constants(dt: float) -> tuple[float, float, float, float]:
    """The float32 factors of one RK4 step of ``dt`` as torch applies them
    on the card: dt / 2 and dt / 6, the low-speed damping
    ``INERTIA_Z / LENGTH_A``, each a Python scalar rounded once, and the
    reciprocal of INERTIA_Z (torch on CUDA divides a tensor by a Python
    scalar as a product with its reciprocal, taken in double and rounded to
    float32)."""
    f32 = np.float32
    return (float(f32(dt / 2)), float(f32(dt / 6)), float(f32(INERTIA_Z / LENGTH_A)),
            float(f32(1 / INERTIA_Z)))


def _derivative(state6: torch.Tensor, steering, accel) -> torch.Tensor:
    """Reference dynamics.py ``derivative``.  state6: (..., 6) = [x, y,
    psi, v, v_lat, r]."""
    heading = state6[..., 2]
    speed = state6[..., 3]
    lateral_speed = state6[..., 4]
    yaw_rate = state6[..., 5]

    theta_vf = torch.atan2(lateral_speed + LENGTH_A * yaw_rate, speed)  # (2.27)
    theta_vr = torch.atan2(lateral_speed - LENGTH_B * yaw_rate, speed)  # (2.28)
    f_yf = 2 * FRICTION_FRONT * (steering - theta_vf)  # (2.25)
    f_yr = 2 * FRICTION_REAR * (0.0 - theta_vr)  # (2.26)
    # the low-speed damping branch
    slow = torch.abs(speed) < 1.0
    f_yf = torch.where(
        slow, -MASS * lateral_speed - INERTIA_Z / LENGTH_A * yaw_rate, f_yf
    )
    f_yr = torch.where(
        slow, -MASS * lateral_speed + INERTIA_Z / LENGTH_A * yaw_rate, f_yr
    )
    d_lat = (f_yf + f_yr) / MASS - yaw_rate * speed  # (2.21)
    d_yaw = (LENGTH_A * f_yf - LENGTH_B * f_yr) / INERTIA_Z  # (2.22)
    c, s = torch.cos(heading), torch.sin(heading)
    dx = c * speed - s * lateral_speed
    dy = s * speed + c * lateral_speed
    return torch.stack([dx, dy, yaw_rate, accel, d_lat, d_yaw], dim=-1)


def _state6(state: VehicleState, yaw_rate: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [state.pos[..., 0], state.pos[..., 1], state.heading, state.speed,
         state.lateral_speed, yaw_rate],
        dim=-1,
    )


def derivative(state: VehicleState) -> torch.Tensor:
    """The state derivative (..., 6) at the stored actions (the
    AttributesObservation's ``derivative``)."""
    return _derivative(_state6(state, state.yaw_rate), state.steering, state.accel)


def integrate_dynamic(state: VehicleState, dt: float, mask: torch.Tensor) -> VehicleState:
    """One RK4 step of the tire-slip model on the ``mask`` slots (reference
    dynamics.py ``step``); the other slots are untouched.  The actions are
    clipped as the kinematic integrator clips them, the steering further to
    +-pi/2 and the yaw rate to +-2pi on the input; the stored yaw rate is
    the RK4 result, unclipped."""
    steering, accel = kinematics.clip_actions(state)
    steering = torch.clamp(steering, -math.pi / 2, math.pi / 2)
    yaw_rate = torch.clamp(state.yaw_rate, -MAX_ANGULAR_SPEED, MAX_ANGULAR_SPEED)

    s6 = _state6(state, yaw_rate)
    f1 = _derivative(s6, steering, accel)
    f2 = _derivative(s6 + f1 * (dt / 2), steering, accel)
    f3 = _derivative(s6 + f2 * (dt / 2), steering, accel)
    f4 = _derivative(s6 + f3 * dt, steering, accel)
    new = s6 + (dt / 6) * (f1 + 2 * f2 + 2 * f3 + f4)

    m, m2 = mask, mask[..., None]
    return state.replace(
        pos=torch.where(m2, new[..., 0:2], state.pos),
        heading=torch.where(m, new[..., 2], state.heading),
        speed=torch.where(m, new[..., 3], state.speed),
        lateral_speed=torch.where(m, new[..., 4], state.lateral_speed),
        yaw_rate=torch.where(m, new[..., 5], state.yaw_rate),
    )
