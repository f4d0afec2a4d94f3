"""Kinematic bicycle integrator over all slots.

PyTorch counterpart of ``highwayenv_tpu/vehicle/kinematics.py`` (reference
``Vehicle.step``/``clip_actions``):

    beta = arctan(0.5 tan(delta_f))
    pos += speed * [cos(h+beta), sin(h+beta)] * dt   (+ pending impact)
    heading += speed * sin(beta) / (LENGTH/2) * dt
    speed += accel * dt

Crashed vehicles get steering=0, accel=-speed; speed is clamped to
[MIN_SPEED, MAX_SPEED] through the acceleration.
"""

from __future__ import annotations

import torch

from highwayenv_tpu_torch.vehicle.state import MAX_SPEED, MIN_SPEED, VehicleState


def clip_actions(state: VehicleState):
    """Reference vehicle/kinematics.py ``clip_actions``."""
    steering = torch.where(state.crashed, 0.0, state.steering)
    accel = torch.where(state.crashed, -1.0 * state.speed, state.accel)
    accel = torch.where(
        state.speed > MAX_SPEED,
        torch.minimum(accel, MAX_SPEED - state.speed),
        torch.where(
            state.speed < MIN_SPEED,
            torch.maximum(accel, MIN_SPEED - state.speed),
            accel,
        ),
    )
    return steering, accel


def integrate(state: VehicleState, dt: float) -> VehicleState:
    """One integration frame for all stepping vehicles (masked on
    is_vehicle); also advances the MOBIL timer."""
    moving = state.is_vehicle
    steering, accel = clip_actions(state)
    beta = torch.atan(0.5 * torch.tan(steering))
    heading_beta = state.heading + beta
    vel = state.speed[..., None] * torch.stack(
        [torch.cos(heading_beta), torch.sin(heading_beta)], dim=-1
    )
    pos = state.pos + vel * dt
    # pending impact from the last frame's collision pass
    pos = pos + torch.where(state.impact_pending[..., None], state.impact, 0.0)
    crashed = state.crashed | (state.impact_pending & moving)
    heading = state.heading + state.speed * torch.sin(beta) / (state.length / 2) * dt
    speed = state.speed + accel * dt
    return state.replace(
        pos=torch.where(moving[..., None], pos, state.pos),
        heading=torch.where(moving, heading, state.heading),
        speed=torch.where(moving, speed, state.speed),
        crashed=torch.where(moving, crashed, state.crashed),
        impact=torch.where(moving[..., None], 0.0, state.impact),
        impact_pending=torch.where(moving, False, state.impact_pending),
        timer=torch.where(moving, state.timer + dt, state.timer),
    )
