"""Vehicle / road-object state as a structure of tensors.

PyTorch counterpart of ``highwayenv_tpu/vehicle/state.py``: one fixed-size
padded structure of arrays with the same field names and dtypes.  Every
tensor has leading dims (B, V): B envs, V slots.  Stepping vehicles occupy
the low slots, padding the high ones, so the lower index of a pair is the
reference's ``self`` in the collision loop.
"""

from __future__ import annotations

import dataclasses

import torch

# kind enum
KIND_PAD = 0  # inactive slot
KIND_EGO = 1  # ControlledVehicle / MDPVehicle (externally actioned)
KIND_IDM = 2  # IDMVehicle NPC
KIND_LINEAR = 3  # LinearVehicle NPC
KIND_PLAIN = 4  # plain Vehicle (constant stored action)
KIND_OBSTACLE = 5
KIND_LANDMARK = 6  # non-solid

# Vehicle constants (reference vehicle/kinematics.py)
VEHICLE_LENGTH = 5.0
VEHICLE_WIDTH = 2.0
# RoadObject size of obstacles (reference vehicle/objects.py)
OBJECT_LENGTH = 2.0
OBJECT_WIDTH = 2.0
MAX_SPEED = 40.0
MIN_SPEED = -40.0


@dataclasses.dataclass
class VehicleState:
    """All tensors share leading dims (B, V)."""

    pos: torch.Tensor  # (B,V,2) f32
    heading: torch.Tensor  # (B,V) f32
    speed: torch.Tensor  # (B,V) f32
    lane: torch.Tensor  # (B,V) i32  current closest lane (global id)
    target_lane: torch.Tensor  # (B,V) i32
    target_speed: torch.Tensor  # (B,V) f32
    speed_index: torch.Tensor  # (B,V) i32  (MDP ego)
    timer: torch.Tensor  # (B,V) f32  MOBIL gating timer
    delta: torch.Tensor  # (B,V) f32  per-vehicle IDM exponent
    accel: torch.Tensor  # (B,V) f32  stored longitudinal action
    steering: torch.Tensor  # (B,V) f32  stored steering action
    crashed: torch.Tensor  # (B,V) bool
    hit: torch.Tensor  # (B,V) bool
    impact: torch.Tensor  # (B,V,2) f32  pending post-collision translation
    impact_pending: torch.Tensor  # (B,V) bool
    kind: torch.Tensor  # (B,V) i32 enum above
    length: torch.Tensor  # (B,V) f32
    width: torch.Tensor  # (B,V) f32
    check_collisions: torch.Tensor  # (B,V) bool
    collidable: torch.Tensor  # (B,V) bool
    enable_lane_change: torch.Tensor  # (B,V) bool
    is_yielding: torch.Tensor  # (B,V) bool
    yield_timer: torch.Tensor  # (B,V) i32
    lateral_speed: torch.Tensor  # (B,V) f32
    yaw_rate: torch.Tensor  # (B,V) f32
    accel_params: torch.Tensor  # (B,V,3) f32
    steer_params: torch.Tensor  # (B,V,2) f32
    mobil_gain: torch.Tensor  # (B,V) f32
    mobil_max_braking: torch.Tensor  # (B,V) f32
    route_base: torch.Tensor  # (B,V,R) i32, -1 pad
    route_n: torch.Tensor  # (B,V,R) i32
    route_id: torch.Tensor  # (B,V,R) i32
    route_ptr: torch.Tensor  # (B,V) i32
    route_len: torch.Tensor  # (B,V) i32

    def replace(self, **changes) -> "VehicleState":
        return dataclasses.replace(self, **changes)

    @property
    def num_slots(self) -> int:
        return self.kind.shape[-1]

    @property
    def active(self) -> torch.Tensor:
        return self.kind != KIND_PAD

    @property
    def is_vehicle(self) -> torch.Tensor:
        return (self.kind >= KIND_EGO) & (self.kind <= KIND_PLAIN)

    @property
    def is_controlled(self) -> torch.Tensor:
        return (self.kind >= KIND_EGO) & (self.kind <= KIND_LINEAR)

    @property
    def solid(self) -> torch.Tensor:
        return self.active & (self.kind != KIND_LANDMARK)

    @property
    def velocity(self) -> torch.Tensor:
        return self.speed[..., None] * torch.stack(
            [torch.cos(self.heading), torch.sin(self.heading)], dim=-1
        )

    @property
    def diagonal(self) -> torch.Tensor:
        return torch.sqrt(self.length**2 + self.width**2)


def empty_state(
    batch: int, num_slots: int, route_slots: int = 1, device=None
) -> VehicleState:
    """An all-padding state of B envs with V slots each."""
    B, V, R = batch, num_slots, route_slots
    f32, i32 = torch.float32, torch.int32

    def full(shape, value, dtype):
        return torch.full((B, V) + shape, value, dtype=dtype, device=device)

    def columns(values):
        # filled column by column: no host data is copied to the device
        out = torch.empty((B, V, len(values)), dtype=f32, device=device)
        for k, value in enumerate(values):
            out[..., k] = value
        return out

    return VehicleState(
        pos=full((2,), 0.0, f32),
        heading=full((), 0.0, f32),
        speed=full((), 0.0, f32),
        lane=full((), 0, i32),
        target_lane=full((), 0, i32),
        target_speed=full((), 0.0, f32),
        speed_index=full((), 0, i32),
        timer=full((), 0.0, f32),
        delta=full((), 4.0, f32),
        accel=full((), 0.0, f32),
        steering=full((), 0.0, f32),
        crashed=full((), False, torch.bool),
        hit=full((), False, torch.bool),
        impact=full((2,), 0.0, f32),
        impact_pending=full((), False, torch.bool),
        kind=full((), KIND_PAD, i32),
        length=full((), VEHICLE_LENGTH, f32),
        width=full((), VEHICLE_WIDTH, f32),
        check_collisions=full((), True, torch.bool),
        collidable=full((), True, torch.bool),
        enable_lane_change=full((), True, torch.bool),
        is_yielding=full((), False, torch.bool),
        yield_timer=full((), 0, i32),
        lateral_speed=full((), 0.0, f32),
        yaw_rate=full((), 0.0, f32),
        accel_params=columns((0.3, 0.3, 2.0)),
        steer_params=columns((5.0, 5.0 / 0.6)),
        mobil_gain=full((), 0.2, f32),
        mobil_max_braking=full((), 2.0, f32),
        route_base=full((R,), -1, i32),
        route_n=full((R,), 0, i32),
        route_id=full((R,), -1, i32),
        route_ptr=full((), 0, i32),
        route_len=full((), 0, i32),
    )
