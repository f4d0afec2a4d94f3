"""IDM longitudinal model and the MOBIL constants of the NPC policy.

PyTorch counterpart of the pieces of ``highwayenv_tpu/vehicle/behavior.py``
that the straight-road frame uses (reference vehicle/behavior.py):

  - IDM:   a = a_c [1 - (v/v0)^delta - (d*/d)^2],
           d* = d0 + vT + v dv / (2 sqrt(ab))
  - MOBIL: safety (imposed braking >= -max_braking) + incentive
           (jerk >= gain), abort-on-conflict, timer gating; the decision
           itself lives in ops/straight_frames.py.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from highwayenv_tpu_torch.utils.math import not_zero


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


def idm_acceleration(
    p: IDMParams, speed_limit: float, delta,
    ego_speed, ego_target_speed, ego_s, ego_cos, ego_sin,
    front_s, front_vx, front_vy, front_exists,
):
    """IDM acceleration of an ego row behind a front row.

    ``delta`` is the deciding vehicle's exponent even when the ego row is a
    neighbour (the reference evaluates ``self.DELTA``).  Rows are tensors of
    one shape; ``front_exists`` masks the interaction term.
    """
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
    return free - torch.where(front_exists, interaction, 0.0)
