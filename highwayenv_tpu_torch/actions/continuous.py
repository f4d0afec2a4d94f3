"""Continuous throttle / steering actions, and their uniform quantization.

PyTorch counterpart of ``highwayenv_tpu/actions/continuous.py`` (reference
envs/common/action.py ``ContinuousAction`` and ``DiscreteAction``): the
agent's [-1, 1] action is clipped, lmapped onto ``acceleration_range`` /
``steering_range`` and stored as the controlled vehicle's low-level command.
The frames then keep it (``stores_raw_controls``): the ego takes no
P-cascade, and the frame kernels run their raw-control branch.

``dynamical=True`` integrates the egos with the BicycleVehicle tire-slip
model of ``vehicle/dynamics.py`` instead of the kinematic bicycle: a flag
the general frames read (``GeneralSpec.dynamical``, the kernels'
``kDynamical`` instantiations); a straight road refuses it at ``make``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from highwayenv_tpu_torch.utils.math import lmap
from highwayenv_tpu_torch.vehicle.state import VehicleState


class ContinuousAction:
    ACCELERATION_RANGE = (-5.0, 5.0)
    STEERING_RANGE = (-math.pi / 4, math.pi / 4)

    #: egos keep their stored (steering, accel) commands; the frame kernels
    #: must not overwrite them with the ControlledVehicle P-cascade
    stores_raw_controls = True

    def __init__(
        self,
        acceleration_range=None,
        steering_range=None,
        speed_range=None,
        longitudinal: bool = True,
        lateral: bool = True,
        dynamical: bool = False,
        clip: bool = True,
        **kwargs,
    ):
        self.acceleration_range = tuple(acceleration_range or self.ACCELERATION_RANGE)
        self.steering_range = tuple(steering_range or self.STEERING_RANGE)
        self.speed_range = tuple(speed_range) if speed_range else None
        self.longitudinal = longitudinal
        self.lateral = lateral
        if not self.lateral and not self.longitudinal:
            raise ValueError("Either longitudinal and/or lateral control must be enabled")
        self.dynamical = dynamical
        self.clip = clip
        self.size = 2 if self.lateral and self.longitudinal else 1

    @property
    def action_shape(self):
        return (self.size,)

    def space(self):
        from gymnasium import spaces

        return spaces.Box(-1.0, 1.0, shape=(self.size,), dtype=np.float32)

    def controls_from_action(self, action: torch.Tensor):
        """action (..., size) in [-1, 1] -> (acceleration, steering)."""
        if self.clip:
            action = torch.clamp(action, -1.0, 1.0)
        if self.longitudinal and self.lateral:
            acc = lmap(action[..., 0], (-1.0, 1.0), self.acceleration_range)
            steer = lmap(action[..., 1], (-1.0, 1.0), self.steering_range)
        elif self.longitudinal:
            acc = lmap(action[..., 0], (-1.0, 1.0), self.acceleration_range)
            steer = torch.zeros_like(acc)
        else:
            steer = lmap(action[..., 0], (-1.0, 1.0), self.steering_range)
            acc = torch.zeros_like(steer)
        return acc, steer

    def _store(self, state: VehicleState, ego_mask, cont) -> VehicleState:
        acc, steer = self.controls_from_action(cont)
        return state.replace(
            accel=torch.where(ego_mask, acc, state.accel),
            steering=torch.where(ego_mask, steer, state.steering),
        )

    def apply(self, geo, state: VehicleState, ego_mask, slot_actions) -> VehicleState:
        """Store the lmapped low-level commands on the masked vehicles.

        slot_actions: (B, V, size) float32."""
        return self._store(state, ego_mask, slot_actions)


class DiscreteAction(ContinuousAction):
    """Uniform quantization of ContinuousAction (reference action.py
    ``DiscreteAction``): ``actions_per_axis`` points a controlled axis."""

    def __init__(self, actions_per_axis: int = 3, **kwargs):
        super().__init__(**kwargs)
        self.actions_per_axis = actions_per_axis
        self._grids: dict = {}

    @property
    def action_shape(self):
        return ()

    @property
    def n(self) -> int:
        """Number of actions (the JAX package reads it from the space)."""
        return self.actions_per_axis ** self.size

    def space(self):
        from gymnasium import spaces

        return spaces.Discrete(self.n)

    def grid(self, device) -> torch.Tensor:
        """The per-axis points ``linspace(-1, 1, actions_per_axis)``,
        rounded once to float32, on ``device``, copied there once (a step
        copies no host data)."""
        key = str(torch.device(device))
        if key not in self._grids:
            self._grids[key] = torch.as_tensor(
                np.linspace(-1.0, 1.0, self.actions_per_axis).astype(np.float32),
                device=device,
            )
        return self._grids[key]

    def apply(self, geo, state, ego_mask, slot_actions):
        """Integer action -> its grid point, row-major over the axes as the
        reference's ``itertools.product`` of the per-axis linspaces orders
        them; slot_actions: (B, V) int."""
        n = self.actions_per_axis
        grid = self.grid(slot_actions.device)
        a = slot_actions.long()
        if self.size == 2:
            cont = torch.stack([grid[a // n], grid[a % n]], dim=-1)
        else:
            cont = grid[a][..., None]
        return self._store(state, ego_mask, cont)
