"""KinematicsGoal observation: the ego's and its goal's feature rows, as a dict.

PyTorch counterpart of ``highwayenv_tpu/observations/kinematics_goal.py``
(reference envs/common/observation.py ``KinematicsGoalObservation``), for
goal-reaching tasks (parking, HER): the ego's Vehicle.to_dict feature row
and its goal landmark's, each divided by per-feature scales.  ``observe``
returns a dict of three (B, F) float32 tensors: ``observation``,
``achieved_goal`` (the same row) and ``desired_goal``.
"""

from __future__ import annotations

import numpy as np
import torch

from highwayenv_tpu_torch.vehicle.state import VehicleState

#: the Vehicle.to_dict features a row can hold
ROW_FEATURES = ("presence", "x", "y", "vx", "vy", "heading", "cos_h", "sin_h")


class KinematicsGoalObservation:
    def __init__(
        self,
        env,
        scales,
        features=("x", "y", "vx", "vy", "cos_h", "sin_h"),
        **kwargs,
    ):
        self.env = env
        self.scales = np.asarray(scales, np.float32)
        self.features = tuple(features)
        unknown = [f for f in self.features if f not in ROW_FEATURES]
        if unknown or len(self.scales) != len(self.features):
            raise ValueError(f"KinematicsGoal: features {self.features} (unknown "
                             f"{unknown}) and {len(self.scales)} scales")
        self._scales: dict = {}

    def space(self):
        from gymnasium import spaces

        F = len(self.features)

        def box():
            return spaces.Box(-np.inf, np.inf, shape=(F,), dtype=np.float32)

        return spaces.Dict(
            dict(desired_goal=box(), achieved_goal=box(), observation=box())
        )

    def _scale(self, device) -> torch.Tensor:
        """(F,) scales on ``device``, copied there once (a step copies no
        host data)."""
        key = str(device)
        if key not in self._scales:
            self._scales[key] = torch.as_tensor(self.scales, device=device)
        return self._scales[key]

    def _row(self, state: VehicleState, slot: int) -> torch.Tensor:
        """(B, F) Vehicle.to_dict feature row of ``slot`` (reference
        vehicle/kinematics.py ``to_dict``); objects report zero velocity."""
        pos = state.pos[:, slot]
        heading = state.heading[:, slot]
        speed = torch.where(state.is_vehicle[:, slot], state.speed[:, slot], 0.0)
        cols = {
            "presence": torch.ones_like(heading),
            "x": pos[:, 0],
            "y": pos[:, 1],
            "vx": speed * torch.cos(heading),
            "vy": speed * torch.sin(heading),
            "heading": heading,
            "cos_h": torch.cos(heading),
            "sin_h": torch.sin(heading),
        }
        return torch.stack([cols[f] for f in self.features], dim=-1)

    def scaled_row(self, state: VehicleState, slot: int) -> torch.Tensor:
        """``_row`` divided by the scales."""
        return self._row(state, slot) / self._scale(state.pos.device)

    def observe(self, geo, state: VehicleState, ego: int) -> dict[str, torch.Tensor]:
        obs = self.scaled_row(state, ego)
        return {
            "observation": obs,
            "achieved_goal": obs.clone(),
            "desired_goal": self.scaled_row(state, self.env.goal_slot_of(ego)),
        }
