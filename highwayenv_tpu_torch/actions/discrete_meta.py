"""DiscreteMetaAction: lane-change / cruise set-point meta actions.

PyTorch counterpart of ``highwayenv_tpu/actions/discrete_meta.py``
(reference envs/common/action.py ``DiscreteMetaAction``).  The target
updates live in vehicle/controller.py; this module carries the config
surface, the action table and the available-action mask.
"""

from __future__ import annotations

import numpy as np
import torch

from highwayenv_tpu_torch.road import lane as lane_ops
from highwayenv_tpu_torch.vehicle import controller
from highwayenv_tpu_torch.vehicle.state import VehicleState

ACTIONS_ALL = {0: "LANE_LEFT", 1: "IDLE", 2: "LANE_RIGHT", 3: "FASTER", 4: "SLOWER"}
ACTIONS_LONGI = {0: "SLOWER", 1: "IDLE", 2: "FASTER"}
ACTIONS_LAT = {0: "LANE_LEFT", 1: "IDLE", 2: "LANE_RIGHT"}


class DiscreteMetaAction:
    #: the frames steer and accelerate the egos by the P-cascade toward the
    #: meta-action's targets (a ContinuousAction's egos keep stored commands)
    stores_raw_controls = False
    #: one int32 action an env, no trailing shape
    action_shape = ()

    def __init__(
        self,
        longitudinal: bool = True,
        lateral: bool = True,
        target_speeds=None,
        **kwargs,
    ):
        self.longitudinal = longitudinal
        self.lateral = lateral
        self.target_speeds = (
            np.asarray(target_speeds)
            if target_speeds is not None
            else controller.DEFAULT_TARGET_SPEEDS
        )
        if longitudinal and lateral:
            self.actions = ACTIONS_ALL
        elif longitudinal:
            self.actions = ACTIONS_LONGI
        elif lateral:
            self.actions = ACTIONS_LAT
        else:
            raise ValueError(
                "At least longitudinal or lateral actions must be included"
            )
        self.actions_indexes = {v: k for k, v in self.actions.items()}
        self._speed_tables: dict = {}

    @property
    def n(self) -> int:
        return len(self.actions)

    def space(self):
        from gymnasium import spaces

        return spaces.Discrete(self.n)

    def speed_table(self, device) -> torch.Tensor:
        """``target_speeds`` as a float32 tensor on ``device``, copied there
        once: a step copies no host data, so a CUDA graph can capture it."""
        key = str(torch.device(device))
        if key not in self._speed_tables:
            self._speed_tables[key] = torch.as_tensor(
                np.asarray(self.target_speeds, np.float32), device=device
            )
        return self._speed_tables[key]

    def apply(self, geo, state: VehicleState, ego_mask, action):
        """Update the masked controlled vehicles' targets from the action."""
        return controller.apply_meta_action(geo, state, ego_mask, action, self)

    def available_actions_mask(self, geo, state: VehicleState, ego: int):
        """(B, n) bool mask of the currently available actions (reference
        envs/common/action.py ``get_available_actions``)."""
        li = lane_ops._gather(geo, state.lane[:, ego])
        lane_id, base, n_edge = geo.lane_id[li], geo.edge_base[li], geo.edge_n[li]
        pos = state.pos[:, ego]

        def reachable(cand_id):
            ok = (cand_id >= 0) & (cand_id < n_edge)
            cand = (base + cand_id).clamp(0, geo.num_lanes - 1)
            return ok & lane_ops.is_reachable_from(geo, cand, pos) & self.lateral

        idle = torch.ones_like(li, dtype=torch.bool)
        left = reachable(lane_id - 1)
        right = reachable(lane_id + 1)
        n_speeds = len(self.target_speeds)
        faster = (state.speed_index[:, ego] < n_speeds - 1) & self.longitudinal
        slower = (state.speed_index[:, ego] > 0) & self.longitudinal
        if self.longitudinal and self.lateral:
            cols = [left, idle, right, faster, slower]
        elif self.longitudinal:
            cols = [slower, idle, faster]
        else:
            cols = [left, idle, right]
        return torch.stack(cols, dim=-1)
