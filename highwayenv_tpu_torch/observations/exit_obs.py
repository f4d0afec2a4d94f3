"""ExitObservation: Kinematics with the ego's ``x`` replaced by its
longitudinal coordinate on the exit lane.

PyTorch counterpart of ``highwayenv_tpu/observations/exit_obs.py``
(reference envs/common/observation.py ``ExitObservation``).  The other
rows still subtract the ego's world position: the reference's
``to_dict(origin)`` reads the unmodified observer.
"""

from __future__ import annotations

import torch

from highwayenv_tpu_torch.observations.kinematics import KinematicsObservation
from highwayenv_tpu_torch.road import lane as lane_ops


class ExitObservation(KinematicsObservation):
    def __init__(self, exit_lane: int, **kwargs):
        super().__init__(**kwargs)
        self.exit_lane = int(exit_lane)

    def _ego_row(self, geo, state, ego, ego_row):
        pos = state.pos[:, ego]
        lane = torch.full(pos.shape[:1], self.exit_lane, dtype=torch.int32,
                          device=pos.device)
        s, _lat = lane_ops.local_coordinates(geo, lane, pos)
        xi = self.features.index("x")
        return torch.cat([ego_row[:, :xi], s[:, None], ego_row[:, xi + 1:]], dim=1)
