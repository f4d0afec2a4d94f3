"""Time-to-collision grid observation over a batch of envs.

PyTorch counterpart of ``highwayenv_tpu/observations/ttc.py`` (reference
envs/common/finite_mdp.py ``compute_ttc_grid`` and
envs/common/observation.py ``TimeToCollisionObservation``).  For each
candidate ego speed, each other vehicle's time to collision (at the
centres and at either end) lands in its floor and ceil time cells of a
SPEED x LANE x TIME grid, a max over vehicles written as one
``scatter_reduce("amax")`` over the batch; the observation is the 3 x 3
(speed, lane) window around the ego, edge-padded.
"""

from __future__ import annotations

import numpy as np
import torch

from highwayenv_tpu_torch.road import lane as lane_ops
from highwayenv_tpu_torch.road.lane import LaneGeometry
from highwayenv_tpu_torch.utils.math import not_zero
from highwayenv_tpu_torch.vehicle.state import VehicleState

#: (margin sign, cell value): the centres, then the rear and front ends
_MARGINS = ((0.0, 1.0), (-1.0, 0.5), (1.0, 0.5))


def compute_ttc_grid(
    geo: LaneGeometry,
    state: VehicleState,
    ego: int,
    target_speeds: torch.Tensor,
    connected3: torch.Tensor,
    n_grid_lanes: int,
    time_quantization: float,
    horizon: float,
) -> torch.Tensor:
    """TTC grid (B, S, Lg, T) of controlled slot ``ego``.

    ``target_speeds`` (S,) float32 and ``connected3`` (the (L, L) bool
    ``RoadNetworkBuilder.connectivity_matrix(depth=3)``) on the state's
    device.  A vehicle on an edge with the ego's lane count spreads over
    its own lane id, any other over every grid lane; T is
    ``int(horizon / time_quantization)``."""
    S, Lg = target_speeds.shape[0], n_grid_lanes
    T = int(horizon / time_quantization)
    B, V = state.kind.shape
    dev = state.speed.device

    ego_lane = state.lane[:, ego]
    ego_head = state.heading[:, ego]
    # signed gaps on the ego's current lane (vehicle.lane_distance_to)
    s_all, _ = lane_ops.local_coordinates(geo, ego_lane[:, None], state.pos)
    dist0 = s_all - s_all[:, ego : ego + 1]
    proj_speed = state.speed * (
        torch.cos(state.heading) * torch.cos(ego_head)[:, None]
        + torch.sin(state.heading) * torch.sin(ego_head)[:, None]
    )

    li = lane_ops._gather(geo, state.lane)
    eli = lane_ops._gather(geo, ego_lane)
    same_count = geo.edge_n[li] == geo.edge_n[eli][:, None]
    # one-hot of the lane id, all zeros past the grid (jax.nn.one_hot)
    own = geo.lane_id[li][..., None] == torch.arange(Lg, device=dev)
    lane_mask = own | ~same_count[..., None]  # (B, V, Lg)

    n = connected3.shape[0]
    connected = connected3[ego_lane.clamp(0, n - 1).long()[:, None],
                           state.lane.clamp(0, n - 1).long()]
    not_ego = torch.arange(V, device=dev) != ego
    valid = state.is_vehicle & not_ego & connected  # (B, V)

    margin = state.length[:, ego : ego + 1] / 2 + state.length / 2
    rel = target_speeds[None, :, None] - proj_speed[:, None, :]  # (B, S, V)
    # the reference skips exactly equal speeds (finite_mdp.py)
    speed_ok = valid[:, None, :] & (rel != 0.0)
    rel = not_zero(rel)
    into = lane_mask[:, None].expand(B, S, V, Lg)
    grid = torch.zeros((B, S, Lg, T), dtype=torch.float32, device=dev)
    for m_sign, cost in _MARGINS:
        ttc = (dist0 + m_sign * margin)[:, None, :] / rel
        ok = speed_ok & (ttc >= 0.0)
        q = ttc / time_quantization
        for t_idx in (torch.floor(q), torch.ceil(q)):
            t_ok = ok & (t_idx >= 0) & (t_idx < T)
            value = torch.where(t_ok[..., None] & into, cost, 0.0)  # (B, S, V, Lg)
            cell = t_idx.clamp(0, T - 1).long()[..., None].expand(B, S, V, Lg)
            grid.scatter_reduce_(
                3, cell.transpose(2, 3), value.transpose(2, 3), "amax"
            )
    return grid


def _window(x: torch.Tensor, start: torch.Tensor, dim: int) -> torch.Tensor:
    """Three entries of ``x`` along ``dim`` from each row's ``start`` (B,),
    clamped so they fit, as ``jax.lax.dynamic_slice`` clamps."""
    start = start.clamp(0, x.shape[dim] - 3).long()
    idx = start[:, None] + torch.arange(3, device=x.device)
    idx = idx.view((x.shape[0],) + (1,) * (dim - 1) + (3,)
                   + (1,) * (x.dim() - dim - 1))
    return torch.gather(x, dim, idx.expand(x.shape[:dim] + (3,) + x.shape[dim + 1:]))


def ttc_window(grid: torch.Tensor, lane_id: torch.Tensor,
               speed_index: torch.Tensor) -> torch.Tensor:
    """The (B, 3, 3, T) window of a (B, S, Lg, T) grid around the ego's
    lane id and speed index: lanes padded with ones, speeds with the edge
    rows (reference observation.py ``TimeToCollisionObservation.observe``)."""
    S, Lg = grid.shape[1], grid.shape[2]
    pad = torch.ones_like(grid)
    lanes3 = _window(torch.cat([pad, grid, pad], dim=2), Lg + lane_id - 1, 2)
    first = lanes3[:, :1].expand(-1, S, -1, -1)
    last = lanes3[:, -1:].expand(-1, S, -1, -1)
    return _window(torch.cat([first, lanes3, last], dim=1), S + speed_index - 1, 1)


class TimeToCollisionObservation:
    """Config-compatible with the reference TimeToCollisionObservation."""

    def __init__(self, env, horizon: int = 10, **kwargs):
        self.env = env
        self.horizon = horizon
        #: (target speeds, connectivity matrix) on env.device, copied there
        #: at the first observe, a reset's, so a captured step copies none
        self._tables = None

    @property
    def shape(self):
        return (3, 3, int(self.horizon * self.env.config["policy_frequency"]))

    def space(self):
        from gymnasium import spaces

        return spaces.Box(shape=self.shape, low=0, high=1, dtype=np.float32)

    def observe(self, geo: LaneGeometry, state: VehicleState, ego: int):
        """(B, 3, 3, T) float32."""
        env = self.env
        if self._tables is None:
            self._tables = (
                torch.as_tensor(np.asarray(env.action_type.target_speeds, np.float32),
                                device=env.device),
                torch.as_tensor(env.connected3, device=env.device),
            )
        speeds, connected = self._tables
        # the lane axis is the ego edge's width, which the env pins
        # (PARITY #13)
        Lg = getattr(env, "ttc_grid_lanes", env.max_edge_lanes)
        grid = compute_ttc_grid(
            geo, state, ego, speeds, connected, Lg,
            time_quantization=1.0 / env.config["policy_frequency"],
            horizon=float(self.horizon),
        )
        lane_id = geo.lane_id[lane_ops._gather(geo, state.lane[:, ego])]
        return ttc_window(grid, lane_id, state.speed_index[:, ego])
