"""Occupancy-grid observation over a batch of envs.

PyTorch counterpart of ``highwayenv_tpu/observations/occupancy_grid.py``
(reference envs/common/observation.py ``OccupancyGridObservation``):

  - vehicle feature layers: each vehicle's cell (optionally rotated into the
    ego's frame), the first vehicle in slot order winning a shared cell (the
    reference fills rows in reverse so that the earliest row ends on top),
    as a scatter of the slot index with ``amin`` and a gather of the
    winner's features;
  - the ``on_road`` layer: the reference's lane-waypoint rasterization
    (``fill_road_layer_by_lanes``), waypoints every ``min(grid_step)``
    metres within ``LANE_PERCEPTION_DISTANCE`` of the ego's station on every
    lane, as a scatter of ones into a (B, W * H + 1) grid whose last column
    takes the waypoints outside it.  Every write is 1, so the scatter is
    exact in any order; the JAX package compares a one-hot against the whole
    grid, which at B=4096 and 27 lanes of 67 waypoints would be about 1 GB a
    step.

``absolute=True`` raises, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from highwayenv_tpu_torch.road import lane as lane_ops
from highwayenv_tpu_torch.road.lane import LaneGeometry
from highwayenv_tpu_torch.utils.math import lmap
from highwayenv_tpu_torch.vehicle.state import MAX_SPEED, VehicleState

DEFAULT_FEATURES = ("presence", "vx", "vy", "on_road")
DEFAULT_GRID_SIZE = ((-5.5 * 5, 5.5 * 5), (-5.5 * 5, 5.5 * 5))
DEFAULT_GRID_STEP = (5, 5)
LANE_PERCEPTION_DISTANCE = 100.0


class OccupancyGridObservation:
    def __init__(
        self,
        features=None,
        grid_size=None,
        grid_step=None,
        features_range: dict | None = None,
        absolute: bool = False,
        align_to_vehicle_axes: bool = False,
        clip: bool = True,
        as_image: bool = False,
        **kwargs,
    ):
        if absolute:
            raise NotImplementedError("absolute occupancy grid (reference parity)")
        self.features = tuple(features) if features else DEFAULT_FEATURES
        self.grid_size = np.asarray(
            grid_size if grid_size is not None else DEFAULT_GRID_SIZE, np.float32
        )
        self.grid_step = np.asarray(
            grid_step if grid_step is not None else DEFAULT_GRID_STEP, np.float32
        )
        self.grid_shape = tuple(
            int(n) for n in np.floor(
                (self.grid_size[:, 1] - self.grid_size[:, 0]) / self.grid_step
            ).astype(int)
        )
        self.features_range = features_range or {
            "vx": [-2 * MAX_SPEED, 2 * MAX_SPEED],
            "vy": [-2 * MAX_SPEED, 2 * MAX_SPEED],
        }
        self.align_to_vehicle_axes = align_to_vehicle_axes
        self.clip = clip
        self.as_image = as_image

    @property
    def shape(self):
        return (len(self.features),) + self.grid_shape

    def space(self):
        from gymnasium import spaces

        if self.as_image:
            return spaces.Box(shape=self.shape, low=0, high=255, dtype=np.uint8)
        return spaces.Box(shape=self.shape, low=-np.inf, high=np.inf, dtype=np.float32)

    # ------------------------------------------------------------------ #
    def _flat_cell(self, rel_x, rel_y, ego_heading, valid=None):
        """Reference ``pos_to_index``: the flat cell ``ci * H + cj`` of
        relative positions, ``W * H`` outside the grid (or where ``valid``
        is False).  ``ego_heading`` broadcasts against ``rel_x``."""
        W, H = self.grid_shape
        if self.align_to_vehicle_axes:
            c, s = torch.cos(ego_heading), torch.sin(ego_heading)
            x = c * rel_x + s * rel_y
            y = -s * rel_x + c * rel_y
        else:
            x, y = rel_x, rel_y
        ci = torch.floor((x - float(self.grid_size[0, 0])) / float(self.grid_step[0]))
        cj = torch.floor((y - float(self.grid_size[1, 0])) / float(self.grid_step[1]))
        ci, cj = ci.to(torch.int32), cj.to(torch.int32)
        ok = (0 <= ci) & (ci < W) & (0 <= cj) & (cj < H)
        if valid is not None:
            ok = ok & valid
        return torch.where(ok, ci * H + cj, W * H).long()

    def observe(self, geo: LaneGeometry, state: VehicleState, ego: int) -> torch.Tensor:
        """(B, F, W, H) float32, or uint8 with ``as_image``."""
        W, H = self.grid_shape
        B, V = state.kind.shape
        dev = state.speed.device
        ego_pos = state.pos[:, ego]
        ego_head = state.heading[:, ego]

        # relative features (reference to_dict(origin))
        rel_pos = state.pos - ego_pos[:, None, :]
        vel = state.velocity
        rel_vel = vel - vel[:, ego][:, None, :]
        cols = {
            "presence": torch.ones_like(state.speed),
            "x": rel_pos[..., 0],
            "y": rel_pos[..., 1],
            "vx": rel_vel[..., 0],
            "vy": rel_vel[..., 1],
        }
        for f, rng in self.features_range.items():
            if f in cols:
                cols[f] = lmap(cols[f], (rng[0], rng[1]), (-1.0, 1.0))

        # each vehicle's cell from the unnormalized relative position; the
        # lowest slot of a cell wins it
        flat = self._flat_cell(
            rel_pos[..., 0], rel_pos[..., 1], ego_head[:, None], state.is_vehicle
        )
        slots = torch.arange(V, device=dev).expand(B, V)
        first = torch.full((B, W * H + 1), V, dtype=torch.long, device=dev)
        first = first.scatter_reduce(1, flat, slots, reduce="amin")[:, : W * H]
        occupied = first < V
        winner = first.clamp(max=V - 1)

        layers = []
        for f in self.features:
            if f == "on_road":
                layers.append(self._road_layer(geo, state, ego))
                continue
            cell_vals = torch.gather(cols[f], 1, winner)
            layer = torch.where(occupied, cell_vals, 0.0)
            layers.append(layer.reshape(B, W, H))
        obs = torch.stack(layers, dim=1)
        if self.clip:
            obs = obs.clamp(-1.0, 1.0)
        if self.as_image:
            return ((obs.clamp(-1.0, 1.0) + 1.0) / 2.0 * 255).to(torch.uint8)
        return obs.to(torch.float32)

    def _road_layer(self, geo: LaneGeometry, state: VehicleState, ego: int):
        """Reference ``fill_road_layer_by_lanes``: (B, W, H) of 0 / 1."""
        W, H = self.grid_shape
        B = state.kind.shape[0]
        dev = state.speed.device
        ego_pos = state.pos[:, ego]
        ego_head = state.heading[:, ego]
        L = geo.num_lanes
        lanes = torch.arange(L, dtype=torch.int32, device=dev)

        spacing = float(np.amin(self.grid_step))
        n_wp = int(math.ceil(2 * LANE_PERCEPTION_DISTANCE / spacing))
        origin, _ = lane_ops.local_coordinates(geo, lanes, ego_pos[:, None, :])  # (B, L)
        offsets = torch.arange(n_wp, dtype=torch.float32, device=dev) * spacing
        s = origin[..., None] - LANE_PERCEPTION_DISTANCE + offsets  # (B, L, n_wp)
        s = torch.minimum(s.clamp(min=0.0), geo.length[:, None])
        wp = lane_ops.position(geo, lanes[:, None], s, torch.zeros_like(s))
        rel = wp - ego_pos[:, None, None, :]
        flat = self._flat_cell(rel[..., 0], rel[..., 1], ego_head[:, None, None])
        grid = torch.zeros((B, W * H + 1), dtype=torch.float32, device=dev)
        grid.scatter_(1, flat.reshape(B, -1), 1.0)
        return grid[:, : W * H].reshape(B, W, H)
