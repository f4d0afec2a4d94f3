"""Lidar observation over a batch of envs: (cells, 2) ray distances and
radial velocities.

PyTorch counterpart of ``highwayenv_tpu/observations/lidar.py`` (reference
envs/common/observation.py ``LidarObservation`` and
``utils.distance_to_rect``).  The reference writes the grid obstacle by
obstacle; here every (env, obstacle, cell) candidate is one (B, V, cells)
tensor, reduced by the minimum distance.  Each reference write fires when
the distance is at most the cell's, so a cell keeps the minimum distance
and, on ties, the velocity of the latest slot.  Obstacles are the ``solid``
rows other than the ego within range; the candidate of a row is the smaller
of its centre's distance (in the centre's cell) and the ray's distance to
its rectangle (in the cells its corners span).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from highwayenv_tpu_torch.road.lane import LaneGeometry
from highwayenv_tpu_torch.utils.math import rect_corners
from highwayenv_tpu_torch.vehicle.state import VehicleState


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1])


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def _interval_distance(la, ha, lb, hb):
    return torch.where(la < lb, lb - ha, la - hb)


class LidarObservation:
    """Config-compatible with the reference LidarObservation."""

    DISTANCE = 0
    SPEED = 1

    def __init__(self, cells: int = 16, maximum_range: float = 60.0,
                 normalize: bool = True, **kwargs):
        self.cells = cells
        self.maximum_range = float(maximum_range)
        self.normalize = normalize
        self.angle = 2 * np.pi / cells
        #: (cos, sin) of each cell's ray, (cells, 2), on the device of use
        self._dirs: dict = {}

    @property
    def shape(self):
        return (self.cells, 2)

    def space(self):
        from gymnasium import spaces

        high = 1.0 if self.normalize else self.maximum_range
        return spaces.Box(shape=self.shape, low=-high, high=high, dtype=np.float32)

    def _directions(self, device) -> torch.Tensor:
        """The rays' unit vectors at angles k * angle, formed in float32 as
        the JAX package forms them, copied to ``device`` once."""
        key = str(device)
        if key not in self._dirs:
            a = torch.arange(self.cells, dtype=torch.float32) * torch.tensor(
                self.angle, dtype=torch.float32)
            self._dirs[key] = torch.stack([torch.cos(a), torch.sin(a)], dim=-1).to(device)
        return self._dirs[key]

    def _cell(self, angle: torch.Tensor) -> torch.Tensor:
        """The cell index of a ray angle shifted by half a cell, not wrapped."""
        return torch.floor(angle / self.angle).to(torch.int32)

    def observe(self, geo: LaneGeometry, state: VehicleState, ego: int) -> torch.Tensor:
        """Observation of controlled slot ``ego``: (B, cells, 2) float32."""
        K, rng, half = self.cells, self.maximum_range, self.angle / 2
        B, V = state.kind.shape
        dev = state.pos.device
        dirs = self._directions(dev)  # (K, 2)
        k = torch.arange(K, device=dev)
        origin = state.pos[:, ego]  # (B, 2)
        vel = state.velocity  # (B, V, 2)

        delta = state.pos - origin[:, None]
        center_dist = _norm(delta)  # (B, V)
        not_ego = torch.arange(V, device=dev) != ego
        elig = state.solid & not_ego & (center_dist <= rng)

        rel_vel = vel - vel[:, ego : ego + 1]
        vel_k = (rel_vel[..., 0, None] * dirs[:, 0]
                 + rel_vel[..., 1, None] * dirs[:, 1])  # (B, V, K)

        # the centre's write
        center_index = torch.remainder(
            self._cell(torch.atan2(delta[..., 1], delta[..., 0]) + half), K)
        d_center = torch.where(
            (k == center_index[..., None]) & elig[..., None],
            (center_dist - state.width / 2)[..., None], math.inf)

        # the sector the rectangle's corners span
        corners = rect_corners(state.pos, state.length, state.width, state.heading)
        dc = corners - origin[:, None, None]
        ang = torch.atan2(dc[..., 1], dc[..., 0]) + half  # (B, V, 4)
        amin, amax = ang.min(dim=-1).values, ang.max(dim=-1).values
        wrap = (amin < -np.pi / 2) & (np.pi / 2 < amax)
        lo = torch.where(wrap, amax, amin)
        hi = torch.where(wrap, amin + 2 * np.pi, amax)
        start = torch.remainder(self._cell(lo), K)[..., None]
        end = torch.remainder(self._cell(hi), K)[..., None]
        in_sector = torch.where(
            start <= end, (k >= start) & (k <= end), (k >= start) | (k <= end)
        ) & elig[..., None]

        # the rays' distances to the rectangles (utils.distance_to_rect)
        a, b, d4 = corners[..., 0, :], corners[..., 1, :], corners[..., 3, :]
        u, v = b - a, d4 - a
        u = u / _norm(u)[..., None]
        v = v / _norm(v)[..., None]
        q_minus_r = rng * dirs  # (K, 2)
        rqu = u[..., 0, None] * q_minus_r[:, 0] + u[..., 1, None] * q_minus_r[:, 1]
        rqv = v[..., 0, None] * q_minus_r[:, 0] + v[..., 1, None] * q_minus_r[:, 1]
        ar, br, dr = (x - origin[:, None] for x in (a, b, d4))

        def div(x, y):
            return x[..., None] / torch.where(y == 0.0, 1e-12, y)

        i1_a, i1_b = div(_dot(ar, u), rqu), div(_dot(br, u), rqu)
        i2_a, i2_b = div(_dot(ar, v), rqv), div(_dot(dr, v), rqv)
        lo1 = torch.where(rqu >= 0, i1_a, i1_b)
        hi1 = torch.where(rqu >= 0, i1_b, i1_a)
        lo2 = torch.where(rqv >= 0, i2_a, i2_b)
        hi2 = torch.where(rqv >= 0, i2_b, i2_a)
        hit = (
            (_interval_distance(lo1, hi1, lo2, hi2) <= 0)
            & (_interval_distance(0.0, 1.0, lo1, hi1) <= 0)
            & (_interval_distance(0.0, 1.0, lo2, hi2) <= 0)
        )
        d_ray = torch.where(hit & in_sector, torch.maximum(lo1, lo2) * rng, math.inf)

        # each row's candidate, reduced over the rows: the minimum, ties to
        # the latest slot
        d_cand = torch.minimum(d_center, d_ray)
        d_cand = torch.where(d_cand <= rng, d_cand, math.inf)
        d_min = d_cand.min(dim=1).values  # (B, K)
        slots = torch.arange(V, device=dev)[:, None]
        winner = torch.where(d_cand == d_min[:, None], slots, -1).argmax(dim=1)
        written = torch.isfinite(d_min)
        vel_out = torch.where(written, torch.gather(vel_k, 1, winner[:, None])[:, 0], rng)
        dist_out = torch.where(written, d_min, rng)
        obs = torch.stack([dist_out, vel_out], dim=-1)
        return obs / rng if self.normalize else obs
