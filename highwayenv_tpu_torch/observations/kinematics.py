"""Kinematics observation over a batch of envs.

PyTorch counterpart of ``highwayenv_tpu/observations/kinematics.py``
(reference envs/common/observation.py ``KinematicObservation``): the
perception query, the relative features, the stable sort by lane distance,
lmap normalization, clipping and zero padding, as masked gathers over the
padded slot axis.

``order="shuffled"`` permutes the rows after the ego's, one permutation an
env and an observation (shared by the egos of a step), drawn from the
step's ``torch.Generator`` (``BaseEnv._observe``); the JAX package draws it
from its state's key folded with the step count, so the permutations have
the same distribution, not the same bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from highwayenv_tpu_torch.road import lane as lane_ops
from highwayenv_tpu_torch.road.lane import DEFAULT_WIDTH, LaneGeometry
from highwayenv_tpu_torch.utils.math import lmap
from highwayenv_tpu_torch.vehicle.state import MAX_SPEED, VehicleState

DEFAULT_FEATURES = ("presence", "x", "y", "vx", "vy")
SUPPORTED_FEATURES = ("presence", "x", "y", "vx", "vy", "heading", "cos_h", "sin_h",
                      "long_off", "lat_off", "ang_off", "cos_d", "sin_d")
#: the features measured in the frame of each row's current lane
LANE_FEATURES = ("long_off", "lat_off", "ang_off")
PERCEPTION_DISTANCE = 5.0 * MAX_SPEED


class KinematicsObservation:
    """Config-compatible with the reference KinematicObservation for the
    features above, ``order="sorted"`` (any order but ``"shuffled"``) and
    ``order="shuffled"``."""

    def __init__(
        self,
        features=None,
        vehicles_count: int = 5,
        features_range: dict | None = None,
        absolute: bool = False,
        order: str = "sorted",
        normalize: bool = True,
        clip: bool = True,
        see_behind: bool = False,
        observe_intentions: bool = False,
        include_obstacles: bool = True,
        reset_edge_lanes: int | None = None,
        **kwargs,
    ):
        self.features = tuple(features) if features else DEFAULT_FEATURES
        unported = [f for f in self.features if f not in SUPPORTED_FEATURES]
        if unported:
            raise NotImplementedError(
                f"Kinematics features {unported} are not ported yet"
            )
        self.vehicles_count = vehicles_count
        self.features_range = features_range
        self.absolute = absolute
        self.order = order
        self.normalize = normalize
        self.clip = clip
        self.see_behind = see_behind
        self.observe_intentions = observe_intentions
        self.include_obstacles = include_obstacles
        #: lane count of the ego's reset edge: the reference computes the
        #: normalization ranges once per reset and keeps them for the
        #: episode (PARITY #5); None recomputes them from the current lane
        self.reset_edge_lanes = reset_edge_lanes
        self._relative_masks: dict = {}

    @property
    def shape(self):
        return (self.vehicles_count, len(self.features))

    def space(self):
        from gymnasium import spaces

        return spaces.Box(shape=self.shape, low=-np.inf, high=np.inf, dtype=np.float32)

    @property
    def needs_generator(self) -> bool:
        """The shuffled order draws its permutations
        (``BaseEnv._observe``)."""
        return self.order == "shuffled"

    def permutation(self, batch: int, generator, device) -> torch.Tensor | None:
        """(B, N - 1) int64: a uniform permutation of the non-ego rows per
        env, the argsort of uniforms drawn from ``generator``; None where
        there is no row to permute."""
        n = self.vehicles_count - 1
        if n < 1:
            return None
        u = torch.rand((batch, n), generator=generator, device=device)
        return torch.argsort(u, dim=1)

    def _relative(self, device) -> torch.Tensor:
        """(F,) bool: the features taken relative to the ego, on ``device``,
        copied there once (a step copies no host data)."""
        key = str(device)
        if key not in self._relative_masks:
            self._relative_masks[key] = torch.tensor(
                [f in ("x", "y", "vx", "vy") for f in self.features], device=device
            )
        return self._relative_masks[key]

    def _feature_table(self, geo: LaneGeometry, state: VehicleState) -> dict:
        is_vehicle = state.is_vehicle
        cos_h, sin_h = torch.cos(state.heading), torch.sin(state.heading)
        # static objects report zero velocity; the velocity is speed times
        # the heading's direction (a dynamical ego's lateral speed aside), as
        # the JAX package's VehicleState.velocity
        cols = {
            "presence": torch.ones_like(state.speed),
            "x": state.pos[..., 0],
            "y": state.pos[..., 1],
            "vx": torch.where(is_vehicle, state.speed * cos_h, 0.0),
            "vy": torch.where(is_vehicle, state.speed * sin_h, 0.0),
            "heading": state.heading,
            "cos_h": cos_h,
            "sin_h": sin_h,
        }
        if any(f in LANE_FEATURES for f in self.features):
            # the offsets in the frame of each row's current lane
            s, lat = lane_ops.local_coordinates(geo, state.lane, state.pos)
            cols["long_off"] = s
            cols["lat_off"] = lat
            cols["ang_off"] = lane_ops.local_angle(geo, state.lane, state.heading, s)
        if "cos_d" in self.features or "sin_d" in self.features:
            # the unit vector to the end of the last route segment; zero
            # without a route or without observe_intentions
            R = state.route_base.shape[-1]
            last = (state.route_len - 1).clamp(0, R - 1)[..., None].long()
            base = torch.gather(state.route_base, -1, last)[..., 0]
            rid = torch.gather(state.route_id, -1, last)[..., 0]
            lane = (base + rid.clamp(min=0)).clamp(0, geo.num_lanes - 1)
            dest = lane_ops.position(geo, lane, geo.length[lane.long()],
                                     torch.zeros_like(state.speed))
            delta = dest - state.pos
            norm = torch.sqrt(delta[..., 0] * delta[..., 0] + delta[..., 1] * delta[..., 1])
            ok = (state.route_len > 0) & (norm > 0) & bool(self.observe_intentions)
            d = torch.where(ok[..., None],
                            delta / torch.where(norm == 0, 1.0, norm)[..., None], 0.0)
            cols["cos_d"] = d[..., 0]
            cols["sin_d"] = d[..., 1]
        return cols

    def observe(self, geo: LaneGeometry, state: VehicleState, ego: int, perm=None):
        """Observation of controlled slot ``ego``: (B, N, F) float32; with
        ``perm`` ((B, N - 1), ``permutation``) the rows after the ego's in
        that order."""
        B, V = state.kind.shape
        ego_pos = state.pos[:, ego]
        ego_lane = state.lane[:, ego : ego + 1].expand(B, V)

        # lane-projected signed gaps on the ego's current lane
        s_all, _ = lane_ops.local_coordinates(geo, ego_lane, state.pos)
        lane_dist = s_all - s_all[:, ego : ego + 1]
        d = state.pos - ego_pos[:, None]
        dist = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
        not_self = torch.arange(V, device=state.kind.device) != ego
        is_vehicle = state.is_vehicle
        behind_ok = lane_dist > -2 * 5.0  # -2 * ego LENGTH
        near = dist < PERCEPTION_DISTANCE
        veh_ok = is_vehicle & not_self & near & (behind_ok | self.see_behind)
        obj_ok = (
            state.active & ~is_vehicle & near & behind_ok & self.include_obstacles
        )
        ok = veh_ok | obj_ok

        # stable sort by |lane_dist|, invalid rows last
        sort_key = torch.where(ok, lane_dist.abs(), math.inf)
        sel = torch.argsort(sort_key, dim=-1, stable=True)[:, : self.vehicles_count - 1]
        sel_ok = torch.gather(ok, 1, sel)

        cols = self._feature_table(geo, state)
        feats = torch.stack([cols[f] for f in self.features], dim=-1)  # (B,V,F)
        ego_row = feats[:, ego]
        rows = torch.gather(
            feats, 1, sel[..., None].expand(-1, -1, feats.shape[-1])
        )
        if not self.absolute:
            rows = torch.where(
                self._relative(feats.device), rows - ego_row[:, None], rows
            )
        rows = torch.where(sel_ok[..., None], rows, 0.0)
        # the displayed ego row may differ from the world-frame row the
        # others are taken relative to (ExitObservation)
        obs = torch.cat([self._ego_row(geo, state, ego, ego_row)[:, None], rows], dim=1)
        if self.normalize:
            obs = self._normalize(geo, state, ego, obs)
        # zero the padding rows after normalization
        row_ok = torch.cat([torch.ones_like(sel_ok[:, :1]), sel_ok], dim=1)
        obs = torch.where(row_ok[..., None], obs, 0.0)
        if perm is not None:
            rest = torch.gather(obs[:, 1:], 1, perm[..., None].expand(-1, -1, obs.shape[-1]))
            obs = torch.cat([obs[:, :1], rest], dim=1)
        return obs

    def _ego_row(self, geo, state, ego, ego_row):
        """Hook: the ego's (B, F) feature row as displayed, before
        normalization."""
        return ego_row

    def _normalize(self, geo, state, ego, obs):
        """Reference observation.py ``normalize_obs``."""
        if self.features_range is None:
            if self.reset_edge_lanes is not None:
                side = DEFAULT_WIDTH * float(self.reset_edge_lanes)
            else:
                li = lane_ops._gather(geo, state.lane[:, ego])
                side = (DEFAULT_WIDTH * geo.edge_n[li].float())[:, None]
            ranges = {
                "x": (-5.0 * MAX_SPEED, 5.0 * MAX_SPEED),
                "y": (-side, side),
                "vx": (-2 * MAX_SPEED, 2 * MAX_SPEED),
                "vy": (-2 * MAX_SPEED, 2 * MAX_SPEED),
            }
        else:
            ranges = {k: (v[0], v[1]) for k, v in self.features_range.items()}
        out = []
        for fi, f in enumerate(self.features):
            col = obs[..., fi]
            if f in ranges:
                col = lmap(col, ranges[f], (-1.0, 1.0))
                if self.clip:
                    col = col.clamp(-1.0, 1.0)
            out.append(col)
        return torch.stack(out, dim=-1)
