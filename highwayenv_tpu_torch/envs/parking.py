"""Parking: continuous-control goal-reaching with a HER-compatible reward.

PyTorch counterpart of ``highwayenv_tpu/envs/parking.py`` (reference
highway_env/envs/parking_env.py, parking-v0, parking-ActionRepeat-v0 and
parking-parked-v0).  2 x 14 perpendicular spots, the spot lanes of edges
a -> b and b -> c; the ego at the origin with a random heading; a goal
landmark (2 x 2, non-solid: it sets ``hit``, never ``crashed``) in the
middle of a random spot the ego is not on; ``vehicles_count`` parked plain
vehicles 4 m into further spots; and 4 wall obstacles.  The slots go egos |
parked | goals | walls.  The reward is the weighted p-norm of the goal
features' gap, ``-(|dg| . w) ** 0.5``, plus the collision reward; the
episode ends on a crash or when the goal reward passes
``-success_goal_reward``.  The ego's ContinuousAction stores its controls,
so the frames run K4's raw-control branch, on 14 lanes an edge.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from highwayenv_tpu_torch.envs.base import BaseEnv, EnvState
from highwayenv_tpu_torch.road import lane as lane_ops
from highwayenv_tpu_torch.road.network import LineType, RoadNetworkBuilder, StraightLane
from highwayenv_tpu_torch.utils.config import update_config
from highwayenv_tpu_torch.vehicle.state import (
    KIND_EGO,
    KIND_LANDMARK,
    KIND_OBSTACLE,
    KIND_PLAIN,
    VehicleState,
    empty_state,
)

#: the walls' box, W x H (reference parking_env.py ``_create_vehicles``)
WALL_W, WALL_H = 70.0, 42.0


class ParkingEnv(BaseEnv):
    #: the egos' colour in the rendered frames (the reference sets the
    #: vehicle's color attribute, parking_env.py)
    ego_color = (50, 200, 0)

    #: ``controlled_vehicles`` egos, each with its goal: the reward sums
    #: their goal rewards and crashes, success takes every ego's, any crash
    #: terminates
    several_egos = True

    #: the observation the reward reads, whatever the configured one
    PARKING_OBS = {
        "observation": {
            "type": "KinematicsGoal",
            "features": ["x", "y", "vx", "vy", "cos_h", "sin_h"],
            "scales": [100, 100, 5, 5, 1, 1],
            "normalize": False,
        }
    }

    @classmethod
    def default_config(cls) -> dict:
        config = super().default_config()
        update_config(
            config,
            {
                "observation": copy.deepcopy(cls.PARKING_OBS["observation"]),
                "action": {"type": "ContinuousAction"},
                "reward_weights": [1, 0.3, 0, 0, 0.02, 0.02],
                "success_goal_reward": 0.12,
                "collision_reward": -5,
                "steering_range": float(np.deg2rad(45)),
                "simulation_frequency": 15,
                "policy_frequency": 5,
                "duration": 100,
                "screen_width": 600,
                "screen_height": 300,
                "centering_position": [0.5, 0.5],
                "scaling": 7,
                "controlled_vehicles": 1,
                "vehicles_count": 0,
                "add_walls": True,
            },
        )
        return config

    def _build_scene(self):
        """Reference parking_env.py ``_create_road``."""
        cfg = self.config
        spots, width, y_offset, length = 14, 4.0, 10.0, 8.0
        lt = (LineType.CONTINUOUS, LineType.CONTINUOUS)
        net = RoadNetworkBuilder()
        for k in range(spots):
            x = (k + 1 - spots // 2) * width - width / 2
            net.add_lane("a", "b", StraightLane([x, y_offset], [x, y_offset + length],
                                                width=width, line_types=lt))
            net.add_lane("b", "c", StraightLane([x, -y_offset], [x, -y_offset - length],
                                                width=width, line_types=lt))
        self.net = net
        self.geo = net.build(device=self.device)
        self.max_edge_lanes = spots
        self.n_spots = 2 * spots

        n_ctrl, n_parked = cfg["controlled_vehicles"], cfg["vehicles_count"]
        n_walls = 4 if cfg["add_walls"] else 0
        self.num_slots = n_ctrl + n_parked + n_ctrl + n_walls
        self._ego_slots = list(range(n_ctrl))
        self._egos = slice(0, n_ctrl)
        self._goal_base = n_ctrl + n_parked
        self._wall_base = self._goal_base + n_ctrl
        self._n_parked = n_parked
        dev = self.device
        # the egos at [10 (i - n // 2), 0]; the walls' centres, headings and
        # lengths (1 m wide)
        self._ego_x = torch.as_tensor(
            10.0 * (np.arange(n_ctrl, dtype=np.float32) - n_ctrl // 2), device=dev)
        self._wall_pos = torch.tensor(
            [[0.0, -WALL_H / 2], [0.0, WALL_H / 2], [-WALL_W / 2, 0.0], [WALL_W / 2, 0.0]],
            device=dev)
        self._wall_heading = torch.tensor([0.0, 0.0, math.pi / 2, math.pi / 2], device=dev)
        self._wall_length = torch.tensor([WALL_W, WALL_W, WALL_H, WALL_H], device=dev)
        self._weights = torch.tensor(cfg["reward_weights"], dtype=torch.float32, device=dev)

    @property
    def ego_slots(self):
        return tuple(self._ego_slots)

    def goal_slot_of(self, ego: int) -> int:
        return self._goal_base + self._ego_slots.index(ego)

    def _reset_draws(self, batch: int, generator) -> dict:
        """The reset's draws, in order: the egos' headings U[0, 2 pi),
        (B, n_ctrl), and a permutation of the spots, (B, 28) int64."""
        n_ctrl, dev = len(self._ego_slots), self.device
        u = torch.rand((batch, n_ctrl), generator=generator, device=dev)
        keys = torch.rand((batch, self.n_spots), generator=generator, device=dev)
        return {
            "heading": 2 * math.pi * u,
            "perm": torch.argsort(keys, dim=1, stable=True),
        }

    def _place_vehicles(self, draws: dict) -> VehicleState:
        """Reference parking_env.py ``_create_vehicles``."""
        perm = draws["perm"]
        B, V, dev, geo = perm.shape[0], self.num_slots, self.device, self.geo
        n_ctrl, n_parked = len(self._ego_slots), self._n_parked
        pos = torch.zeros((B, V, 2), device=dev)
        heading = torch.zeros((B, V), device=dev)
        kind = torch.zeros((B, V), dtype=torch.int32, device=dev)
        length = torch.full((B, V), 5.0, device=dev)
        width = torch.full((B, V), 2.0, device=dev)
        pos[:, :n_ctrl, 0] = self._ego_x
        heading[:, :n_ctrl] = draws["heading"]
        kind[:, :n_ctrl] = KIND_EGO

        # the spots in drawn order, the egos' closest ones pushed to the back
        ego_lane = lane_ops.closest_lane(geo, pos[:, :n_ctrl], heading[:, :n_ctrl])
        taken = (perm[:, :, None] == ego_lane[:, None, :]).any(dim=-1)
        order = torch.gather(perm, 1, torch.argsort(taken.to(torch.int32), dim=1,
                                                    stable=True))

        # a goal landmark per ego in the middle of its spot
        goal_lane = order[:, :n_ctrl]
        mid = geo.length[goal_lane] / 2
        g = slice(self._goal_base, self._goal_base + n_ctrl)
        pos[:, g] = lane_ops.position(geo, goal_lane, mid, torch.zeros_like(mid))
        heading[:, g] = lane_ops.heading_at(geo, goal_lane, torch.zeros_like(mid))
        kind[:, g] = KIND_LANDMARK
        length[:, g] = 2.0

        # parked vehicles 4 m into the next spots
        if n_parked:
            plane = order[:, n_ctrl:n_ctrl + n_parked]
            s = torch.full(plane.shape, 4.0, device=dev)
            pk = slice(n_ctrl, n_ctrl + n_parked)
            pos[:, pk] = lane_ops.position(geo, plane, s, torch.zeros_like(s))
            heading[:, pk] = lane_ops.heading_at(geo, plane, s)
            kind[:, pk] = KIND_PLAIN

        if self.config["add_walls"]:
            w = slice(self._wall_base, self._wall_base + 4)
            pos[:, w] = self._wall_pos
            heading[:, w] = self._wall_heading
            kind[:, w] = KIND_OBSTACLE
            length[:, w] = self._wall_length
            width[:, w] = 1.0

        lane = lane_ops.closest_lane(geo, pos, heading)
        return empty_state(B, V, device=dev).replace(
            pos=pos, heading=heading, lane=lane, target_lane=lane.clone(), kind=kind,
            length=length, width=width,
        )

    # ------------------------------------------------------------------ #
    def _build_spaces(self):
        """Rewards always read PARKING_OBS's features, under any configured
        observation (reference parking_env.py)."""
        from highwayenv_tpu_torch.factories import observation_factory

        super()._build_spaces()
        self.observation_type_parking = observation_factory(
            self, self.PARKING_OBS["observation"]
        )

    def compute_reward(self, achieved, desired, p: float = 0.5) -> torch.Tensor:
        """Weighted p-norm goal reward over the last axis, batched
        (reference parking_env.py ``compute_reward``; Gymnasium's GoalEnv
        calls it to relabel goals, HER)."""
        a = torch.as_tensor(achieved, dtype=torch.float32)
        d = torch.as_tensor(desired, dtype=torch.float32, device=a.device)
        w = self._weights.to(a.device)
        return -torch.pow(torch.sum(torch.abs(a - d) * w, dim=-1), p)

    def _agent_goal_rewards(self, state: EnvState) -> torch.Tensor:
        """(B, egos) goal rewards from PARKING_OBS's features."""
        obs, veh = self.observation_type_parking, state.vehicles
        return torch.stack([
            self.compute_reward(obs.scaled_row(veh, e),
                                obs.scaled_row(veh, self.goal_slot_of(e)))
            for e in self.ego_slots
        ], dim=-1)

    def _reward(self, state: EnvState, action) -> torch.Tensor:
        crashes = state.vehicles.crashed[:, self._egos].float().sum(dim=-1)
        return (self._agent_goal_rewards(state).sum(dim=-1)
                + self.config["collision_reward"] * crashes)

    def _success(self, state: EnvState) -> torch.Tensor:
        return (self._agent_goal_rewards(state)
                > -self.config["success_goal_reward"]).all(dim=-1)

    def _is_terminated(self, state: EnvState) -> torch.Tensor:
        crashed = state.vehicles.crashed[:, self._egos].any(dim=-1)
        return crashed | self._success(state)

    def _is_truncated(self, state: EnvState) -> torch.Tensor:
        return state.time >= self.config["duration"]

    def _info(self, state: EnvState, action):
        info = super()._info(state, action)
        info["is_success"] = self._success(state)
        return info


class ParkingEnvActionRepeat(ParkingEnv):
    """parking-ActionRepeat-v0: one policy step a second, 15 frames."""

    @classmethod
    def default_config(cls) -> dict:
        cfg = super().default_config()
        cfg.update({"policy_frequency": 1, "duration": 20})
        return cfg


class ParkingEnvParkedVehicles(ParkingEnv):
    """parking-parked-v0: 10 parked vehicles."""

    @classmethod
    def default_config(cls) -> dict:
        cfg = super().default_config()
        cfg.update({"vehicles_count": 10})
        return cfg
