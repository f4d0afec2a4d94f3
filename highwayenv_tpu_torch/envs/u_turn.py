"""U-turn task: overtake slow vehicles through a 180-degree turn.

PyTorch counterpart of ``highwayenv_tpu/envs/u_turn.py`` (reference
highway_env/envs/u_turn_env.py, u-turn-v0).  Two straight double-lane
segments joined by counter-clockwise circular lanes (L = 6); the ego and
six IDM blockers start at fixed stations, the blockers with N(0, 2)
jitter on station and speed, and every vehicle routes to node "d".  The
observation is the time-to-collision grid over a 16 s horizon.

The reference assigns ``ego_vehicle.PURSUIT_TAU``, which its controller
never reads (it reads ``TAU_PURSUIT``); the assignment is not reproduced.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from highwayenv_tpu_torch.envs.base import BaseEnv, EnvState
from highwayenv_tpu_torch.envs.highway import _uniform
from highwayenv_tpu_torch.road import lane as lane_ops
from highwayenv_tpu_torch.road.network import (
    CircularLane,
    LineType,
    RoadNetworkBuilder,
    StraightLane,
)
from highwayenv_tpu_torch.utils.config import update_config
from highwayenv_tpu_torch.utils.math import lmap
from highwayenv_tpu_torch.vehicle import controller
from highwayenv_tpu_torch.vehicle.state import KIND_EGO, KIND_IDM, VehicleState, empty_state

#: (lane index, station, speed) of the ego and the six blockers
#: (reference u_turn_env.py ``_make_vehicles``)
SPAWNS = (
    (("a", "b", 0), 0.0, 16.0),  # the ego, no jitter
    (("a", "b", 0), 25.0, 13.5),
    (("a", "b", 1), 56.0, 14.5),
    (("b", "c", 1), 0.5, 4.5),
    (("b", "c", 0), 17.5, 5.5),
    (("c", "d", 0), 1.0, 3.5),
    (("c", "d", 1), 30.0, 5.5),
)


class UTurnEnv(BaseEnv):
    @classmethod
    def default_config(cls) -> dict:
        config = super().default_config()
        update_config(
            config,
            {
                "observation": {"type": "TimeToCollision", "horizon": 16},
                "action": {
                    "type": "DiscreteMetaAction",
                    "target_speeds": [8, 16, 24],
                },
                "screen_width": 789,
                "screen_height": 289,
                "duration": 10,
                "collision_reward": -1.0,
                "left_lane_reward": 0.1,
                "high_speed_reward": 0.4,
                "reward_speed_range": [8, 24],
                "normalize_reward": True,
                "offroad_terminal": False,
            },
        )
        return config

    def _build_scene(self):
        """Reference u_turn_env.py ``_make_road``."""
        length, width = 128.0, 4.0
        n, c, s = LineType.NONE, LineType.CONTINUOUS, LineType.STRIPED
        net = RoadNetworkBuilder()
        # the upper lanes after the turn, from x = length back to 0
        net.add_lane("c", "d", StraightLane(
            [length, width], [0, width], line_types=(LineType.CONTINUOUS_LINE, s)))
        net.add_lane("c", "d", StraightLane(
            [length, 0], [0, 0], line_types=(n, LineType.CONTINUOUS_LINE)))
        # the counter-clockwise turn
        center = [length, width + 20.0]
        radius = 20.0
        for radius_i, line in ((radius, [c, s]), (radius + width, [n, c])):
            net.add_lane("b", "c", CircularLane(
                center, radius_i, np.deg2rad(90), np.deg2rad(-90),
                clockwise=False, line_types=line))
        # the lower lanes before the turn
        y0 = 2 * width + 2 * radius
        net.add_lane("a", "b", StraightLane(
            [0, y0 - width], [length, y0 - width],
            line_types=(LineType.CONTINUOUS_LINE, s)))
        net.add_lane("a", "b", StraightLane(
            [0, y0], [length, y0], line_types=(n, LineType.CONTINUOUS_LINE)))
        self.net = net
        self.geo = net.build(device=self.device)
        self.max_edge_lanes = 2
        self.num_slots = len(SPAWNS)
        self.ttc_grid_lanes = 2
        self.connected3 = net.connectivity_matrix(depth=3)
        self.route_slots = 3

        R, dev = self.route_slots, self.device
        routes = [net.route_arrays(idx, "d", R) for idx, _s, _v in SPAWNS]
        self._routes = torch.as_tensor(
            np.stack([np.stack(r[:3]) for r in routes]), dtype=torch.int32, device=dev
        )  # (V, base / n / id, R)
        self._route_len = torch.as_tensor([r[3] for r in routes], dtype=torch.int32,
                                          device=dev)
        self._spawn_lane = torch.as_tensor(
            [net.global_lane_index(idx) for idx, _s, _v in SPAWNS],
            dtype=torch.int32, device=dev,
        )
        self._spawn_s = torch.tensor([s_ for _i, s_, _v in SPAWNS], device=dev)
        self._spawn_v = torch.tensor([v for _i, _s, v in SPAWNS], device=dev)
        self._is_ego = torch.arange(self.num_slots, device=dev) == 0

    def _reset_draws(self, batch: int, generator) -> dict:
        """The reset's draws, in order: station and speed jitters N(0, 1),
        each (B, V) (the ego's unused), then the second vehicle's IDM
        exponent U(3.5, 4.5), (B,): only it calls ``randomize_behavior``."""
        B, V, dev = batch, self.num_slots, self.device
        return {
            "s": torch.randn((B, V), generator=generator, device=dev),
            "speed": torch.randn((B, V), generator=generator, device=dev),
            "delta": _uniform((B,), 3.5, 4.5, generator, dev),
        }

    def _place_vehicles(self, draws: dict) -> VehicleState:
        B, V, R, dev = draws["s"].shape[0], self.num_slots, self.route_slots, self.device
        is_ego = self._is_ego.expand(B, V)
        lane = self._spawn_lane.expand(B, V)
        s = self._spawn_s + torch.where(is_ego, 0.0, 2.0 * draws["s"])
        speed = self._spawn_v + torch.where(is_ego, 0.0, 2.0 * draws["speed"])
        pos = lane_ops.position(self.geo, lane, s, torch.zeros_like(s))
        # the ego's heading is the vehicle default 0, the NPCs' their lane's
        heading = torch.where(is_ego, 0.0, lane_ops.heading_at(self.geo, lane, s))
        ego_index, ego_ts = controller.ego_speed_init(self.action_type, speed)
        delta = torch.full((B, V), 4.0, device=dev)
        delta[:, 1] = draws["delta"]
        routes = self._routes.expand(B, V, 3, R)
        veh = empty_state(B, V, route_slots=R, device=dev)
        return veh.replace(
            pos=pos,
            heading=heading,
            speed=speed,
            lane=lane.contiguous(),
            target_lane=lane.contiguous(),
            target_speed=torch.where(is_ego, ego_ts, speed),
            speed_index=torch.where(is_ego, ego_index, 0).to(torch.int32),
            timer=torch.remainder((pos[..., 0] + pos[..., 1]) * math.pi, 1.0),
            delta=delta,
            kind=torch.where(is_ego, KIND_EGO, KIND_IDM).to(torch.int32),
            route_base=routes[:, :, 0].contiguous(),
            route_n=routes[:, :, 1].contiguous(),
            route_id=routes[:, :, 2].contiguous(),
            route_len=self._route_len.expand(B, V).contiguous(),
        )

    def _rewards(self, state: EnvState, action):
        """Reference u_turn_env.py ``_rewards``."""
        veh = state.vehicles
        li = lane_ops._gather(self.geo, veh.lane[:, 0])
        n_neighbours = self.geo.edge_n[li]
        scaled_speed = lmap(veh.speed[:, 0], self.config["reward_speed_range"],
                            (0.0, 1.0))
        return {
            "collision_reward": veh.crashed[:, 0].float(),
            "left_lane_reward": self.geo.lane_id[li] / torch.clamp(n_neighbours - 1, min=1),
            "high_speed_reward": scaled_speed.clamp(0.0, 1.0),
            "on_road_reward": self.ego_on_road(state).float(),
        }

    def _reward(self, state: EnvState, action):
        """Reference u_turn_env.py ``_reward``: normalized, then times
        on_road."""
        cfg = self.config
        rewards = self._rewards(state, action)
        reward = sum(cfg.get(k, 0) * v for k, v in rewards.items())
        if cfg["normalize_reward"]:
            reward = lmap(
                reward,
                (cfg["collision_reward"],
                 cfg["high_speed_reward"] + cfg["left_lane_reward"]),
                (0.0, 1.0),
            )
        return reward * rewards["on_road_reward"]

    def _is_terminated(self, state: EnvState):
        return state.vehicles.crashed[:, 0]

    def _is_truncated(self, state: EnvState):
        return state.time >= self.config["duration"]
