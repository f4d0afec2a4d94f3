"""Merge scenario: a 2-lane highway joined by a sine-curved access ramp that
ends at an obstacle.

PyTorch counterpart of ``highwayenv_tpu/envs/merge.py`` (reference
highway_env/envs/merge_env.py, merge-v0).  A fixed spawn layout with small
uniform jitter: the ego, three highway IDM vehicles on random lanes, one
IDM vehicle on the ramp with target speed 30, and the obstacle at the
ramp's end.  The altruistic merging-speed penalty sums over the controlled
vehicles on the ramp's continuation lane.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from highwayenv_tpu_torch.envs.base import BaseEnv, EnvState
from highwayenv_tpu_torch.envs.highway import _uniform
from highwayenv_tpu_torch.road import lane as lane_ops
from highwayenv_tpu_torch.road.network import (
    LineType,
    RoadNetworkBuilder,
    SineLane,
    StraightLane,
)
from highwayenv_tpu_torch.utils.config import update_config
from highwayenv_tpu_torch.utils.math import lmap
from highwayenv_tpu_torch.vehicle import controller
from highwayenv_tpu_torch.vehicle.state import (
    KIND_EGO,
    KIND_IDM,
    KIND_OBSTACLE,
    OBJECT_LENGTH,
    OBJECT_WIDTH,
    VehicleState,
    empty_state,
)


class MergeEnv(BaseEnv):
    @classmethod
    def default_config(cls) -> dict:
        cfg = super().default_config()
        update_config(
            cfg,
            {
                "collision_reward": -1,
                "right_lane_reward": 0.1,
                "high_speed_reward": 0.2,
                "reward_speed_range": [20, 30],
                "merging_speed_reward": -0.5,
                "lane_change_reward": -0.05,
            },
        )
        return cfg

    def _build_scene(self):
        """Road layout of reference merge_env.py ``_make_road``."""
        net = RoadNetworkBuilder()
        ends = [150, 80, 80, 150]  # before, converging, merge, after
        c, s, n = LineType.CONTINUOUS_LINE, LineType.STRIPED, LineType.NONE
        y = [0, 4.0]
        line_type = [[c, s], [n, c]]
        line_type_merge = [[c, s], [n, s]]
        for i in range(2):
            net.add_lane("a", "b", StraightLane(
                [0, y[i]], [sum(ends[:2]), y[i]], line_types=line_type[i]))
            net.add_lane("b", "c", StraightLane(
                [sum(ends[:2]), y[i]], [sum(ends[:3]), y[i]],
                line_types=line_type_merge[i]))
            net.add_lane("c", "d", StraightLane(
                [sum(ends[:3]), y[i]], [sum(ends), y[i]], line_types=line_type[i]))

        amplitude = 3.25
        ljk = StraightLane([0, 6.5 + 4 + 4], [ends[0], 6.5 + 4 + 4],
                           line_types=[c, c], forbidden=True)
        lkb = SineLane(
            ljk.position(ends[0], -amplitude),
            ljk.position(sum(ends[:2]), -amplitude),
            amplitude, 2 * np.pi / (2 * ends[1]), np.pi / 2,
            line_types=[c, c], forbidden=True,
        )
        lbc = StraightLane(
            lkb.position(ends[1], 0),
            lkb.position(ends[1], 0) + np.array([ends[2], 0]),
            line_types=[n, c], forbidden=True,
        )
        net.add_lane("j", "k", ljk)
        net.add_lane("k", "b", lkb)
        net.add_lane("b", "c", lbc)
        self.net = net
        self.geo = net.build(device=self.device)
        self.max_edge_lanes = 3
        self.obs_edge_lanes = 2  # ego spawns on ("a","b"), 2 lanes (PARITY #5)
        self._obstacle_pos = torch.as_tensor(
            np.asarray(lbc.position(ends[2], 0), np.float32), device=self.device
        )
        self._merge_lane = net.global_lane_index(("b", "c", 2))
        self._ramp_lane = net.global_lane_index(("j", "k", 0))
        self._ego_pos = torch.as_tensor(
            np.asarray(net.get_lane(("a", "b", 1)).position(30.0, 0.0), np.float32),
            device=self.device,
        )
        # slots: ego, 3 highway NPCs, ramp NPC, end-of-ramp obstacle
        self.num_slots = 6
        self._kind = torch.tensor(
            [KIND_EGO, KIND_IDM, KIND_IDM, KIND_IDM, KIND_IDM, KIND_OBSTACLE],
            dtype=torch.int32, device=self.device,
        )
        # the highway NPCs' base stations and speeds
        self._npc_s = torch.tensor([90.0, 70.0, 5.0], device=self.device)
        self._npc_speed = torch.tensor([29.0, 31.0, 31.5], device=self.device)

    def _reset_draws(self, batch: int, generator) -> dict:
        """The reset's draws, in order, each (B, 3): the three highway NPCs'
        lanes, stations and speeds."""
        B, dev = batch, self.device
        # three highway NPCs at s in {90, 70, 5} + U(-5, 5) on a random lane
        # of ("a", "b") (global ids 0 / 1), speeds {29, 31, 31.5} + U(-1, 1)
        lanes = torch.randint(
            0, 2, (B, 3), generator=generator, device=dev, dtype=torch.int32
        )
        return {
            "lanes": lanes,
            "s": self._npc_s + _uniform((B, 3), -5.0, 5.0, generator, dev),
            "speed": self._npc_speed + _uniform((B, 3), -1.0, 1.0, generator, dev),
        }

    def _place_vehicles(self, draws: dict) -> VehicleState:
        """Reference merge_env.py ``_make_vehicles``."""
        lanes, s_npc, v_npc = draws["lanes"], draws["s"], draws["speed"]
        B, V, dev = lanes.shape[0], self.num_slots, self.device
        npc_pos = lane_ops.position(self.geo, lanes, s_npc, torch.zeros_like(s_npc))
        npc_heading = lane_ops.heading_at(self.geo, lanes, s_npc)

        # the ramp NPC at s=110 on ("j", "k"), speed 20
        ramp = torch.full((B, 1), self._ramp_lane, dtype=torch.int32, device=dev)
        s_ramp = torch.full((B, 1), 110.0, device=dev)
        ramp_pos = lane_ops.position(self.geo, ramp, s_ramp, torch.zeros_like(s_ramp))
        ramp_heading = lane_ops.heading_at(self.geo, ramp, s_ramp)

        zero = torch.zeros((B, 1), device=dev)
        pos = torch.cat([
            self._ego_pos.expand(B, 1, 2), npc_pos, ramp_pos,
            self._obstacle_pos.expand(B, 1, 2),
        ], dim=1)
        heading = torch.cat([zero, npc_heading, ramp_heading, zero], dim=1)
        speed = torch.cat([
            torch.full((B, 1), 30.0, device=dev), v_npc,
            torch.full((B, 1), 20.0, device=dev), zero,
        ], dim=1)
        kind = self._kind.expand(B, V)
        lane = lane_ops.closest_lane(self.geo, pos, heading)
        is_ego = kind == KIND_EGO
        ego_index, ego_ts = controller.ego_speed_init(self.action_type, speed)
        target_speed = torch.where(is_ego, ego_ts, speed)
        target_speed[:, 4] = 30.0  # the ramp vehicle's target speed
        obstacle = kind == KIND_OBSTACLE
        veh = empty_state(B, V, device=dev)
        return veh.replace(
            pos=pos,
            heading=heading,
            speed=speed,
            lane=lane,
            target_lane=lane.clone(),
            target_speed=target_speed,
            speed_index=torch.where(is_ego, ego_index, 0).to(torch.int32),
            timer=torch.remainder((pos[..., 0] + pos[..., 1]) * math.pi, 1.0),
            kind=kind.contiguous(),
            length=torch.where(obstacle, OBJECT_LENGTH, 5.0),
            width=torch.where(obstacle, OBJECT_WIDTH, 2.0),
        )

    def _rewards(self, state: EnvState, action):
        """Reference merge_env.py ``_rewards``."""
        veh = state.vehicles
        scaled_speed = lmap(veh.speed[:, 0], self.config["reward_speed_range"],
                            (0.0, 1.0))
        lane_id = self.geo.lane_id[lane_ops._gather(self.geo, veh.lane[:, 0])]
        on_merge = (veh.lane == self._merge_lane) & veh.is_controlled & veh.active
        moving_target = veh.target_speed != 0.0
        penalty = torch.where(
            on_merge & moving_target,
            (veh.target_speed - veh.speed)
            / torch.where(moving_target, veh.target_speed, 1.0),
            0.0,
        )
        return {
            "collision_reward": veh.crashed[:, 0].float(),
            "right_lane_reward": lane_id.float() / 1.0,
            "high_speed_reward": scaled_speed,
            "lane_change_reward": ((action == 0) | (action == 2)).float(),
            "merging_speed_reward": penalty.sum(dim=-1),
        }

    def _reward(self, state: EnvState, action):
        """Reference merge_env.py ``_reward``."""
        cfg = self.config
        rewards = self._rewards(state, action)
        reward = sum(cfg.get(name, 0) * v for name, v in rewards.items())
        return lmap(
            reward,
            (cfg["collision_reward"] + cfg["merging_speed_reward"],
             cfg["high_speed_reward"] + cfg["right_lane_reward"]),
            (0.0, 1.0),
        )

    def _is_terminated(self, state: EnvState):
        veh = state.vehicles
        return veh.crashed[:, 0] | (veh.pos[:, 0, 0] > 370.0)

    def _is_truncated(self, state: EnvState):
        return torch.zeros_like(state.time, dtype=torch.bool)
