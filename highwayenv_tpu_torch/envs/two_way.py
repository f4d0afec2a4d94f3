"""Two-way road with oncoming traffic (a risk-management task).

PyTorch counterpart of ``highwayenv_tpu/envs/two_way.py`` (reference
highway_env/envs/two_way_env.py, two-way-v0).  Two co-directional lanes
on edge (a, b) and one opposing lane on (b, a), which shares the right
lane's line.  The ego starts on the left lane of (a, b) behind three
forward NPCs and facing two oncoming ones; the NPCs keep their lanes.
The observation is the time-to-collision grid, the reward rewards speed
and the left lane, a crash ends the episode and the registration's
15-step limit truncates it.
"""

from __future__ import annotations

import math

import torch

from highwayenv_tpu_torch.envs.base import BaseEnv, EnvState
from highwayenv_tpu_torch.road import lane as lane_ops
from highwayenv_tpu_torch.road.network import LineType, RoadNetworkBuilder, StraightLane
from highwayenv_tpu_torch.utils.config import update_config
from highwayenv_tpu_torch.vehicle import controller
from highwayenv_tpu_torch.vehicle.state import KIND_EGO, KIND_IDM, VehicleState, empty_state


class TwoWayEnv(BaseEnv):
    @classmethod
    def default_config(cls) -> dict:
        config = super().default_config()
        update_config(
            config,
            {
                "observation": {"type": "TimeToCollision", "horizon": 5},
                "action": {"type": "DiscreteMetaAction"},
                "collision_reward": 0,
                "left_lane_constraint": 1,
                "left_lane_reward": 0.2,
                "high_speed_reward": 0.8,
                "max_episode_steps": 15,  # registration TimeLimit
            },
        )
        return config

    def _build_scene(self):
        """Reference two_way_env.py ``_make_road``."""
        length = 800
        net = RoadNetworkBuilder()
        net.add_lane("a", "b", StraightLane(
            [0, 0], [length, 0],
            line_types=(LineType.CONTINUOUS_LINE, LineType.STRIPED)))
        net.add_lane("a", "b", StraightLane(
            [0, 4.0], [length, 4.0],
            line_types=(LineType.NONE, LineType.CONTINUOUS_LINE)))
        net.add_lane("b", "a", StraightLane(
            [length, 0], [0, 0], line_types=(LineType.NONE, LineType.NONE)))
        self.net = net
        self.geo = net.build(device=self.device)
        self.max_edge_lanes = 2
        self.num_slots = 6  # ego + 3 same-direction + 2 oncoming
        self.ttc_grid_lanes = 2  # lanes on the ego's (a, b) edge
        self.connected3 = net.connectivity_matrix(depth=3)
        dev = self.device
        ab1 = net.global_lane_index(("a", "b", 1))
        ba0 = net.global_lane_index(("b", "a", 0))
        # spawn lanes and the mean stations of the forward / oncoming NPCs
        self._spawn_lane = torch.tensor([ab1] * 4 + [ba0] * 2, dtype=torch.int32,
                                        device=dev)
        self._fwd_s = torch.tensor([70.0, 110.0, 150.0], device=dev)
        self._bwd_s = torch.tensor([200.0, 300.0], device=dev)
        self._kind = torch.tensor([KIND_EGO] + [KIND_IDM] * 5, dtype=torch.int32,
                                  device=dev)

    def _reset_draws(self, batch: int, generator) -> dict:
        """The reset's draws, in order: the forward NPCs' station and speed
        jitters (B, 3), then the oncoming NPCs' (B, 2), each N(0, 1)."""
        B, dev = batch, self.device

        def normal(n):
            return torch.randn((B, n), generator=generator, device=dev)

        return {"fwd_s": normal(3), "fwd_v": normal(3),
                "bwd_s": normal(2), "bwd_v": normal(2)}

    def _place_vehicles(self, draws: dict) -> VehicleState:
        """Reference two_way_env.py ``_make_vehicles``."""
        B, V, dev = draws["fwd_s"].shape[0], self.num_slots, self.device
        lane = self._spawn_lane.expand(B, V)
        s = torch.cat([
            torch.full((B, 1), 30.0, device=dev),
            self._fwd_s + 10.0 * draws["fwd_s"],
            self._bwd_s + 10.0 * draws["bwd_s"],
        ], dim=1)
        speed = torch.cat([
            torch.full((B, 1), 30.0, device=dev),
            24.0 + 2.0 * draws["fwd_v"],
            20.0 + 5.0 * draws["bwd_v"],
        ], dim=1)
        pos = lane_ops.position(self.geo, lane, s, torch.zeros_like(s))
        # the NPCs' headings at the un-jittered stations; the ego's 0
        s_mean = torch.cat([self._fwd_s, self._bwd_s]).expand(B, V - 1)
        heading = torch.cat([
            torch.zeros((B, 1), device=dev),
            lane_ops.heading_at(self.geo, lane[:, 1:], s_mean),
        ], dim=1)
        kind = self._kind.expand(B, V)
        is_ego = kind == KIND_EGO
        # RoadObject localizes by the closest lane; an NPC's target lane is
        # its spawn lane (the oncoming ones' set explicitly)
        loc = lane_ops.closest_lane(self.geo, pos, heading)
        ego_index, ego_ts = controller.ego_speed_init(self.action_type, speed)
        veh = empty_state(B, V, device=dev)
        return veh.replace(
            pos=pos,
            heading=heading,
            speed=speed,
            lane=loc,
            target_lane=torch.where(is_ego, loc, lane),
            target_speed=torch.where(is_ego, ego_ts, speed),
            speed_index=torch.where(is_ego, ego_index, 0).to(torch.int32),
            timer=torch.remainder((pos[..., 0] + pos[..., 1]) * math.pi, 1.0),
            kind=kind.contiguous(),
            enable_lane_change=is_ego.contiguous(),  # the NPCs keep their lanes
        )

    def _rewards(self, state: EnvState, action):
        """Reference two_way_env.py ``_rewards``."""
        veh = state.vehicles
        n_speeds = len(self.action_type.target_speeds)
        n_neighbours = self.geo.edge_n[lane_ops._gather(self.geo, veh.lane[:, 0])]
        tgt_id = self.geo.lane_id[lane_ops._gather(self.geo, veh.target_lane[:, 0])]
        return {
            "high_speed_reward": veh.speed_index[:, 0] / (n_speeds - 1),
            "left_lane_reward": (n_neighbours - 1 - tgt_id)
            / torch.clamp(n_neighbours - 1, min=1),
        }

    def _reward(self, state: EnvState, action):
        rewards = self._rewards(state, action)
        return sum(self.config.get(k, 0) * v for k, v in rewards.items())

    def _is_terminated(self, state: EnvState):
        return state.vehicles.crashed[:, 0]

    def _is_truncated(self, state: EnvState):
        return torch.zeros_like(state.time, dtype=torch.bool)
