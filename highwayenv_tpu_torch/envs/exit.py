"""Exit scenario: reach the motorway off-ramp at speed.

PyTorch counterpart of ``highwayenv_tpu/envs/exit.py`` (reference
highway_env/envs/exit_env.py, exit-v0).  Six straight lanes, then a
section with a seventh (exit-approach) lane, then six lanes again, and a
circular off-ramp from the approach lane; lane ``i`` has the speed limit
26 - 3.4 i.  The NPCs spawn on lane ids drawn with probability
proportional to the id, drive at their lane's limit, keep their lanes
and route to node "3".  The ego's ``x`` in the observation is its
station on the approach lane (``observations/exit_obs.py``); the episode
succeeds when the ego targets the approach lane or the ramp.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from highwayenv_tpu_torch.envs.base import EnvState
from highwayenv_tpu_torch.envs.highway import HighwayEnv, _uniform
from highwayenv_tpu_torch.road import lane as lane_ops
from highwayenv_tpu_torch.road.network import CircularLane, RoadNetworkBuilder
from highwayenv_tpu_torch.utils.config import update_config
from highwayenv_tpu_torch.utils.math import lmap
from highwayenv_tpu_torch.vehicle import controller
from highwayenv_tpu_torch.vehicle.state import KIND_EGO, KIND_IDM, VehicleState, empty_state


class ExitEnv(HighwayEnv):
    #: one ego slot, as in the JAX package, whose seeded reset cannot place
    #: more than one controlled vehicle: ``make`` refuses
    #: ``controlled_vehicles`` > 1
    several_egos = False

    @classmethod
    def default_config(cls) -> dict:
        config = super().default_config()
        update_config(
            config,
            {
                "observation": {
                    "type": "ExitObservation",
                    "vehicles_count": 15,
                    "features": ["presence", "x", "y", "vx", "vy", "cos_h", "sin_h"],
                    "clip": False,
                },
                "action": {
                    "type": "DiscreteMetaAction",
                    "target_speeds": [18, 24, 30],
                },
                "lanes_count": 6,
                "collision_reward": 0,
                "high_speed_reward": 0.1,
                "right_lane_reward": 0,
                "normalize_reward": True,
                "goal_reward": 1,
                "vehicles_count": 20,
                "vehicles_density": 1.5,
                "controlled_vehicles": 1,
                "duration": 18,
                "simulation_frequency": 5,
                "scaling": 5,
            },
        )
        return config

    def _build_scene(self):
        """Reference exit_env.py ``_create_road``."""
        cfg = self.config
        n_lanes = cfg["lanes_count"]
        road_length, exit_position, exit_length = 1000.0, 400.0, 100.0
        net = RoadNetworkBuilder.straight_road_network(
            n_lanes, start=0, length=exit_position, nodes_str=("0", "1"))
        net = RoadNetworkBuilder.straight_road_network(
            n_lanes + 1, start=exit_position, length=exit_length,
            nodes_str=("1", "2"), net=net)
        net = RoadNetworkBuilder.straight_road_network(
            n_lanes, start=exit_position + exit_length,
            length=road_length - exit_position - exit_length,
            nodes_str=("2", "3"), net=net)
        for lanes in net.edges.values():
            for i, lane in enumerate(lanes):
                lane.speed_limit = 26 - 3.4 * i
        exit_pos = np.array([exit_position + exit_length, n_lanes * 4.0])
        radius = 150.0
        net.add_lane("2", "exit", CircularLane(
            center=exit_pos + np.array([0.0, radius]), radius=radius,
            start_phase=3 * np.pi / 2, end_phase=2 * np.pi, forbidden=True,
            speed_limit=26 - 3.4 * 0))
        self.net = net
        self.geo = net.build(device=self.device)
        self.max_edge_lanes = n_lanes + 1
        self.obs_edge_lanes = n_lanes  # the ego spawns on ("0", "1") (PARITY #5)
        self.num_slots = cfg["controlled_vehicles"] + cfg["vehicles_count"]
        self._ego_slots = [0]
        self.route_slots = 3
        # the goal lanes of _is_success (reference exit_env.py)
        self.goal_lane_approach = net.global_lane_index(("1", "2", n_lanes))
        self.goal_lane_exit = net.global_lane_index(("2", "exit", 0))
        self.exit_obs_lane = self.goal_lane_approach
        # the NPCs' route to "3" from ("0", "1"), the same for every lane id
        dev = self.device
        route = net.route_arrays(("0", "1", 0), "3", self.route_slots)
        self._npc_route = torch.as_tensor(np.stack(route[:3]), dtype=torch.int32,
                                          device=dev)
        self._npc_route_len = int(route[3])
        # the inverse CDF of the NPC lane ids, p(i) = i / sum(ids)
        ids = np.arange(n_lanes)
        self._lane_cdf = torch.as_tensor(
            np.cumsum(ids / ids.sum()), dtype=torch.float32, device=dev
        )
        self._is_ego = torch.arange(self.num_slots, device=dev) == 0

    def _build_spaces(self):
        from highwayenv_tpu_torch.factories import action_factory, observation_factory

        self.action_type = action_factory(self.config["action"], self)
        obs_cfg = dict(self.config["observation"])
        if obs_cfg.get("type") == "ExitObservation":
            obs_cfg["exit_lane"] = self.exit_obs_lane
        self.observation_type = observation_factory(self, obs_cfg)

    def _reset_draws(self, batch: int, generator) -> dict:
        """The reset's draws, in order: the lane-id uniforms and the
        spawn-gap factors U(0.9, 1.1), each (B, V)."""
        B, V, dev = batch, self.num_slots, self.device
        return {
            "lane_u": torch.rand((B, V), generator=generator, device=dev),
            "gap": _uniform((B, V), 0.9, 1.1, generator, dev),
        }

    def _place_vehicles(self, draws: dict) -> VehicleState:
        """Reference exit_env.py ``_create_vehicles``."""
        cfg = self.config
        n_lanes = cfg["lanes_count"]
        B, V = draws["gap"].shape
        R, dev = self.route_slots, self.device
        is_ego = self._is_ego.expand(B, V)
        # NPC lane ids with p proportional to the id; the ego on lane 0
        lane_id = torch.searchsorted(self._lane_cdf, draws["lane_u"], right=True)
        lane_id = torch.where(is_ego, 0, lane_id.clamp(max=n_lanes - 1)).to(torch.int32)
        lane = lane_id  # ("0", "1") holds the global ids [0, n_lanes)
        speed = torch.where(is_ego, 25.0, self.geo.speed_limit[lane.long()])

        # the create_random spawn chain along the shared x axis
        spacing = torch.where(is_ego, float(cfg["ego_spacing"]),
                              1.0 / cfg["vehicles_density"])
        offset = spacing * (12.0 + 1.0 * speed) * math.exp(-5.0 / 40.0 * n_lanes)
        delta_x = offset * draws["gap"]
        delta_x[:, 0] += 3.0 * offset[:, 0]
        x0 = torch.cumsum(delta_x, dim=1)
        pos = lane_ops.position(self.geo, lane, x0, torch.zeros_like(x0))
        heading = lane_ops.heading_at(self.geo, lane, x0)
        # RoadObject localizes by the closest lane: spawns past the end of
        # ("0", "1") land on ("1", "2")
        lane = lane_ops.closest_lane(self.geo, pos, heading)

        ego_index, ego_ts = controller.ego_speed_init(self.action_type, speed)
        route = self._npc_route.expand(B, V, 3, R)
        # the first route entry carries the spawn lane's explicit id
        route_id = route[:, :, 2].clone()
        route_id[:, :, 0] = lane_id
        veh = empty_state(B, V, route_slots=R, device=dev)
        return veh.replace(
            pos=pos,
            heading=heading.contiguous(),
            speed=speed,
            lane=lane,
            target_lane=lane.clone(),
            target_speed=torch.where(is_ego, ego_ts, speed),
            speed_index=torch.where(is_ego, ego_index, 0).to(torch.int32),
            timer=torch.remainder((pos[..., 0] + pos[..., 1]) * math.pi, 1.0),
            kind=torch.where(is_ego, KIND_EGO, KIND_IDM).to(torch.int32),
            enable_lane_change=is_ego.contiguous(),  # the NPCs keep their lanes
            route_base=route[:, :, 0].contiguous(),
            route_n=route[:, :, 1].contiguous(),
            route_id=route_id,
            route_len=torch.where(is_ego, 0, self._npc_route_len).to(torch.int32),
        )

    def _is_success(self, state: EnvState):
        """Reference exit_env.py ``_is_success``, on the ego's target lane."""
        tgt = state.vehicles.target_lane[:, 0]
        return (tgt == self.goal_lane_approach) | (tgt == self.goal_lane_exit)

    def _rewards(self, state: EnvState, action):
        """Reference exit_env.py ``_rewards``."""
        veh = state.vehicles
        tgt = lane_ops._gather(self.geo, veh.target_lane[:, 0])
        scaled_speed = lmap(veh.speed[:, 0], self.config["reward_speed_range"],
                            (0.0, 1.0))
        return {
            "collision_reward": veh.crashed[:, 0].float(),
            "goal_reward": self._is_success(state).float(),
            "high_speed_reward": scaled_speed.clamp(0.0, 1.0),
            "right_lane_reward": self.geo.lane_id[tgt].float(),
        }

    def _reward(self, state: EnvState, action):
        """Reference exit_env.py ``_reward``."""
        cfg = self.config
        reward = sum(cfg.get(k, 0) * v for k, v in self._rewards(state, action).items())
        if cfg["normalize_reward"]:
            reward = lmap(reward, (cfg["collision_reward"], cfg["goal_reward"]), (0.0, 1.0))
            reward = reward.clamp(0.0, 1.0)
        return reward

    def _info(self, state: EnvState, action):
        info = super()._info(state, action)
        info["is_success"] = self._is_success(state)
        return info

    def _is_terminated(self, state: EnvState):
        return state.vehicles.crashed[:, 0]

    def _is_truncated(self, state: EnvState):
        return state.time >= self.config["duration"]
