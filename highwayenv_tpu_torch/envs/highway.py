"""Highway scenario: straight multi-lane road, IDM traffic, speed reward.

PyTorch counterpart of ``highwayenv_tpu/envs/highway.py`` (reference
highway_env/envs/highway_env.py, highway-v0 and highway-fast-v0).  The
reference's sequential spawn chain (each vehicle placed ahead of the
current front-most) is a cumulative sum over per-slot random offsets, valid
because all lanes of the straight road share one longitudinal axis.
"""

from __future__ import annotations

import math

import torch

from highwayenv_tpu_torch.envs.base import BaseEnv, EnvState
from highwayenv_tpu_torch.road import lane as lane_ops
from highwayenv_tpu_torch.road.network import RoadNetworkBuilder
from highwayenv_tpu_torch.utils.config import update_config
from highwayenv_tpu_torch.utils.math import lmap
from highwayenv_tpu_torch.vehicle import controller
from highwayenv_tpu_torch.vehicle.state import (
    KIND_EGO,
    KIND_IDM,
    VehicleState,
    empty_state,
)


def near_split(x, num_bins):
    """Reference utils.py ``near_split``."""
    quotient, remainder = divmod(x, num_bins)
    return [quotient + 1] * remainder + [quotient] * (num_bins - remainder)


def _uniform(shape, lo, hi, generator, device):
    """U[lo, hi) float32 as jax.random.uniform forms it."""
    u = torch.rand(shape, generator=generator, device=device)
    return torch.clamp(u * (hi - lo) + lo, min=lo)


class HighwayEnv(BaseEnv):
    #: ``controlled_vehicles`` egos, each ahead of its share of the NPCs;
    #: the reward, termination and info read the first (the reference's
    #: ``self.vehicle``)
    several_egos = True

    @classmethod
    def default_config(cls) -> dict:
        config = super().default_config()
        update_config(
            config,
            {
                "observation": {"type": "Kinematics"},
                "action": {"type": "DiscreteMetaAction"},
                "lanes_count": 4,
                "vehicles_count": 50,
                "controlled_vehicles": 1,
                "initial_lane_id": None,
                "duration": 40,
                "ego_spacing": 2,
                "vehicles_density": 1,
                "collision_reward": -1,
                "right_lane_reward": 0.1,
                "high_speed_reward": 0.4,
                "lane_change_reward": 0,
                "reward_speed_range": [20, 30],
                "normalize_reward": True,
                "offroad_terminal": False,
            },
        )
        return config

    def _build_scene(self):
        cfg = self.config
        self.net = RoadNetworkBuilder.straight_road_network(
            cfg["lanes_count"], speed_limit=30
        )
        self.geo = self.net.build(device=self.device)
        self.obs_edge_lanes = cfg["lanes_count"]  # ego reset edge (PARITY #5)
        self.max_edge_lanes = cfg["lanes_count"]
        n_ctrl = cfg["controlled_vehicles"]
        self.others_per_controlled = near_split(cfg["vehicles_count"], n_ctrl)
        self.num_slots = n_ctrl + cfg["vehicles_count"]
        # creation order: [ego_0, npcs..., ego_1, npcs...]
        slots = []
        self._ego_slots = []
        for others in self.others_per_controlled:
            self._ego_slots.append(len(slots))
            slots.append("ego")
            slots.extend(["npc"] * others)
        self._is_ego_slot = torch.tensor([s == "ego" for s in slots], device=self.device)
        self._npc_check_collisions = True

    @property
    def ego_slots(self):
        return tuple(self._ego_slots)

    def _reset_draws(self, batch: int, generator) -> dict:
        """The reset's draws, in order: lanes, NPC speeds, spawn-gap
        factors and IDM exponents, each (B, V)."""
        cfg = self.config
        B, V, dev = batch, self.num_slots, self.device
        lane = torch.randint(
            0, cfg["lanes_count"], (B, V), generator=generator, device=dev,
            dtype=torch.int32,
        )
        if cfg["initial_lane_id"] is not None:
            lane = torch.where(
                self._is_ego_slot, cfg["initial_lane_id"], lane
            ).to(torch.int32)
        speed_limit = self.geo.speed_limit[lane.long()]
        return {
            "lane": lane,
            "npc_speed": _uniform(
                (B, V), 0.7 * speed_limit, 0.8 * speed_limit, generator, dev
            ),
            "gap": _uniform((B, V), 0.9, 1.1, generator, dev),
            "delta": _uniform((B, V), 3.5, 4.5, generator, dev),
        }

    def _place_vehicles(self, draws: dict) -> VehicleState:
        cfg = self.config
        lane = draws["lane"]
        B, V = lane.shape
        is_ego = self._is_ego_slot.expand(B, V)
        speed = torch.where(is_ego, 25.0, draws["npc_speed"])

        # create_random spawn chain (reference vehicle/kinematics.py)
        spacing = torch.where(
            is_ego, float(cfg["ego_spacing"]), 1.0 / cfg["vehicles_density"]
        )
        offset = (spacing * (12.0 + 1.0 * speed)
                  * math.exp(-5.0 / 40.0 * cfg["lanes_count"]))
        delta_x = offset * draws["gap"]
        delta_x[:, 0] += 3.0 * offset[:, 0]  # empty-road head start
        x0 = torch.cumsum(delta_x, dim=1)
        pos = lane_ops.position(self.geo, lane, x0, torch.zeros_like(x0))
        heading = lane_ops.heading_at(self.geo, lane, x0)

        ego_index, ego_target_speed = controller.ego_speed_init(
            self.action_type, speed
        )
        veh = empty_state(B, V, device=self.device)
        return veh.replace(
            pos=pos,
            heading=heading.contiguous(),
            speed=speed,
            lane=lane,
            target_lane=lane.clone(),
            target_speed=torch.where(is_ego, ego_target_speed, speed),
            speed_index=torch.where(is_ego, ego_index, 0).to(torch.int32),
            timer=torch.remainder((pos[..., 0] + pos[..., 1]) * math.pi, 1.0),
            delta=torch.where(is_ego, 4.0, draws["delta"]),
            kind=torch.where(is_ego, KIND_EGO, KIND_IDM).to(torch.int32),
            check_collisions=is_ego | bool(self._npc_check_collisions),
        )

    def _rewards(self, state: EnvState, action):
        """Reference highway_env.py ``_rewards``."""
        cfg = self.config
        veh = state.vehicles
        ego = self.ego_slots[0]
        n_neighbours = self.geo.edge_n[lane_ops._gather(self.geo, veh.lane[:, ego])]
        lane = self.geo.lane_id[lane_ops._gather(self.geo, veh.target_lane[:, ego])]
        forward_speed = veh.speed[:, ego] * torch.cos(veh.heading[:, ego])
        scaled_speed = lmap(forward_speed, cfg["reward_speed_range"], (0.0, 1.0))
        return {
            "collision_reward": veh.crashed[:, ego].float(),
            "right_lane_reward": lane / torch.clamp(n_neighbours - 1, min=1),
            "high_speed_reward": scaled_speed.clamp(0.0, 1.0),
            "on_road_reward": self.ego_on_road(state).float(),
        }

    def _reward(self, state: EnvState, action):
        """Reference highway_env.py ``_reward``."""
        cfg = self.config
        rewards = self._rewards(state, action)
        reward = sum(cfg.get(name, 0) * value for name, value in rewards.items())
        if cfg["normalize_reward"]:
            reward = lmap(
                reward,
                (
                    cfg["collision_reward"],
                    cfg["high_speed_reward"] + cfg["right_lane_reward"],
                ),
                (0.0, 1.0),
            )
        return reward * rewards["on_road_reward"]

    def _is_terminated(self, state: EnvState):
        crashed = state.vehicles.crashed[:, self.ego_slots[0]]
        if self.config["offroad_terminal"]:
            return crashed | ~self.ego_on_road(state)
        return crashed

    def _is_truncated(self, state: EnvState):
        return state.time >= self.config["duration"]


class HighwayEnvFast(HighwayEnv):
    """highway-fast-v0 (reference highway_env.py ``HighwayEnvFast``)."""

    @classmethod
    def default_config(cls) -> dict:
        cfg = super().default_config()
        update_config(
            cfg,
            {
                "simulation_frequency": 5,
                "lanes_count": 3,
                "vehicles_count": 20,
                "duration": 30,
                "ego_spacing": 1.5,
            },
        )
        return cfg

    def _build_scene(self):
        super()._build_scene()
        self._npc_check_collisions = False
