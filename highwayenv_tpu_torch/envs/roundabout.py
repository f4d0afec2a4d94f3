"""Roundabout scenario: a 2-lane ring of 8 arcs with four sine-lane accesses.

PyTorch counterpart of ``highwayenv_tpu/envs/roundabout.py`` (reference
highway_env/envs/roundabout_env.py, roundabout-v0).  The ego enters from
the south on its route to the north exit; four IDM vehicles spawn on the
ring and the east access with Gaussian jitter, each on the route to a
destination drawn uniformly among {"exr", "sxr", "nxr"} (the first one's
fixed by ``incoming_vehicle_destination`` when set).  The candidate routes
are compiled on the host and gathered by the drawn index.
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
    SineLane,
    StraightLane,
)
from highwayenv_tpu_torch.utils.config import update_config
from highwayenv_tpu_torch.utils.math import lmap
from highwayenv_tpu_torch.vehicle import controller
from highwayenv_tpu_torch.vehicle.state import KIND_EGO, KIND_IDM, VehicleState, empty_state


class RoundaboutEnv(BaseEnv):
    @classmethod
    def default_config(cls) -> dict:
        config = super().default_config()
        update_config(
            config,
            {
                "observation": {
                    "type": "Kinematics",
                    "absolute": True,
                    "features_range": {
                        "x": [-100, 100],
                        "y": [-100, 100],
                        "vx": [-15, 15],
                        "vy": [-15, 15],
                    },
                },
                "action": {
                    "type": "DiscreteMetaAction",
                    "target_speeds": [0, 8, 16],
                },
                "incoming_vehicle_destination": None,
                "collision_reward": -1,
                "high_speed_reward": 0.2,
                "right_lane_reward": 0,
                "lane_change_reward": -0.05,
                "screen_width": 600,
                "screen_height": 600,
                "centering_position": [0.5, 0.6],
                "duration": 11,
                "normalize_reward": True,
            },
        )
        return config

    def _build_scene(self):
        """Reference roundabout_env.py ``_make_road`` / ``_make_vehicles``."""
        center = [0.0, 0.0]
        radius = 20.0
        alpha = 24.0
        net = RoadNetworkBuilder()
        radii = [radius, radius + 4.0]
        n, c, s = LineType.NONE, LineType.CONTINUOUS, LineType.STRIPED
        line = [[c, s], [n, c]]
        # 8 arcs x 2 lanes on the ring se->ex->ee->nx->ne->wx->we->sx->se,
        # with the reference's phase pairs (wx->we crosses +/-180 degrees,
        # we->sx restarts at 180 - alpha); both lanes of an arc are one edge
        # and get contiguous global ids, as in the JAX package
        arcs = [
            ("se", "ex", 90 - alpha, alpha),
            ("ex", "ee", alpha, -alpha),
            ("ee", "nx", -alpha, -90 + alpha),
            ("nx", "ne", -90 + alpha, -90 - alpha),
            ("ne", "wx", -90 - alpha, -180 + alpha),
            ("wx", "we", -180 + alpha, -180 - alpha),
            ("we", "sx", 180 - alpha, 90 + alpha),
            ("sx", "se", 90 + alpha, 90 - alpha),
        ]
        for f, t, p0, p1 in arcs:
            for lane in (0, 1):
                net.add_lane(
                    f, t,
                    CircularLane(center, radii[lane], np.deg2rad(p0),
                                 np.deg2rad(p1), clockwise=False,
                                 line_types=line[lane]),
                )

        # access roads: straight approach, sine entry / exit, straight exit
        access = 170.0
        dev = 85.0
        a = 5.0
        delta_st = 0.2 * dev
        delta_en = dev - delta_st
        w = 2 * np.pi / dev
        net.add_lane("ser", "ses",
                     StraightLane([2, access], [2, dev / 2], line_types=(s, c)))
        net.add_lane("ses", "se",
                     SineLane([2 + a, dev / 2], [2 + a, dev / 2 - delta_st],
                              a, w, -np.pi / 2, line_types=(c, c)))
        net.add_lane("sx", "sxs",
                     SineLane([-2 - a, -dev / 2 + delta_en], [-2 - a, dev / 2],
                              a, w, -np.pi / 2 + w * delta_en, line_types=(c, c)))
        net.add_lane("sxs", "sxr",
                     StraightLane([-2, dev / 2], [-2, access], line_types=(n, c)))

        net.add_lane("eer", "ees",
                     StraightLane([access, -2], [dev / 2, -2], line_types=(s, c)))
        net.add_lane("ees", "ee",
                     SineLane([dev / 2, -2 - a], [dev / 2 - delta_st, -2 - a],
                              a, w, -np.pi / 2, line_types=(c, c)))
        net.add_lane("ex", "exs",
                     SineLane([-dev / 2 + delta_en, 2 + a], [dev / 2, 2 + a],
                              a, w, -np.pi / 2 + w * delta_en, line_types=(c, c)))
        net.add_lane("exs", "exr",
                     StraightLane([dev / 2, 2], [access, 2], line_types=(n, c)))

        net.add_lane("ner", "nes",
                     StraightLane([-2, -access], [-2, -dev / 2], line_types=(s, c)))
        net.add_lane("nes", "ne",
                     SineLane([-2 - a, -dev / 2], [-2 - a, -dev / 2 + delta_st],
                              a, w, -np.pi / 2, line_types=(c, c)))
        net.add_lane("nx", "nxs",
                     SineLane([2 + a, dev / 2 - delta_en], [2 + a, -dev / 2],
                              a, w, -np.pi / 2 + w * delta_en, line_types=(c, c)))
        net.add_lane("nxs", "nxr",
                     StraightLane([2, -dev / 2], [2, -access], line_types=(n, c)))

        net.add_lane("wer", "wes",
                     StraightLane([-access, 2], [-dev / 2, 2], line_types=(s, c)))
        net.add_lane("wes", "we",
                     SineLane([-dev / 2, 2 + a], [-dev / 2 + delta_st, 2 + a],
                              a, w, -np.pi / 2, line_types=(c, c)))
        net.add_lane("wx", "wxs",
                     SineLane([dev / 2 - delta_en, -2 - a], [-dev / 2, -2 - a],
                              a, w, -np.pi / 2 + w * delta_en, line_types=(c, c)))
        net.add_lane("wxs", "wxr",
                     StraightLane([-dev / 2, -2], [-access, -2], line_types=(n, c)))

        self.net = net
        self.geo = net.build(device=self.device)
        self.max_edge_lanes = 2
        self.num_slots = 5
        # longest route: ("eer", "ees") around the ring to "exr", 11 segments
        self.route_slots = 11

        # NPC spawns: (lane index, s, speed)
        spawns = [
            (("we", "sx", 1), 5.0, 16.0),
            (("we", "sx", 0), 20.0, 16.0),
            (("we", "sx", 0), -20.0, 16.0),
            (("eer", "ees", 0), 50.0, 16.0),
        ]
        destinations = ["exr", "sxr", "nxr"]
        R = self.route_slots
        routes = np.stack([
            np.stack([np.stack(net.route_arrays(idx, dest, R)[:3])
                      for dest in destinations])
            for idx, _s, _v in spawns
        ])  # (4 NPCs, 3 destinations, base / n / id, R)
        lengths = np.array([[net.route_arrays(idx, dest, R)[3]
                             for dest in destinations] for idx, _s, _v in spawns])
        dev_ = self.device
        self._npc_routes = torch.as_tensor(routes, dtype=torch.int32, device=dev_)
        self._npc_route_len = torch.as_tensor(lengths, dtype=torch.int32, device=dev_)
        ego_route = net.route_arrays(("ser", "ses", 0), "nxs", R)
        self._ego_route = torch.as_tensor(
            np.stack(ego_route[:3]), dtype=torch.int32, device=dev_
        )
        self._ego_route_len = int(ego_route[3])
        self._spawn_lane = torch.as_tensor(
            [net.global_lane_index(i) for i, _s, _v in spawns],
            dtype=torch.int32, device=dev_,
        )
        self._spawn_s = torch.as_tensor(
            [s_ for _i, s_, _v in spawns], dtype=torch.float32, device=dev_
        )
        self._ego_lane = net.global_lane_index(("ser", "ses", 0))

    def _reset_draws(self, batch: int, generator) -> dict:
        """The reset's draws, in order: the NPCs' stations, speeds and
        destinations, each (B, 4), then the IDM exponents, (B, V)."""
        B, V, dev = batch, self.num_slots, self.device
        # NPCs on their spawn lanes with Gaussian jitter
        npc_s = self._spawn_s + 2.0 * torch.randn(
            (B, 4), generator=generator, device=dev
        )
        npc_speed = 16.0 + 2.0 * torch.randn((B, 4), generator=generator, device=dev)
        dest = torch.randint(0, 3, (B, 4), generator=generator, device=dev)
        ivd = self.config["incoming_vehicle_destination"]
        if ivd is not None:
            dest[:, 0] = int(ivd)
        return {
            "s": npc_s,
            "speed": npc_speed,
            "dest": dest,
            "delta": _uniform((B, V), 3.5, 4.5, generator, dev),
        }

    def _place_vehicles(self, draws: dict) -> VehicleState:
        npc_s, npc_speed, dest = draws["s"], draws["speed"], draws["dest"]
        B, V, R, dev = npc_s.shape[0], self.num_slots, self.route_slots, self.device
        is_ego = (torch.arange(V, device=dev) == 0).expand(B, V)

        # the ego at s=125 on the south approach, heading taken at s=140
        ego_lane = torch.full((B,), self._ego_lane, dtype=torch.int32, device=dev)
        ego_pos = lane_ops.position(
            self.geo, ego_lane, torch.full((B,), 125.0, device=dev),
            torch.zeros(B, device=dev),
        )
        ego_heading = lane_ops.heading_at(
            self.geo, ego_lane, torch.full((B,), 140.0, device=dev)
        )

        npc_lane = self._spawn_lane.expand(B, 4)
        npc_pos = lane_ops.position(self.geo, npc_lane, npc_s, torch.zeros_like(npc_s))
        npc_heading = lane_ops.heading_at(self.geo, npc_lane, npc_s)

        pos = torch.cat([ego_pos[:, None], npc_pos], dim=1)
        heading = torch.cat([ego_heading[:, None], npc_heading], dim=1)
        speed = torch.cat([torch.full((B, 1), 8.0, device=dev), npc_speed], dim=1)
        lane = lane_ops.closest_lane(self.geo, pos, heading)

        npc_i = torch.arange(4, device=dev)
        npc_routes = self._npc_routes[npc_i, dest]  # (B, 4, 3, R)
        routes = torch.cat(
            [self._ego_route.expand(B, 1, 3, R), npc_routes], dim=1
        )  # (B, V, 3, R)
        route_len = torch.cat(
            [torch.full((B, 1), self._ego_route_len, dtype=torch.int32, device=dev),
             self._npc_route_len[npc_i, dest]], dim=1,
        )

        ego_index, ego_ts = controller.ego_speed_init(self.action_type, speed)
        veh = empty_state(B, V, route_slots=R, device=dev)
        return veh.replace(
            pos=pos,
            heading=heading,
            speed=speed,
            lane=lane,
            target_lane=lane.clone(),
            target_speed=torch.where(is_ego, ego_ts, speed),
            speed_index=torch.where(is_ego, ego_index, 0).to(torch.int32),
            timer=torch.remainder((pos[..., 0] + pos[..., 1]) * math.pi, 1.0),
            delta=torch.where(is_ego, 4.0, draws["delta"]),
            kind=torch.where(is_ego, KIND_EGO, KIND_IDM).to(torch.int32),
            route_base=routes[:, :, 0].contiguous(),
            route_n=routes[:, :, 1].contiguous(),
            route_id=routes[:, :, 2].contiguous(),
            route_len=route_len,
        )

    def _rewards(self, state: EnvState, action):
        """Reference roundabout_env.py ``_rewards``: the speed index over the
        DEFAULT 3-speed grid."""
        veh = state.vehicles
        return {
            "collision_reward": veh.crashed[:, 0].float(),
            "high_speed_reward": veh.speed_index[:, 0]
            / (len(controller.DEFAULT_TARGET_SPEEDS) - 1),
            "lane_change_reward": ((action == 0) | (action == 2)).float(),
            "on_road_reward": self.ego_on_road(state).float(),
        }

    def _reward(self, state: EnvState, action):
        """Reference roundabout_env.py ``_reward``."""
        cfg = self.config
        rewards = self._rewards(state, action)
        reward = sum(cfg.get(k, 0) * v for k, v in rewards.items())
        if cfg["normalize_reward"]:
            reward = lmap(
                reward, (cfg["collision_reward"], cfg["high_speed_reward"]), (0.0, 1.0)
            )
        return reward * rewards["on_road_reward"]

    def _is_terminated(self, state: EnvState):
        return state.vehicles.crashed[:, 0]

    def _is_truncated(self, state: EnvState):
        return state.time >= self.config["duration"]
