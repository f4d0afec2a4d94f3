"""Racetrack: a closed loop of 2-lane straight and circular sections,
lateral-only continuous control, occupancy-grid observation.

PyTorch counterpart of ``highwayenv_tpu/envs/racetrack.py`` (reference
highway_env/envs/racetrack_env.py, racetrack-v0, racetrack-large-v0 and
racetrack-oval-v0).  The first ego spawns on a random lane of the first
straight ("a", "b") at s ~ U(20, 50) and the lane's speed limit, the other
``controlled_vehicles`` on random lanes of the track at stations drawn
alike, one IDM vehicle ahead of the first on the same lane of the first arc
("b", "c"); further NPCs (with ``other_vehicles`` > 1) on random lanes,
dropped when within 20 m of an earlier vehicle.  The egos' ContinuousAction
stores their steering (the frame kernels keep it: their raw-control
branch).  With several egos the reward is one number an env: its action
term is the norm of all the egos' actions together, the reference's
``np.linalg.norm`` of the action tuple.  The oval draws its length and
lane count on the host when the env is built, as the JAX package does, and
may hold roadblock obstacles in its last slots.
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
from highwayenv_tpu_torch.vehicle.state import (
    KIND_EGO,
    KIND_IDM,
    KIND_OBSTACLE,
    KIND_PAD,
    OBJECT_LENGTH,
    OBJECT_WIDTH,
    VehicleState,
    empty_state,
)


def _racetrack_network() -> RoadNetworkBuilder:
    """The 8-section track (reference racetrack_env.py ``_make_road``)."""
    net = RoadNetworkBuilder()
    c, s, n = LineType.CONTINUOUS, LineType.STRIPED, LineType.NONE
    sl = 10.0
    rad = np.deg2rad
    # 1 - straight
    net.add_lane("a", "b", StraightLane([42, 0], [100, 0], width=5,
                                        line_types=(c, s), speed_limit=sl))
    net.add_lane("a", "b", StraightLane([42, 5], [100, 5], width=5,
                                        line_types=(s, c), speed_limit=sl))
    # 2 - arc 1
    net.add_lane("b", "c", CircularLane([100, -20], 20, rad(90), rad(-1), width=5,
                                        clockwise=False, line_types=(c, n), speed_limit=sl))
    net.add_lane("b", "c", CircularLane([100, -20], 25, rad(90), rad(-1), width=5,
                                        clockwise=False, line_types=(s, c), speed_limit=sl))
    # 3 - vertical straight
    net.add_lane("c", "d", StraightLane([120, -20], [120, -30], width=5,
                                        line_types=(c, n), speed_limit=sl))
    net.add_lane("c", "d", StraightLane([125, -20], [125, -30], width=5,
                                        line_types=(s, c), speed_limit=sl))
    # 4 - arc 2
    net.add_lane("d", "e", CircularLane([105, -30], 15, rad(0), rad(-181), width=5,
                                        clockwise=False, line_types=(c, n), speed_limit=sl))
    net.add_lane("d", "e", CircularLane([105, -30], 20, rad(0), rad(-181), width=5,
                                        clockwise=False, line_types=(s, c), speed_limit=sl))
    # 5 - arc 3 (clockwise)
    net.add_lane("e", "f", CircularLane([70, -30], 20, rad(0), rad(136), width=5,
                                        clockwise=True, line_types=(c, s), speed_limit=sl))
    net.add_lane("e", "f", CircularLane([70, -30], 15, rad(0), rad(137), width=5,
                                        clockwise=True, line_types=(n, c), speed_limit=sl))
    # 6 - slant
    net.add_lane("f", "g", StraightLane([55.7, -15.7], [35.7, -35.7], width=5,
                                        line_types=(c, n), speed_limit=sl))
    net.add_lane("f", "g", StraightLane([59.3934, -19.2], [39.3934, -39.2], width=5,
                                        line_types=(s, c), speed_limit=sl))
    # 7 - arc 4 (two sections)
    net.add_lane("g", "h", CircularLane([18.1, -18.1], 25, rad(315), rad(170), width=5,
                                        clockwise=False, line_types=(c, n), speed_limit=sl))
    net.add_lane("g", "h", CircularLane([18.1, -18.1], 30, rad(315), rad(165), width=5,
                                        clockwise=False, line_types=(s, c), speed_limit=sl))
    net.add_lane("h", "i", CircularLane([18.1, -18.1], 25, rad(170), rad(56), width=5,
                                        clockwise=False, line_types=(c, n), speed_limit=sl))
    net.add_lane("h", "i", CircularLane([18.1, -18.1], 30, rad(170), rad(58), width=5,
                                        clockwise=False, line_types=(s, c), speed_limit=sl))
    # 8 - arc 5, back to the start (clockwise)
    net.add_lane("i", "a", CircularLane([43.2, 23.4], 23.5, rad(240), rad(270), width=5,
                                        clockwise=True, line_types=(c, s), speed_limit=sl))
    net.add_lane("i", "a", CircularLane([43.2, 23.4], 18.5, rad(238), rad(268), width=5,
                                        clockwise=True, line_types=(n, c), speed_limit=sl))
    return net


class RacetrackEnv(BaseEnv):
    several_egos = True

    @classmethod
    def default_config(cls) -> dict:
        config = super().default_config()
        update_config(
            config,
            {
                "observation": {
                    "type": "OccupancyGrid",
                    "features": ["presence", "on_road"],
                    "grid_size": [[-18, 18], [-18, 18]],
                    "grid_step": [3, 3],
                    "as_image": False,
                    "align_to_vehicle_axes": True,
                },
                "action": {
                    "type": "ContinuousAction",
                    "longitudinal": False,
                    "lateral": True,
                    "target_speeds": [0, 5, 10],
                },
                "simulation_frequency": 15,
                "policy_frequency": 5,
                "duration": 300,
                "collision_reward": -1,
                "lane_centering_cost": 4,
                "lane_centering_reward": 1,
                "action_reward": -0.3,
                "controlled_vehicles": 1,
                "other_vehicles": 1,
                "screen_width": 600,
                "screen_height": 600,
                "centering_position": [0.5, 0.5],
                "speed_limit": 10.0,
                "terminate_off_road": True,
            },
        )
        return config

    def _make_network(self) -> RoadNetworkBuilder:
        return _racetrack_network()

    @property
    def ego_slots(self):
        return tuple(range(self.config["controlled_vehicles"]))

    def _build_scene(self):
        cfg = self.config
        self.net = self._make_network()
        self.geo = self.net.build(device=self.device)
        self.max_edge_lanes = max(len(v) for v in self.net.edges.values())
        n_ctrl = cfg["controlled_vehicles"]
        n_other = cfg["other_vehicles"]
        self.num_slots = n_ctrl + max(n_other, 1)
        # the NPCs past the first, each kept unless within 20 m of an
        # earlier vehicle; the slots from n_ctrl + 1 + n_extra on are
        # the oval's roadblocks
        self._n_extra = max(n_other - 1, 0)
        # lanes of the ("a", "b") and ("b", "c") edges, for the spawns
        self._ab_base = self.net.global_lane_index(("a", "b", 0))
        self._ab_lanes = len(self.net.lanes_on_edge("a", "b"))
        self._bc_base = self.net.global_lane_index(("b", "c", 0))
        self._bc_length = float(self.net.get_lane(("b", "c", 0)).length)

    def _reset_draws(self, batch: int, generator) -> dict:
        """The reset's draws, in order (the JAX package's key order): the
        first ego's lane on ("a", "b") and station, the front NPC's station
        and speed, the count of extra NPCs, then their lanes, stations (a
        share of the lane's length) and speeds, each (B,) or (B, n_extra);
        with several egos last the other egos' lanes (any lane of the
        track) and stations, (B, n_ctrl - 1)."""
        B, dev = batch, self.device
        n_other, E, L = self.config["other_vehicles"], self._n_extra, self.geo.num_lanes
        n_more = len(self.ego_slots) - 1
        more = {} if not n_more else {
            "more_ego_lane": torch.randint(0, L, (B, n_more), generator=generator,
                                           device=dev, dtype=torch.int32),
            "more_ego_s": _uniform((B, n_more), 20.0, 50.0, generator, dev),
        }
        return {
            "ego_lane": torch.randint(0, self._ab_lanes, (B,), generator=generator,
                                      device=dev, dtype=torch.int32),
            "ego_s": _uniform((B,), 20.0, 50.0, generator, dev),
            "front_s": _uniform((B,), 0.0, self._bc_length, generator, dev),
            "front_speed": 6.0 + _uniform((B,), 0.0, 3.0, generator, dev),
            "extra_count": torch.randint(0, max(n_other, 1), (B,), generator=generator,
                                         device=dev, dtype=torch.int32),
            "extra_lane": torch.randint(0, L, (B, E), generator=generator, device=dev,
                                        dtype=torch.int32),
            "extra_u": _uniform((B, E), 0.0, 1.0, generator, dev),
            "extra_speed": 6.0 + _uniform((B, E), 0.0, 3.0, generator, dev),
            **more,
        }

    def _place_vehicles(self, draws: dict) -> VehicleState:
        """Reference racetrack_env.py ``_make_vehicles``: the egos in slots
        0 .. n_ctrl - 1, the front NPC after them, then the extras."""
        ego_lane = (self._ab_base + draws["ego_lane"])[:, None]
        ego_s = draws["ego_s"][:, None]
        if "more_ego_lane" in draws:
            ego_lane = torch.cat([ego_lane, draws["more_ego_lane"]], dim=1)
            ego_s = torch.cat([ego_s, draws["more_ego_s"]], dim=1)
        n_ctrl = ego_lane.shape[1]
        B, V, E, dev = ego_lane.shape[0], self.num_slots, self._n_extra, self.device
        front_lane = self._bc_base + draws["ego_lane"]
        extra_lane = draws["extra_lane"]
        lane = torch.cat([ego_lane, front_lane[:, None], extra_lane], dim=1)
        s = torch.cat([ego_s, draws["front_s"][:, None],
                       draws["extra_u"] * self.geo.length[extra_lane.long()]], dim=1)
        # make_on_lane(speed=None): the egos at their lanes' speed limits
        speed = torch.cat([self.geo.speed_limit[ego_lane.long()],
                           draws["front_speed"][:, None], draws["extra_speed"]], dim=1)
        pos = lane_ops.position(self.geo, lane, s, torch.zeros_like(s))
        heading = lane_ops.heading_at(self.geo, lane, s)

        n_veh = n_ctrl + 1 + E  # < V when the oval keeps roadblock slots
        extra_on = torch.arange(E, device=dev) < draws["extra_count"][:, None]
        kind = torch.cat([
            torch.full((B, n_ctrl), KIND_EGO, dtype=torch.int32, device=dev),
            torch.full((B, 1), KIND_IDM, dtype=torch.int32, device=dev),
            torch.where(extra_on, KIND_IDM, KIND_PAD).to(torch.int32),
        ], dim=1)
        # "prevent early collisions": drop the extras within 20 m of an
        # earlier vehicle
        d = torch.linalg.vector_norm(pos[:, :, None] - pos[:, None, :], dim=-1)
        order = torch.arange(n_veh, device=dev)
        earlier = (order[None, :] < order[:, None]) & (kind[:, None, :] != KIND_PAD)
        too_close = (earlier & (d < 20.0)).any(dim=-1)
        kind = torch.where((order > n_ctrl) & too_close, KIND_PAD, kind).to(torch.int32)

        veh = empty_state(B, V, device=dev)
        i = slice(0, n_veh)
        fields = {
            "pos": pos, "heading": heading, "speed": speed, "lane": lane,
            "target_lane": lane, "target_speed": speed,
            "timer": torch.remainder((pos[..., 0] + pos[..., 1]) * math.pi, 1.0),
            "kind": kind,
        }
        for name, value in fields.items():
            getattr(veh, name)[:, i] = value
        return veh

    def _rewards(self, state: EnvState, action):
        """Reference racetrack_env.py ``_rewards``."""
        veh = state.vehicles
        ego = self.ego_slots[0]
        _, lat = lane_ops.local_coordinates(self.geo, veh.lane[:, ego], veh.pos[:, ego])
        # one norm an env over every ego's action: (B,), (B, size) or
        # (B, n_agents, size) flattened
        a = action.to(torch.float32).reshape(action.shape[0], -1)
        return {
            "lane_centering_reward": 1.0
            / (1.0 + self.config["lane_centering_cost"] * lat**2),
            "action_reward": torch.linalg.vector_norm(a, dim=-1),
            "collision_reward": veh.crashed[:, ego].float(),
            "on_road_reward": self.ego_on_road(state).float(),
        }

    def _reward(self, state: EnvState, action):
        """Reference racetrack_env.py ``_reward``."""
        cfg = self.config
        rewards = self._rewards(state, action)
        reward = sum(cfg.get(k, 0) * v for k, v in rewards.items())
        reward = lmap(reward, (cfg["collision_reward"], 1.0), (0.0, 1.0))
        return reward * rewards["on_road_reward"]

    def _is_terminated(self, state: EnvState):
        crashed = state.vehicles.crashed[:, self.ego_slots[0]]
        if self.config["terminate_off_road"]:
            return crashed | ~self.ego_on_road(state)
        return crashed

    def _is_truncated(self, state: EnvState):
        return state.time >= self.config["duration"]


class RacetrackEnvLarge(RacetrackEnv):
    """racetrack-large: the 3-lane map, built from the geometry table."""

    def _make_network(self) -> RoadNetworkBuilder:
        from highwayenv_tpu_torch.envs._racetrack_large_data import RACETRACK_LARGE_LANES

        net = RoadNetworkBuilder()
        for f, t, kind, params, lt, sl, width in RACETRACK_LARGE_LANES:
            if kind == "straight":
                start, end = params
                net.add_lane(f, t, StraightLane(start, end, width=width, line_types=lt,
                                                speed_limit=sl))
            else:
                center, radius, p0, p1, cw = params
                net.add_lane(f, t, CircularLane(center, radius, p0, p1, clockwise=cw,
                                                width=width, line_types=lt, speed_limit=sl))
        return net


class RacetrackEnvOval(RacetrackEnv):
    """The oval racetrack with a parametric length, lane count and
    roadblocks (reference racetrack_env.py ``RacetrackEnvOval``)."""

    @classmethod
    def default_config(cls) -> dict:
        config = super().default_config()
        update_config(
            config,
            {
                "length": 100,  # 0: random in [100, 200), drawn on the host
                "no_lanes": 3,  # 0: random in [2, 7)
                "block_lane": False,
                "force_decision": False,
            },
        )
        return config

    def _make_network(self) -> RoadNetworkBuilder:
        cfg = self.config
        rng = np.random.default_rng()  # a fresh generator, as the reference's
        length = cfg["length"] or int(rng.integers(100, 200))
        no_lanes = cfg["no_lanes"] or int(rng.integers(2, 7))
        self._oval_length = length
        self._oval_lanes = no_lanes

        net = RoadNetworkBuilder()
        c, s, n = LineType.CONTINUOUS, LineType.STRIPED, LineType.NONE
        sl = 10.0
        rad = np.deg2rad

        def lines(i):
            first, last = i == 0, i == no_lanes - 1
            return (c, n) if first else ((s, c) if last else (s, n))

        for i in range(no_lanes):
            first, last = i == 0, i == no_lanes - 1
            net.add_lane("a", "b", StraightLane(
                [0, i * 5], [length + 1, i * 5], width=5, speed_limit=sl,
                line_types=(c, s) if first else ((s, c) if last else (s, n)),
            ))
        for i in range(no_lanes):
            net.add_lane("b", "c", CircularLane(
                [length, -20], 20 + i * 5, rad(90), rad(0), width=5, clockwise=False,
                speed_limit=sl, line_types=lines(i),
            ))
        for i in range(no_lanes):
            net.add_lane("c", "d", StraightLane(
                [length + 20 + i * 5, -20], [length + 20 + i * 5, -50], width=5,
                speed_limit=sl, line_types=lines(i),
            ))
        for i in range(no_lanes):
            net.add_lane("d", "e", CircularLane(
                [length + 5, -50], 15 + i * 5, rad(0), rad(-90), width=5, clockwise=False,
                speed_limit=sl, line_types=lines(i),
            ))
        for i in range(no_lanes):
            net.add_lane("e", "f", StraightLane(
                [length + 5, -(65 + i * 5)], [-5, -(65 + i * 5)], width=5,
                speed_limit=sl, line_types=lines(i),
            ))
        for i in range(no_lanes):
            net.add_lane("f", "g", CircularLane(
                [-5, -50], 15 + i * 5, rad(-90), rad(-180), width=5, clockwise=False,
                speed_limit=sl, line_types=lines(i),
            ))
        for i in range(no_lanes):
            net.add_lane("g", "h", StraightLane(
                [-20 - i * 5, -50], [-20 - i * 5, -20], width=5, speed_limit=sl,
                line_types=lines(i),
            ))
        for i in range(no_lanes):
            net.add_lane("h", "a", CircularLane(
                [0, -20], 20 + i * 5, rad(180), rad(90), width=5, clockwise=False,
                speed_limit=sl, line_types=(c, n) if i == 0 else (s, c),
            ))
        return net

    def _build_scene(self):
        super()._build_scene()
        cfg = self.config
        # roadblocks (reference racetrack_env.py RacetrackEnvOval._make_vehicles)
        blocks = []
        length = self._oval_length
        if cfg["block_lane"]:
            for i in (40.0, 43.0, 46.0, 49.0):
                blocks.append([length - i, 3.75])
                blocks.append([length - i, 6.25])
        if cfg["force_decision"]:
            for i in (-1.25, 1.25, 8.85, 11.25):
                blocks.append([length - 90.0, i])
        self._blocks = torch.as_tensor(
            np.asarray(blocks, np.float32).reshape(-1, 2), device=self.device
        )
        self.num_slots += len(blocks)

    def _place_vehicles(self, draws: dict) -> VehicleState:
        veh = super()._place_vehicles(draws)
        nb = self._blocks.shape[0]
        if nb:
            sl = slice(self.num_slots - nb, self.num_slots)
            veh.pos[:, sl] = self._blocks
            veh.kind[:, sl] = KIND_OBSTACLE
            veh.length[:, sl] = OBJECT_LENGTH
            veh.width[:, sl] = OBJECT_WIDTH
            veh.heading[:, sl] = 0.0
            veh.speed[:, sl] = 0.0
        return veh
