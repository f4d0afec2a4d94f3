"""Four-way regulated intersection with a changing vehicle population.

PyTorch counterpart of ``highwayenv_tpu/envs/intersection.py`` (reference
highway_env/envs/intersection_env.py: intersection-v0, and with the
connected-lane neighbour search intersection-v2; ``MultiAgentIntersectionEnv``
is intersection-multi-agent-v0 and -v2, two egos; ``ContinuousIntersectionEnv``
is intersection-v1, a dynamical ContinuousAction ego).  Four corners of
five lanes each (incoming, right turn, left turn, straight, exit) on a
regulated road: every ``sim_freq // 2`` frames the right-of-way pass makes
the lower-priority vehicle of each predicted conflict yield.  The padded
slots hold 9 initial NPCs, the challenger, one runtime spawn slot per policy
step and the ego in the last slot; a spawn claims a free slot and a leaving
NPC frees its own.

The reset spawns the initial NPCs, runs 3 s of traffic on their slots
(one launch of the regulated frame kernel K5 on CUDA, its plain version on
the CPU), then places the challenger and the ego and drops the NPCs within
20 m of the ego.  A spawn is split into its draws (``spawn_draws``) and
their placement (``place_spawn``), so a test can feed the placement the
JAX package's own draws.

Under a Linear-family ``other_vehicles_type`` the preset goes on the placed
scene after the warm-up (``BaseEnv._place_state``), so the warm-up drives
IDM rows only, and a spawn during the episode places an IDM vehicle: both
as the JAX package does (``highwayenv_tpu/envs/intersection.py``), where
the reference spawns the configured class everywhere.

Draw order.  A reset draws from its generator, in this order: the spawn
draws of the 9 initial NPCs and the challenger as (B, 10) tensors (accept
uniform, corner, destination offset, station normal, speed normal, IDM
exponent), then the ego's destination and its station normal as (B, 1)
tensors.  The step's population hook draws the spawn draws of one attempt as
(B,) tensors, before the step's full reset batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from highwayenv_tpu_torch.envs.base import BaseEnv, EnvState
from highwayenv_tpu_torch.envs.highway import _uniform
from highwayenv_tpu_torch.ops import general_frames
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
from highwayenv_tpu_torch.vehicle.behavior import IDMParams
from highwayenv_tpu_torch.vehicle.state import (
    KIND_EGO,
    KIND_IDM,
    KIND_PAD,
    VehicleState,
    empty_state,
)


def intersection_network() -> RoadNetworkBuilder:
    """Reference intersection_env.py ``_make_road``: priorities 3 on the
    horizontal roads, 1 on the vertical ones, one less on each left turn;
    speed limit 10 everywhere."""
    lane_width = 4.0
    right_turn_radius = lane_width + 5.0
    left_turn_radius = right_turn_radius + lane_width
    outer_distance = right_turn_radius + lane_width / 2
    access_length = 100.0

    net = RoadNetworkBuilder()
    n, c, s = LineType.NONE, LineType.CONTINUOUS, LineType.STRIPED
    for corner in range(4):
        angle = np.radians(90 * corner)
        priority = 3 if corner % 2 else 1
        rotation = np.array(
            [[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]]
        )
        # incoming
        start = rotation @ np.array([lane_width / 2, access_length + outer_distance])
        end = rotation @ np.array([lane_width / 2, outer_distance])
        net.add_lane(
            f"o{corner}", f"ir{corner}",
            StraightLane(start, end, line_types=[s, c], priority=priority,
                         speed_limit=10.0),
        )
        # right turn
        r_center = rotation @ np.array([outer_distance, outer_distance])
        net.add_lane(
            f"ir{corner}", f"il{(corner - 1) % 4}",
            CircularLane(r_center, right_turn_radius,
                         angle + np.radians(180), angle + np.radians(270),
                         line_types=[n, c], priority=priority, speed_limit=10.0),
        )
        # left turn
        l_center = rotation @ np.array(
            [-left_turn_radius + lane_width / 2, left_turn_radius - lane_width / 2]
        )
        net.add_lane(
            f"ir{corner}", f"il{(corner + 1) % 4}",
            CircularLane(l_center, left_turn_radius,
                         angle + np.radians(0), angle + np.radians(-90),
                         clockwise=False, line_types=[n, n],
                         priority=priority - 1, speed_limit=10.0),
        )
        # straight
        start = rotation @ np.array([lane_width / 2, outer_distance])
        end = rotation @ np.array([lane_width / 2, -outer_distance])
        net.add_lane(
            f"ir{corner}", f"il{(corner + 2) % 4}",
            StraightLane(start, end, line_types=[s, n], priority=priority,
                         speed_limit=10.0),
        )
        # exit
        start = rotation @ np.flip([lane_width / 2, access_length + outer_distance], axis=0)
        end = rotation @ np.flip([lane_width / 2, outer_distance], axis=0)
        net.add_lane(
            f"il{(corner - 1) % 4}", f"o{(corner - 1) % 4}",
            StraightLane(end, start, line_types=[n, c], priority=priority,
                         speed_limit=10.0),
        )
    return net


class SpawnDraws(NamedTuple):
    """The random numbers of spawn attempts, one per entry (the JAX
    package's six keys of ``_spawn_into_slot``)."""

    accept: torch.Tensor  # U[0, 1): the attempt goes on when <= the probability
    corner: torch.Tensor  # int in [0, 4): the spawn corner
    offset: torch.Tensor  # int in [1, 4): destination corner = corner + offset
    station: torch.Tensor  # N(0, 1): the station's deviation
    speed: torch.Tensor  # N(0, 1): the speed's deviation
    delta: torch.Tensor  # U[3.5, 4.5): the IDM exponent

    def at(self, k: int) -> "SpawnDraws":
        """The draws of column ``k`` of (B, n) draws."""
        return SpawnDraws(*(x[:, k] for x in self))


class IntersectionEnv(BaseEnv):
    regulated = True
    several_egos = True

    @classmethod
    def default_config(cls) -> dict:
        config = super().default_config()
        update_config(
            config,
            {
                "observation": {
                    "type": "Kinematics",
                    "vehicles_count": 15,
                    "features": ["presence", "x", "y", "vx", "vy", "cos_h", "sin_h"],
                    "features_range": {
                        "x": [-100, 100],
                        "y": [-100, 100],
                        "vx": [-20, 20],
                        "vy": [-20, 20],
                    },
                    "absolute": True,
                    "flatten": False,
                    "observe_intentions": False,
                },
                "action": {
                    "type": "DiscreteMetaAction",
                    "longitudinal": True,
                    "lateral": False,
                    "target_speeds": [0, 4.5, 9],
                },
                "duration": 13,
                "destination": "o1",
                "controlled_vehicles": 1,
                "initial_vehicle_count": 10,
                "spawn_probability": 0.6,
                "screen_width": 600,
                "screen_height": 600,
                "centering_position": [0.5, 0.6],
                "scaling": 5.5 * 1.3,
                "collision_reward": -5,
                "high_speed_reward": 1,
                "arrived_reward": 1,
                "reward_speed_range": [7.0, 9.0],
                "normalize_reward": False,
                "offroad_terminal": False,
            },
        )
        return config

    def _idm_params(self) -> IDMParams:
        """The low jam distance tuning of the reference's NPCs."""
        return IDMParams(distance_wanted=7.0, comfort_acc_max=6.0, comfort_acc_min=-3.0)

    def _build_scene(self):
        cfg = self.config
        dev = self.device
        self.net = intersection_network()
        self.geo = self.net.build(device=dev)
        self.max_edge_lanes = 1
        self.route_slots = 3
        # the frame counter counts the 3 s warm-up of the reset
        self._initial_steps = 3 * cfg["simulation_frequency"]

        n_init = cfg["initial_vehicle_count"]
        # one spawn attempt per policy step
        n_spawn = int(cfg["duration"] * cfg["policy_frequency"]) + 1
        self._n_npc = (n_init - 1) + 1 + n_spawn
        self.num_slots = self._n_npc + cfg["controlled_vehicles"]
        self._ego_slots = tuple(range(self._n_npc, self.num_slots))

        # (4, 4, R) routes from corner i to corner j
        R = self.route_slots
        rb = np.full((4, 4, R), -1, np.int32)
        rn = np.zeros((4, 4, R), np.int32)
        rid = np.full((4, 4, R), -1, np.int32)
        rlen = np.zeros((4, 4), np.int32)
        for i in range(4):
            for j in range(4):
                if i != j:
                    rb[i, j], rn[i, j], rid[i, j], rlen[i, j] = self.net.route_arrays(
                        (f"o{i}", f"ir{i}", 0), f"o{j}", R
                    )
        self._routes = tuple(torch.as_tensor(x, device=dev) for x in (rb, rn, rid, rlen))
        self._spawn_lane = torch.as_tensor(
            [self.net.global_lane_index((f"o{i}", f"ir{i}", 0)) for i in range(4)],
            dtype=torch.int32, device=dev,
        )
        # the exit lanes, from an "il" node to an "o" node
        exit_mask = [f.startswith("il") and t.startswith("o")
                     for (f, t), lanes in self.net.edges.items() for _ in lanes]
        self._exit_lane_mask = torch.as_tensor(exit_mask, device=dev)

    @property
    def ego_slots(self):
        return self._ego_slots

    # ------------------------------------------------------------------ #
    # spawning
    # ------------------------------------------------------------------ #
    def spawn_draws(self, shape, generator) -> SpawnDraws:
        """The draws of spawn attempts of the given shape, in field order."""
        dev = self.device
        return SpawnDraws(
            accept=torch.rand(shape, generator=generator, device=dev),
            corner=torch.randint(0, 4, shape, generator=generator, device=dev),
            offset=torch.randint(1, 4, shape, generator=generator, device=dev),
            station=torch.randn(shape, generator=generator, device=dev),
            speed=torch.randn(shape, generator=generator, device=dev),
            delta=_uniform(shape, 3.5, 4.5, generator, dev),
        )

    def place_spawn(self, veh: VehicleState, slot, draws: SpawnDraws,
                    longitudinal: float, position_deviation: float = 1.0,
                    speed_deviation: float = 1.0, spawn_probability: float = 0.6,
                    go_straight: bool = False) -> VehicleState:
        """Reference ``_spawn_vehicle`` into ``slot`` (an int, or a (B,)
        tensor of slots) of each env, from one attempt's (B,) draws: an IDM
        vehicle on the incoming lane of the drawn corner, routed to another
        corner (the opposite one when ``go_straight``).  The attempt places
        nothing where it is not accepted, where an active object lies within
        15 m of the spawn point, or where the slot is taken."""
        B, V = veh.kind.shape
        dev = veh.speed.device
        corner = draws.corner.long()
        dest = (corner + (2 if go_straight else draws.offset.long())) % 4
        lane = self._spawn_lane[corner]
        s = (torch.full((B,), longitudinal, dtype=torch.float32, device=dev) + 5.0
             + draws.station * position_deviation)
        speed = 8.0 + draws.speed * speed_deviation
        pos = lane_ops.position(self.geo, lane, s, torch.zeros_like(s))
        heading = lane_ops.heading_at(self.geo, lane, s)

        d = veh.pos - pos[:, None, :]
        dist = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
        clear = ~(veh.active & (dist < 15.0)).any(dim=-1)
        slots = (slot.long() if torch.is_tensor(slot)
                 else torch.full((B,), slot, dtype=torch.long, device=dev))
        free = torch.gather(veh.kind, 1, slots[:, None])[:, 0] == KIND_PAD
        ok = (draws.accept <= spawn_probability) & clear & free
        hot = (torch.arange(V, device=dev) == slots[:, None]) & ok[:, None]

        def put(field, value):
            # a Python scalar goes in as a scalar: no host data is copied
            if torch.is_tensor(value):
                value = value.to(field.dtype)
                if value.dim() == 1:
                    value = value[:, None]
            return torch.where(hot.view(hot.shape + (1,) * (field.dim() - 2)), value, field)

        rb, rn, rid, rlen = self._routes
        return veh.replace(
            pos=put(veh.pos, pos[:, None, :]),
            heading=put(veh.heading, heading),
            speed=put(veh.speed, speed),
            lane=put(veh.lane, lane),
            target_lane=put(veh.target_lane, lane),
            target_speed=put(veh.target_speed, speed),
            timer=put(veh.timer, torch.remainder((pos[:, 0] + pos[:, 1]) * math.pi, 1.0)),
            delta=put(veh.delta, draws.delta),
            kind=put(veh.kind, KIND_IDM),
            crashed=put(veh.crashed, False),
            is_yielding=put(veh.is_yielding, False),
            yield_timer=put(veh.yield_timer, 0),
            route_base=put(veh.route_base, rb[corner, dest][:, None, :]),
            route_n=put(veh.route_n, rn[corner, dest][:, None, :]),
            route_id=put(veh.route_id, rid[corner, dest][:, None, :]),
            route_ptr=put(veh.route_ptr, 0),
            route_len=put(veh.route_len, rlen[corner, dest]),
        )

    def _place_initial(self, draws: SpawnDraws) -> VehicleState:
        """Phase A of the reset: the initial NPCs at stations linspace(0, 80)
        with the reference's default spawn probability 0.6 (the config's
        ``spawn_probability`` gates only the spawns during an episode), from
        the (B, n) draws of every reset spawn, the challenger's in the last
        column."""
        n_init = self.config["initial_vehicle_count"]
        veh = empty_state(draws.accept.shape[0], self.num_slots,
                          route_slots=self.route_slots, device=self.device)
        stations = np.linspace(0, 80, n_init)
        for t in range(n_init - 1):
            veh = self.place_spawn(veh, t, draws.at(t), float(stations[t]),
                                   spawn_probability=0.6)
        return veh

    def _spawn_initial(self, batch: int, generator):
        """Phase A from ``batch`` fresh draws: the state and the draws."""
        draws = self.spawn_draws((batch, self.config["initial_vehicle_count"]), generator)
        return self._place_initial(draws), draws

    @property
    def _warmup_frames(self) -> int:
        return 3 * self.config["simulation_frequency"]

    @property
    def _warmup_slots(self) -> int:
        """Only the initial NPCs' slots hold vehicles during the warm-up,
        which runs on the first ``W`` slots (rounded up to 8)."""
        n_init = self.config["initial_vehicle_count"]
        return min(self.num_slots, -(-(n_init - 1) // 8) * 8)

    def _warm_up(self, veh: VehicleState) -> VehicleState:
        """The 3 s of traffic before the episode, from frame counter 0, on
        the first ``_warmup_slots`` slots: one launch of K5 on CUDA, or the
        plain frames under ``sequential_decisions``."""
        B, W = veh.kind.shape[0], self._warmup_slots
        dev = self.device
        fields = [f.name for f in dataclasses.fields(VehicleState)]
        sub = VehicleState(**{f: getattr(veh, f)[:, :W].contiguous() for f in fields})
        # zero slot actions of the action type's shape: there is no ego yet
        extra = tuple(self.action_type.action_shape)
        zeros = torch.zeros((B, W) + extra, device=dev,
                            dtype=torch.float32 if extra else torch.int32)
        steps0 = torch.zeros(B, dtype=torch.int32, device=dev)
        if self._general.sequential:
            # the reference's decision order: the plain frames
            sub = general_frames.simulate_general_reference(
                self, sub, zeros, self._warmup_frames, steps0=steps0)
        else:
            # IDM rows only: a preset goes on after the warm-up
            sub = general_frames.simulate_general(
                self, sub, zeros, self._warmup_frames, steps0=steps0, linear=False)
        return VehicleState(**{
            f: torch.cat([getattr(sub, f), getattr(veh, f)[:, W:]], dim=1) for f in fields
        })

    def _reset_draws(self, batch: int, generator) -> dict:
        """The reset's draws (module docstring): the spawn draws of the
        initial NPCs and the challenger, (B, 10) under ``SpawnDraws``'
        names, then the egos' destinations and stations, (B, egos), under
        ``ego_dest`` and ``ego_station``."""
        draws = self.spawn_draws((batch, self.config["initial_vehicle_count"]), generator)
        egos = len(self._ego_slots)
        return {
            **draws._asdict(),
            "ego_dest": torch.randint(1, 4, (batch, egos), generator=generator,
                                      device=self.device),
            "ego_station": torch.randn((batch, egos), generator=generator,
                                       device=self.device),
        }

    def _place_vehicles(self, draws: dict) -> VehicleState:
        """Phase A, the warm-up (one launch of K5 on CUDA) and phase B."""
        spawn = SpawnDraws(*(draws[name] for name in SpawnDraws._fields))
        return self._finish_reset_vehicles(
            self._warm_up(self._place_initial(spawn)), spawn, draws["ego_dest"],
            draws["ego_station"],
        )

    def _finish_reset_vehicles(self, veh: VehicleState, draws: SpawnDraws,
                               dest: torch.Tensor, station: torch.Tensor) -> VehicleState:
        """Phase B of the reset: the challenger crossing straight ahead, then
        each ego at s = 60 + 5 (1 + N(0, 1)) on the incoming lane of corner
        ``k % 4``, at 10 m/s, routed to ``destination`` (or to the drawn
        ``dest``), and the NPCs within 20 m of it dropped.  An action type
        without target speeds (a ContinuousAction) gives the ego no target
        speed, speed index or route, as the reference's plain-Vehicle ego
        skips them."""
        cfg = self.config
        n_init = cfg["initial_vehicle_count"]
        B = veh.kind.shape[0]
        dev = self.device
        veh = self.place_spawn(
            veh, n_init - 1, draws.at(n_init - 1), 60.0, position_deviation=0.1,
            speed_deviation=0.0, spawn_probability=1.0, go_straight=True,
        )
        rb, rn, rid, rlen = self._routes
        meta = hasattr(self.action_type, "target_speeds")
        for k, slot in enumerate(self._ego_slots):
            corner = k % 4
            lane = self._spawn_lane[corner].expand(B)
            d = dest[:, k] if cfg["destination"] is None else torch.full(
                (B,), int(cfg["destination"][1:]), dtype=torch.long, device=dev)
            s = 60.0 + 5.0 * (1.0 + station[:, k])
            pos = lane_ops.position(self.geo, lane, s, torch.zeros_like(s))
            heading = lane_ops.heading_at(self.geo, lane, torch.full((B,), 60.0, device=dev))
            speed = torch.full((B,), 10.0, device=dev)

            def put(field, value):
                field = field.clone()
                field[:, slot] = value
                return field

            veh = veh.replace(
                pos=put(veh.pos, pos),
                heading=put(veh.heading, heading),
                speed=put(veh.speed, speed),
                lane=put(veh.lane, lane),
                target_lane=put(veh.target_lane, lane),
                kind=put(veh.kind, KIND_EGO),
            )
            if meta:
                index = controller.speed_to_index(speed, self.action_type.target_speeds)
                veh = veh.replace(
                    target_speed=put(veh.target_speed,
                                     self.action_type.speed_table(dev)[index.long()]),
                    speed_index=put(veh.speed_index, index),
                    route_base=put(veh.route_base, rb[corner][d]),
                    route_n=put(veh.route_n, rn[corner][d]),
                    route_id=put(veh.route_id, rid[corner][d]),
                    route_len=put(veh.route_len, rlen[corner][d]),
                )
            # no NPC within 20 m of the ego
            dp = veh.pos - pos[:, None, :]
            near = torch.sqrt(dp[..., 0] * dp[..., 0] + dp[..., 1] * dp[..., 1]) < 20.0
            drop = (veh.kind != KIND_PAD) & (veh.kind != KIND_EGO) & near
            veh = veh.replace(kind=torch.where(drop, KIND_PAD, veh.kind))
        return veh

    # ------------------------------------------------------------------ #
    # population during the episode
    # ------------------------------------------------------------------ #
    def _has_arrived(self, state: EnvState, slot: int, exit_distance: float = 25.0):
        """25 m into an exit lane."""
        veh = state.vehicles
        lane = veh.lane[:, slot]
        s, _ = lane_ops.local_coordinates(self.geo, lane, veh.pos[:, slot])
        return self._exit_lane_mask[lane_ops._gather(self.geo, lane)] & (s >= exit_distance)

    def _clear_vehicles(self, veh: VehicleState) -> VehicleState:
        """Free the slots of the NPCs within 4 lengths of their exit lane's end."""
        li = lane_ops._gather(self.geo, veh.lane)
        s, _ = lane_ops.local_coordinates(self.geo, veh.lane, veh.pos)
        leaving = self._exit_lane_mask[li] & (s >= self.geo.length[li] - 4 * veh.length)
        drop = (veh.kind != KIND_EGO) & (veh.kind != KIND_PAD) & leaving
        return veh.replace(kind=torch.where(drop, KIND_PAD, veh.kind))

    def _post_step_population(self, state: EnvState, generator) -> EnvState:
        """After the head: clear the leaving NPCs, then one spawn attempt at
        station 0 into the first free NPC slot (slot 0 when none is free,
        which the slot test then refuses)."""
        veh = self._clear_vehicles(state.vehicles)
        free = (veh.kind[:, : self._n_npc] == KIND_PAD).int().argmax(dim=1)
        draws = self.spawn_draws(state.time.shape, generator)
        veh = self.place_spawn(veh, free, draws, 0.0,
                               spawn_probability=self.config["spawn_probability"])
        return state.replace(vehicles=veh)

    # ------------------------------------------------------------------ #
    # rewards and termination
    # ------------------------------------------------------------------ #
    def _agent_rewards(self, state: EnvState, action, slot: int):
        veh = state.vehicles
        scaled_speed = lmap(veh.speed[:, slot], self.config["reward_speed_range"], (0.0, 1.0))
        return {
            "collision_reward": veh.crashed[:, slot].float(),
            "high_speed_reward": scaled_speed.clamp(0.0, 1.0),
            "arrived_reward": self._has_arrived(state, slot).float(),
            "on_road_reward": self.ego_on_road(state, slot).float(),
        }

    def _agent_reward(self, state: EnvState, action, slot: int):
        cfg = self.config
        rewards = self._agent_rewards(state, action, slot)
        reward = sum(cfg.get(k, 0) * v for k, v in rewards.items())
        reward = torch.where(rewards["arrived_reward"] > 0, float(cfg["arrived_reward"]),
                             reward)
        reward = reward * rewards["on_road_reward"]
        if cfg["normalize_reward"]:
            reward = lmap(reward, (cfg["collision_reward"], cfg["arrived_reward"]), (0.0, 1.0))
        return reward

    def _reward(self, state: EnvState, action):
        vals = [self._agent_reward(state, action, s) for s in self.ego_slots]
        return sum(vals) / len(vals)

    def _rewards(self, state: EnvState, action):
        per_agent = [self._agent_rewards(state, action, s) for s in self.ego_slots]
        return {
            name: sum(r[name] for r in per_agent) / len(per_agent)
            for name in per_agent[0]
        }

    def _is_terminated(self, state: EnvState):
        veh = state.vehicles
        crashed = torch.zeros_like(state.time, dtype=torch.bool)
        arrived = torch.ones_like(state.time, dtype=torch.bool)
        for s in self.ego_slots:
            crashed = crashed | veh.crashed[:, s]
            arrived = arrived & self._has_arrived(state, s)
        out = crashed | arrived
        if self.config["offroad_terminal"]:
            out = out | ~self.ego_on_road(state)
        return out

    def _is_truncated(self, state: EnvState):
        return state.time >= self.config["duration"]

    def _info(self, state: EnvState, action):
        info = super()._info(state, action)
        info["agents_rewards"] = tuple(
            self._agent_reward(state, action, s) for s in self.ego_slots
        )
        info["agents_terminated"] = tuple(
            state.vehicles.crashed[:, s] | self._has_arrived(state, s)
            for s in self.ego_slots
        )
        return info


class MultiAgentIntersectionEnv(IntersectionEnv):
    """intersection-multi-agent-v0 and -v2 (reference intersection_env.py
    ``MultiAgentIntersectionEnv``): two egos in slots 24 and 25, on corners
    0 and 1, each with its own DiscreteMetaAction and Kinematics
    observation; the reward is the agents' mean, an episode ends when an
    ego crashes or every ego has arrived, and ``info`` carries
    ``agents_rewards`` and ``agents_terminated``."""

    @classmethod
    def default_config(cls) -> dict:
        config = super().default_config()
        update_config(
            config,
            {
                "action": {
                    "type": "MultiAgentAction",
                    "action_config": {
                        "type": "DiscreteMetaAction",
                        "lateral": False,
                        "longitudinal": True,
                        "target_speeds": [0, 4.5, 9],
                    },
                },
                "observation": {
                    "type": "MultiAgentObservation",
                    "observation_config": {
                        "type": "Kinematics",
                        "vehicles_count": 15,
                        "features": ["presence", "x", "y", "vx", "vy", "cos_h", "sin_h"],
                        "features_range": {
                            "x": [-100, 100],
                            "y": [-100, 100],
                            "vx": [-20, 20],
                            "vy": [-20, 20],
                        },
                        "absolute": True,
                        "flatten": False,
                        "observe_intentions": False,
                    },
                },
                "controlled_vehicles": 2,
            },
        )
        return config


class ContinuousIntersectionEnv(IntersectionEnv):
    """intersection-v1 (reference intersection_env.py
    ``ContinuousIntersectionEnv``): the ego under a dynamical
    ContinuousAction, longitudinal and lateral, steering within +-pi/3 (the
    BicycleVehicle tire-slip model, K5's ``kDynamical`` instantiation on the
    card), and the Kinematics observation of 5 vehicles with the offsets
    from each row's lane (``long_off``, ``lat_off``, ``ang_off``)."""

    @classmethod
    def default_config(cls) -> dict:
        config = super().default_config()
        update_config(
            config,
            {
                "observation": {
                    "type": "Kinematics",
                    "vehicles_count": 5,
                    "features": [
                        "presence", "x", "y", "vx", "vy",
                        "long_off", "lat_off", "ang_off",
                    ],
                    "features_range": {
                        "x": [-100, 100],
                        "y": [-100, 100],
                        "vx": [-20, 20],
                        "vy": [-20, 20],
                    },
                    "absolute": True,
                    "flatten": False,
                    "observe_intentions": False,
                },
                "action": {
                    "type": "ContinuousAction",
                    "steering_range": [-np.pi / 3, np.pi / 3],
                    "longitudinal": True,
                    "lateral": True,
                    "dynamical": True,
                    "target_speeds": [0, 4.5, 9],
                },
            },
        )
        return config
