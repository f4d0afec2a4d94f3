"""Parameterized merge scenario with rejection-sampled spawns.

PyTorch counterpart of ``highwayenv_tpu/envs/merge_generic.py`` (reference
highway_env/envs/merge_env.py ``MergeEnvGeneric``, merge-generic-v0): a
configurable lane count, segment lengths and vehicle count.  Each NPC
takes the first of 10 tries (lane, station, speed) that keeps 15 m of
clearance on its lane from every vehicle already placed, and stays
unplaced when none does.  The JAX package unrolls a loop over (vehicle,
try); here a Python loop over the vehicles tests all tries of one
vehicle at once, batched over the envs, and takes the first clear one:
the same placement (a try's clearance depends only on the vehicles
placed before), in a few kernels a vehicle rather than a few a try.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from highwayenv_tpu_torch.envs.highway import _uniform
from highwayenv_tpu_torch.envs.merge import MergeEnv
from highwayenv_tpu_torch.road import lane as lane_ops
from highwayenv_tpu_torch.road.network import (
    LineType,
    RoadNetworkBuilder,
    SineLane,
    StraightLane,
)
from highwayenv_tpu_torch.utils.config import update_config
from highwayenv_tpu_torch.vehicle import controller
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

#: spawn tries per NPC, and the clearance on the drawn lane [m]
TRIES = 10
CLEARANCE = 15.0


class MergeGenericEnv(MergeEnv):
    @classmethod
    def default_config(cls) -> dict:
        cfg = super().default_config()
        update_config(
            cfg,
            {
                "lanes_count": 2,
                "vehicles_count": 3,
                "before_merge_length": 150,
                "converge_merge_length": 80,
                "parallel_merge_length": 80,
                "after_merge_length": 150,
            },
        )
        return cfg

    def _build_scene(self):
        """Reference merge_env.py ``MergeEnvGeneric._make_road``."""
        cfg = self.config
        lanes = cfg["lanes_count"]
        pre = cfg["before_merge_length"]
        conv = cfg["converge_merge_length"]
        par = cfg["parallel_merge_length"]
        after = cfg["after_merge_length"]
        if not (min(pre, conv, par) > 0 and after >= 90):
            raise ValueError("merge lengths: before, converge and parallel > 0, "
                             "after >= 90")
        self.end_position = pre + conv + par + after - 90

        net = RoadNetworkBuilder.straight_road_network(
            lanes, start=0, length=pre + conv, nodes_str=("a", "b"), speed_limit=30)
        net = RoadNetworkBuilder.straight_road_network(
            lanes, start=pre + conv, length=par, nodes_str=("b", "c"),
            speed_limit=30, net=net)
        net = RoadNetworkBuilder.straight_road_network(
            lanes, start=pre + conv + par, length=after, nodes_str=("c", "d"),
            speed_limit=30, net=net)

        amplitude = 3.25
        c = LineType.CONTINUOUS_LINE
        y_parallel = lanes * 4.0
        y_approach = y_parallel + 2 * amplitude
        ljk = StraightLane([0, y_approach], [pre, y_approach], line_types=[c, c],
                           forbidden=True, speed_limit=30)
        lkb = SineLane([pre, y_parallel + amplitude],
                       [pre + conv, y_parallel + amplitude],
                       amplitude, 2 * np.pi / (2 * conv), np.pi / 2,
                       line_types=[c, c], forbidden=True, speed_limit=30)
        lbc = StraightLane([pre + conv, y_parallel], [pre + conv + par, y_parallel],
                           line_types=[LineType.STRIPED, c], forbidden=True,
                           speed_limit=30)
        net.add_lane("j", "k", ljk)
        net.add_lane("k", "b", lkb)
        net.add_lane("b", "c", lbc)
        self.net = net
        self.geo = net.build(device=self.device)
        self.max_edge_lanes = lanes + 1
        self.obs_edge_lanes = lanes  # the ego spawns on ("a", "b") (PARITY #5)
        self._merge_lane = net.global_lane_index(("b", "c", lanes))
        # slots: the ego, the sampled NPCs, the merging vehicle, the obstacle
        self.num_slots = 1 + cfg["vehicles_count"] + 1 + 1
        self._ab_base = net.global_lane_index(("a", "b", 0))
        self._max_pos = float(pre + conv + par)
        dev = self.device
        f32 = np.float32
        self._ego_pos = torch.as_tensor(
            np.asarray(net.get_lane(("a", "b", lanes - 1)).position(30.0, 0.0), f32),
            device=dev)
        self._ramp_pos = torch.as_tensor(
            np.asarray(ljk.position(60.0, 0.0), f32), device=dev)
        self._obstacle_pos = torch.as_tensor(
            np.asarray(lbc.position(par, 0), f32), device=dev)

    def _reset_draws(self, batch: int, generator) -> dict:
        """The reset's draws, in order, each (B, NPCs, TRIES): every try's
        lane, station U(0, end of the parallel section) and speed
        30 + U(-2, 2)."""
        cfg = self.config
        B, dev = batch, self.device
        shape = (B, cfg["vehicles_count"], TRIES)
        return {
            "lane": torch.randint(0, cfg["lanes_count"], shape, generator=generator,
                                  device=dev, dtype=torch.int32),
            "s": _uniform(shape, 0.0, self._max_pos, generator, dev),
            "speed": 30.0 + _uniform(shape, -2.0, 2.0, generator, dev),
        }

    def _place_vehicles(self, draws: dict) -> VehicleState:
        """Reference merge_env.py ``MergeEnvGeneric._make_vehicles``."""
        lanes = self.config["lanes_count"]
        B, n_npc, _ = draws["lane"].shape
        V, dev = self.num_slots, self.device
        ego_s = 30.0
        # (lane id, station) of the placed vehicles, -1 for none yet
        placed_lane = torch.full((B, V), -1, dtype=torch.int32, device=dev)
        placed_s = torch.zeros((B, V), device=dev)
        placed_lane[:, 0] = lanes - 1
        placed_s[:, 0] = ego_s
        s_npc = torch.zeros((B, n_npc), device=dev)
        v_npc = torch.zeros((B, n_npc), device=dev)
        for i in range(n_npc):
            slot = 1 + i
            lane_id, s = draws["lane"][:, i], draws["s"][:, i]  # (B, TRIES)
            # each try against every vehicle placed so far; the first clear one
            blocked = ((placed_lane[:, None] == lane_id[..., None])
                       & ((placed_s[:, None] - s[..., None]).abs() <= CLEARANCE))
            clear = ~blocked.any(dim=2)
            ok = clear.any(dim=1)
            first = clear.to(torch.int32).argmax(dim=1, keepdim=True)
            placed_lane[:, slot] = torch.where(ok, lane_id.gather(1, first)[:, 0], -1)
            s_npc[:, i] = torch.where(ok, s.gather(1, first)[:, 0], 0.0)
            placed_s[:, slot] = s_npc[:, i]
            v_npc[:, i] = torch.where(ok, draws["speed"][:, i].gather(1, first)[:, 0], 0.0)

        placed = placed_lane[:, 1 : 1 + n_npc] >= 0
        npc_lane = self._ab_base + placed_lane[:, 1 : 1 + n_npc].clamp(min=0)
        npc_pos = lane_ops.position(self.geo, npc_lane, s_npc, torch.zeros_like(s_npc))
        npc_pos = torch.where(placed[..., None], npc_pos, 0.0)
        pos = torch.cat([
            self._ego_pos.expand(B, 1, 2), npc_pos,
            self._ramp_pos.expand(B, 1, 2), self._obstacle_pos.expand(B, 1, 2),
        ], dim=1)
        zero = torch.zeros((B, 1), device=dev)
        speed = torch.cat([torch.full((B, 1), 30.0, device=dev), v_npc,
                           torch.full((B, 1), 20.0, device=dev), zero], dim=1)
        kind = torch.cat([
            torch.full((B, 1), KIND_EGO, dtype=torch.int32, device=dev),
            torch.where(placed, KIND_IDM, KIND_PAD).to(torch.int32),
            torch.full((B, 1), KIND_IDM, dtype=torch.int32, device=dev),
            torch.full((B, 1), KIND_OBSTACLE, dtype=torch.int32, device=dev),
        ], dim=1)
        heading = torch.zeros((B, V), device=dev)
        lane = lane_ops.closest_lane(self.geo, pos, heading)
        is_ego = kind == KIND_EGO
        ego_index, ego_ts = controller.ego_speed_init(self.action_type, speed)
        target_speed = torch.where(is_ego, ego_ts, speed)
        target_speed[:, V - 2] = 30.0  # the merging vehicle's
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
            kind=kind,
            length=torch.where(obstacle, OBJECT_LENGTH, 5.0),
            width=torch.where(obstacle, OBJECT_WIDTH, 2.0),
        )

    def _is_terminated(self, state):
        """Reference merge_env.py ``MergeEnvGeneric._is_terminated``."""
        veh = state.vehicles
        return veh.crashed[:, 0] | (veh.pos[:, 0, 0] > self.end_position)
