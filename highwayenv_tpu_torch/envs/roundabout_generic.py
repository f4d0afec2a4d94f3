"""Parameterized roundabout with rejection-sampled spawns.

PyTorch counterpart of ``highwayenv_tpu/envs/roundabout_generic.py``
(reference highway_env/envs/roundabout_env.py ``RoundaboutEnvGeneric``,
roundabout-generic-v0): a configurable radius, ring lane count and
vehicle count, sine accesses placed from the ring's outer radius.  Each
NPC takes the first of 10 tries (spawn edge, lane, station, speed,
destination) that keeps 7 m from every vehicle already placed, and stays
unplaced when none does.  The JAX package unrolls a loop over (vehicle,
try); here every try's lane, position and heading are made at once, and
a Python loop over the vehicles tests all tries of one vehicle at once,
batched over the envs, and takes the first clear one: the same placement
(a try's clearance depends only on the vehicles placed before), in a few
kernels a vehicle rather than some hundred a try.  An NPC's
route to its destination (one of the four exits) is gathered from
tables compiled on the host for every (spawn edge, lane, destination).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from highwayenv_tpu_torch.envs.highway import _uniform
from highwayenv_tpu_torch.envs.roundabout import RoundaboutEnv
from highwayenv_tpu_torch.road import lane as lane_ops
from highwayenv_tpu_torch.road.network import (
    CircularLane,
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
    KIND_PAD,
    VehicleState,
    empty_state,
)

#: spawn tries per NPC, and the clearance from every placed vehicle [m]
TRIES = 10
CLEARANCE = 7.0
#: the NPCs' destinations and candidate spawn edges (reference
#: roundabout_env.py ``RoundaboutEnvGeneric._make_vehicles``)
DESTINATIONS = ("exr", "sxr", "nxr", "wxr")
SPAWN_EDGES = (("we", "sx"), ("sx", "se"), ("ee", "nx"), ("nx", "ne"),
               ("eer", "ees"), ("ner", "nes"), ("wer", "wes"))


class RoundaboutGenericEnv(RoundaboutEnv):
    @classmethod
    def default_config(cls) -> dict:
        config = super().default_config()
        update_config(
            config,
            {
                "roundabout_radius": 20,
                "roundabout_lanes": 2,
                "vehicles_count": 5,
                "duration": 17,
            },
        )
        return config

    def _build_scene(self):
        """Reference roundabout_env.py ``RoundaboutEnvGeneric._make_road``."""
        cfg = self.config
        radius = cfg["roundabout_radius"]
        num_lanes = cfg["roundabout_lanes"]
        alpha = 24.0
        net = RoadNetworkBuilder()
        radii = [radius + 4 * i for i in range(num_lanes)]
        n, c, s = LineType.NONE, LineType.CONTINUOUS, LineType.STRIPED
        nodes = ["se", "ex", "ee", "nx", "ne", "wx", "we", "sx", "se"]
        angles = [
            (90 - alpha, alpha), (alpha, -alpha), (-alpha, -90 + alpha),
            (-90 + alpha, -90 - alpha), (-90 - alpha, -180 + alpha),
            (-180 + alpha, -180 - alpha), (180 - alpha, 90 + alpha),
            (90 + alpha, 90 - alpha),
        ]
        for lane in range(num_lanes):
            if num_lanes == 1:
                lt = [c, c]
            elif lane == 0:
                lt = [c, s]
            elif lane == num_lanes - 1:
                lt = [n, c]
            else:
                lt = [n, s]
            for i in range(8):
                net.add_lane(nodes[i], nodes[i + 1], CircularLane(
                    [0, 0], radii[lane], np.deg2rad(angles[i][0]),
                    np.deg2rad(angles[i][1]), clockwise=False, line_types=lt))

        outer = radii[-1]

        def pt(deg):
            rad = np.deg2rad(deg)
            return [outer * np.cos(rad), outer * np.sin(rad)]

        p_se, p_ex, p_ee, p_nx = pt(90 - alpha), pt(alpha), pt(-alpha), pt(-90 + alpha)
        p_ne, p_wx, p_we, p_sx = (pt(-90 - alpha), pt(-180 + alpha),
                                  pt(180 - alpha), pt(90 + alpha))
        dev_ = max(100.0, 2 * outer + 40.0)
        access = dev_ + 40.0
        h = dev_ / 2

        def sine(start, end, a, w):
            return SineLane(start, end, a, w, -np.pi / 2, line_types=(c, c))

        # south entry / exit
        a = (p_se[0] - 2) / 2
        net.add_lane("ser", "ses", StraightLane([2, access], [2, h], line_types=(s, c)))
        net.add_lane("ses", "se", sine([2 + a, h], [2 + a, p_se[1]], a,
                                       np.pi / (h - p_se[1])))
        a = (p_sx[0] + 2) / 2
        net.add_lane("sx", "sxs", sine([p_sx[0] - a, p_sx[1]], [p_sx[0] - a, h], a,
                                       np.pi / (h - p_sx[1])))
        net.add_lane("sxs", "sxr", StraightLane([-2, h], [-2, access], line_types=(n, c)))
        # east entry / exit
        a = (-2 - p_ee[1]) / 2
        net.add_lane("eer", "ees", StraightLane([access, -2], [h, -2], line_types=(s, c)))
        net.add_lane("ees", "ee", sine([h, -2 - a], [p_ee[0], -2 - a], a,
                                       np.pi / (h - p_ee[0])))
        a = (2 - p_ex[1]) / 2
        net.add_lane("ex", "exs", sine([p_ex[0], p_ex[1] + a], [h, p_ex[1] + a], a,
                                       np.pi / (h - p_ex[0])))
        net.add_lane("exs", "exr", StraightLane([h, 2], [access, 2], line_types=(n, c)))
        # north entry / exit
        a = (-2 - p_ne[0]) / 2
        net.add_lane("ner", "nes", StraightLane([-2, -access], [-2, -h],
                                                line_types=(s, c)))
        net.add_lane("nes", "ne", sine([-2 - a, -h], [-2 - a, p_ne[1]], a,
                                       np.pi / (p_ne[1] + h)))
        a = (2 - p_nx[0]) / 2
        net.add_lane("nx", "nxs", sine([p_nx[0] + a, p_nx[1]], [p_nx[0] + a, -h], a,
                                       np.pi / (p_nx[1] + h)))
        net.add_lane("nxs", "nxr", StraightLane([2, -h], [2, -access], line_types=(n, c)))
        # west entry / exit
        a = (p_we[1] - 2) / 2
        net.add_lane("wer", "wes", StraightLane([-access, 2], [-h, 2], line_types=(s, c)))
        net.add_lane("wes", "we", sine([-h, 2 + a], [p_we[0], 2 + a], a,
                                       np.pi / (p_we[0] + h)))
        a = (p_wx[1] + 2) / 2
        net.add_lane("wx", "wxs", sine([p_wx[0], p_wx[1] - a], [-h, p_wx[1] - a], a,
                                       np.pi / (p_wx[0] + h)))
        net.add_lane("wxs", "wxr", StraightLane([-h, -2], [-access, -2],
                                                line_types=(n, c)))

        self.net = net
        self.geo = net.build(device=self.device)
        self.max_edge_lanes = num_lanes
        self.num_slots = 1 + cfg["vehicles_count"]

        # route tables over (spawn edge, lane id, destination), R wide
        counts = [len(net.lanes_on_edge(f, t)) for f, t in SPAWN_EDGES]
        self.route_slots = R = max(
            int(net.route_arrays((f, t, lid), d, 32)[3])
            for (f, t), k in zip(SPAWN_EDGES, counts) for lid in range(k)
            for d in DESTINATIONS
        )
        E, M, D = len(SPAWN_EDGES), max(counts), len(DESTINATIONS)
        routes = np.zeros((E, M, D, 3, R), np.int32)
        routes[..., 0, :] = routes[..., 2, :] = -1
        route_len = np.zeros((E, M, D), np.int32)
        for e, (f, t) in enumerate(SPAWN_EDGES):
            for lid in range(counts[e]):
                for d, dest in enumerate(DESTINATIONS):
                    rb, rn, rid, rl = net.route_arrays((f, t, lid), dest, R)
                    routes[e, lid, d] = (rb, rn, rid)
                    route_len[e, lid, d] = rl
        dev = self.device
        self._npc_routes = torch.as_tensor(routes, device=dev)
        self._npc_route_len = torch.as_tensor(route_len, device=dev)
        self._spawn_lane_count = torch.as_tensor(counts, dtype=torch.int32, device=dev)
        self._spawn_lane_base = torch.as_tensor(
            [net.global_lane_index((f, t, 0)) for f, t in SPAWN_EDGES],
            dtype=torch.int32, device=dev,
        )
        self._ego_lane = net.global_lane_index(("ser", "ses", 0))
        ego_route = net.route_arrays(("ser", "ses", 0), "nxs", R)
        self._ego_route = torch.as_tensor(np.stack(ego_route[:3]), dtype=torch.int32,
                                          device=dev)
        self._ego_route_len = int(ego_route[3])
        # an unplaced slot's route (base, n, id): empty; on the device once,
        # so a placement copies no host data (a captured step may run it)
        self._no_route = torch.tensor([-1, 0, -1], dtype=torch.int32, device=dev)[:, None]
        self._is_ego = torch.arange(self.num_slots, device=dev) == 0

    def _reset_draws(self, batch: int, generator) -> dict:
        """The reset's draws, in order, each (B, NPCs, TRIES) but the last:
        every try's spawn edge, raw lane draw (taken modulo the edge's lane
        count), station uniform U(0, 1) (scaled to the lane), speed
        jitter N(0, 1) and destination; then the IDM exponents U(3.5, 4.5),
        (B, V)."""
        B, V, dev = batch, self.num_slots, self.device
        shape = (B, self.config["vehicles_count"], TRIES)

        def randint(high):
            return torch.randint(0, high, shape, generator=generator, device=dev,
                                 dtype=torch.int32)

        return {
            "edge": randint(len(SPAWN_EDGES)),
            "lane": randint(10000),
            "s": torch.rand(shape, generator=generator, device=dev),
            "speed": torch.randn(shape, generator=generator, device=dev),
            "dest": randint(len(DESTINATIONS)),
            "delta": _uniform((B, V), 3.5, 4.5, generator, dev),
        }

    def _place_vehicles(self, draws: dict) -> VehicleState:
        """Reference roundabout_env.py ``RoundaboutEnvGeneric._make_vehicles``."""
        B, n_npc, _ = draws["edge"].shape
        V, R, dev, geo = self.num_slots, self.route_slots, self.device, self.geo
        # the ego at the end of ("ser", "ses", 0), on its route to "nxs"
        ego_lane = torch.full((B,), self._ego_lane, dtype=torch.int32, device=dev)
        ego_s = geo.length[self._ego_lane] - 2.5
        ego_s = ego_s.expand(B)
        pos = torch.zeros((B, V, 2), device=dev)
        pos[:, 0] = lane_ops.position(geo, ego_lane, ego_s, torch.zeros_like(ego_s))
        heading = torch.zeros((B, V), device=dev)
        heading[:, 0] = lane_ops.heading_at(geo, ego_lane, ego_s)
        speed = torch.zeros((B, V), device=dev)
        speed[:, 0] = 8.0
        kind = torch.full((B, V), KIND_PAD, dtype=torch.int32, device=dev)
        kind[:, 0] = KIND_EGO

        # every try's spawn lane, station (5 m inside either end), position,
        # heading, speed and destination, (B, NPCs, TRIES)
        e = draws["edge"].long()
        lid = (draws["lane"] % self._spawn_lane_count[e]).long()
        g = self._spawn_lane_base[e] + lid
        hi = torch.clamp(geo.length[g] - 5.0, min=5.0)
        s = torch.clamp(draws["s"] * (hi - 5.0) + 5.0, min=5.0)
        p = lane_ops.position(geo, g, s, torch.zeros_like(s))
        try_heading = lane_ops.heading_at(geo, g, s)
        try_speed = 14.0 + 2.0 * draws["speed"]
        ivd = self.config.get("incoming_vehicle_destination")
        dest = (torch.full_like(e, min(int(ivd), 3)) if ivd is not None
                else draws["dest"].long())
        picked = torch.zeros((B, n_npc), dtype=torch.long, device=dev)
        for i in range(n_npc):
            slot = 1 + i
            # each try against every vehicle placed so far; the first clear one
            d = torch.linalg.vector_norm(pos[:, None] - p[:, i, :, None], dim=-1)
            clear = ~((kind != KIND_PAD)[:, None] & (d < CLEARANCE)).any(dim=2)
            ok = clear.any(dim=1)
            first = clear.to(torch.int32).argmax(dim=1, keepdim=True)
            picked[:, i] = first[:, 0]
            pos[:, slot] = torch.where(
                ok[:, None], p[:, i].gather(1, first[..., None].expand(-1, 1, 2))[:, 0], 0.0)
            heading[:, slot] = torch.where(ok, try_heading[:, i].gather(1, first)[:, 0], 0.0)
            speed[:, slot] = torch.where(ok, try_speed[:, i].gather(1, first)[:, 0], 0.0)
            kind[:, slot] = torch.where(ok, KIND_IDM, KIND_PAD)

        placed = kind[:, 1:] == KIND_IDM
        e, lid, dest = (x.gather(2, picked[..., None])[..., 0] for x in (e, lid, dest))
        npc_routes = torch.where(placed[..., None, None], self._npc_routes[e, lid, dest],
                                 self._no_route)  # (B, NPCs, 3, R)
        routes = torch.cat([self._ego_route.expand(B, 1, 3, R), npc_routes], dim=1)
        route_len = torch.cat([
            torch.full((B, 1), self._ego_route_len, dtype=torch.int32, device=dev),
            torch.where(placed, self._npc_route_len[e, lid, dest], 0),
        ], dim=1)

        lane = lane_ops.closest_lane(geo, pos, heading)
        ego_index, ego_ts = controller.ego_speed_init(self.action_type, speed)
        is_ego = self._is_ego.expand(B, V)
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
            kind=kind,
            route_base=routes[:, :, 0].contiguous(),
            route_n=routes[:, :, 1].contiguous(),
            route_id=routes[:, :, 2].contiguous(),
            route_len=route_len.to(torch.int32),
        )
