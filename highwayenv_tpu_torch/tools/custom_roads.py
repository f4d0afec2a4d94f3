"""Roads built by hand, as ``docs/make_your_own.md`` builds them: the scenes
that the frame kernels' fixed tables refused before their tables were sized
by the scene, for ``chip_smoke.py`` and ``tests/test_torch_custom_roads.py``.

The network functions take the network module of either package
(``highwayenv_tpu_torch.road.network`` or the JAX package's), whose lane
classes share their names, so a test builds the same road in both:

- ``poly_junction``: merge-v0's road, and at its end node "d" five
  successor edges: "d" -> "e" of a fixed-width ``PolyLaneFixedWidth`` and a
  variable-width ``PolyLane`` side by side, three straight edges
  "d" -> "g0" .. "g2", and a chain of 17 short straight edges "d" -> "h0" ->
  ... -> "h16";
- ``poly_edge``: an edge of a fixed-width and a variable-width poly lane;
- ``more_predecessors``: merge-v0's road with ``n`` more edges into node
  "b" (``FivePredecessorMerge``: 5 predecessor edges, 1 + S + P = 7
  candidate lanes a lane under the connected-lane search;
  ``CrowdedMerge``: 10 and 12).

The port's env classes place their vehicles on those lanes
(``PolyJunctionMerge``: two NPCs on the poly edge, one on the last straight
lane before the chain with the route of ``CHAIN_ROUTE`` edges through it,
one before the junction with no route), so that a few policy steps run the
poly projection, neighbours and lane changes there, the successor choice
among five edges and a route past 16 slots.  ``PolyExit`` is exit-v0 with
a poly edge past its end and ``POLY_NPCS`` NPCs on it: with 50 vehicles a
scene of the wide kernels, with 150 one of the cluster kernels whose poly
lanes carry slots of both ranks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from highwayenv_tpu_torch.envs.exit import ExitEnv
from highwayenv_tpu_torch.envs.merge import MergeEnv
from highwayenv_tpu_torch.road import lane as lane_ops
from highwayenv_tpu_torch.road import network

#: the chain's edges and the route through it: the lane before it, then 17
CHAIN = 17
CHAIN_ROUTE = CHAIN + 1
#: merge-v0's road ends at x = 460 (150 + 80 + 80 + 150 m), its lanes at y = 0, 4
END_X = 460.0
#: exit-v0's road ends at x = 1000, its lanes from y = 0
EXIT_END_X = 1000.0
#: NPCs PolyExit moves onto its poly edge, centred on slot POLY_CENTRE (the
#: first rank boundary of the cluster kernels) where there are NPCs past it
POLY_NPCS = 16
POLY_CENTRE = 128


def poly_points(seed: int = 0) -> tuple[list, list, list]:
    """A polyline from the origin heading along x with seeded turns, and
    its left / right boundaries at seeded half-widths."""
    rng = np.random.default_rng(seed + 40)
    x = np.concatenate([[0.0], np.cumsum(rng.uniform(6.0, 15.0, size=7))])
    y = np.concatenate([[0.0], np.cumsum(rng.normal(scale=2.0, size=7))])
    pts = np.stack([x, y], 1)
    half = rng.uniform(1.8, 2.4, size=8)[:, None] * np.array([0.0, 1.0])
    return pts.tolist(), (pts + half).tolist(), (pts - half).tolist()


def poly_edge(net, net_mod, a: str, b: str, x: float, seed: int = 0) -> None:
    """Adds the edge ``a`` -> ``b`` of two poly lanes from (x, 0) and (x, 4)
    along ``poly_points``: a fixed-width ``PolyLaneFixedWidth`` and a
    variable-width ``PolyLane``."""
    pts, left, right = (np.asarray(p) for p in poly_points(seed))
    shift, up = np.array([x, 0.0]), np.array([x, 4.0])
    net.add_lane(a, b, net_mod.PolyLaneFixedWidth((pts + shift).tolist(), width=4.0))
    net.add_lane(a, b, net_mod.PolyLane((pts + up).tolist(), (left + up).tolist(),
                                        (right + up).tolist()))


def poly_junction(net, net_mod, seed: int = 0) -> None:
    """Adds the five successor edges of node "d" to merge-v0's road ``net``
    (classes of ``net_mod``): a poly edge of two lanes, three straight
    edges, and the first edge of the chain of ``CHAIN`` short edges."""
    poly_edge(net, net_mod, "d", "e", END_X, seed)
    for k in range(3):
        net.add_lane("d", f"g{k}", net_mod.StraightLane(
            [END_X, 4.0], [END_X + 80.0, 4.0 + 12.0 * (k + 1)]))
    # 4 m edges heading 20 degrees below the x axis
    c, s = math.cos(math.radians(-20.0)), math.sin(math.radians(-20.0))
    nodes = ["d"] + [f"h{k}" for k in range(CHAIN)]
    for k in range(CHAIN):
        start = [END_X + 4.0 * k * c, 4.0 * k * s]
        end = [END_X + 4.0 * (k + 1) * c, 4.0 * (k + 1) * s]
        net.add_lane(nodes[k], nodes[k + 1], net_mod.StraightLane(start, end))


def more_predecessors(net, net_mod, n: int) -> None:
    """Adds ``n`` straight edges "x0" .. into node "b" of merge-v0's road."""
    for k in range(n):
        net.add_lane(f"x{k}", "b", net_mod.StraightLane(
            [100.0, 40.0 + 10.0 * k], [230.0, 40.0 + 10.0 * k]))


def _placement(env, lanes, s) -> tuple[torch.Tensor, torch.Tensor]:
    """The (lanes, stations) of a placement as (1, n) tensors on the env's
    device, made when the scene is built: a reset under a CUDA graph's
    capture copies nothing from the host."""
    g = env.net.global_lane_index
    return (torch.tensor([[g(i) for i in lanes]], dtype=torch.int32, device=env.device),
            torch.tensor([s], dtype=torch.float32, device=env.device))


def _moved(env, veh, slots: slice, placement):
    """``veh`` with the ``slots`` put on the placement's lanes at its
    stations (centred, along the lane), their lanes and targets
    re-localized (a slice: no index copied from the host)."""
    B = veh.kind.shape[0]
    lane, st = (t.expand(B, -1) for t in placement)
    pos, heading = veh.pos.clone(), veh.heading.clone()
    pos[:, slots] = lane_ops.position(env.geo, lane, st, torch.zeros_like(st))
    heading[:, slots] = lane_ops.heading_at(env.geo, lane, st)
    at = lane_ops.closest_lane(env.geo, pos, heading)
    return veh.replace(pos=pos, heading=heading, lane=at, target_lane=at.clone())


class PolyJunctionMerge(MergeEnv):
    """merge-v0 on ``poly_junction``'s road: NPC 1 on the fixed-width poly
    lane, NPC 2 on the variable-width one beside it, NPC 3 on ("c", "d", 0)
    20 m before the junction with the route of ``CHAIN_ROUTE`` edges along
    the chain (``route_slots`` = ``CHAIN_ROUTE``), the ramp NPC on ("c",
    "d", 1) 10 m before it with no route."""

    def _build_scene(self):
        super()._build_scene()
        poly_junction(self.net, network)
        self.geo = self.net.build(device=self.device)
        self.route_slots = CHAIN_ROUTE
        self._placement = _placement(
            self, [("d", "e", 0), ("d", "e", 1), ("c", "d", 0), ("c", "d", 1)],
            [8.0, 3.0, 130.0, 140.0])
        base, n, rid, count = self.net.route_arrays(("c", "d", 0), f"h{CHAIN - 1}",
                                                    CHAIN_ROUTE)
        if count != CHAIN_ROUTE:
            raise ValueError(f"the chain's route has {count} edges, not {CHAIN_ROUTE}")
        self._chain_route = torch.tensor(np.stack([base, n, rid]), dtype=torch.int32,
                                         device=self.device)

    def _place_vehicles(self, draws: dict):
        veh = _moved(self, super()._place_vehicles(draws), slice(1, 5), self._placement)
        B, V, R, dev = veh.kind.shape[0], self.num_slots, self.route_slots, self.device
        route_base = torch.full((B, V, R), -1, dtype=torch.int32, device=dev)
        route_n = torch.zeros((B, V, R), dtype=torch.int32, device=dev)
        route_id = torch.full((B, V, R), -1, dtype=torch.int32, device=dev)
        route_len = torch.zeros((B, V), dtype=torch.int32, device=dev)
        route_base[:, 3], route_n[:, 3], route_id[:, 3] = self._chain_route
        route_len[:, 3] = R
        return veh.replace(route_base=route_base, route_n=route_n, route_id=route_id,
                           route_len=route_len)


class FivePredecessorMerge(MergeEnv):
    """merge-v0 with 3 more edges into node "b": 5 predecessor edges."""

    def _build_scene(self):
        super()._build_scene()
        more_predecessors(self.net, network, 3)
        self.geo = self.net.build(device=self.device)


class CrowdedMerge(MergeEnv):
    """merge-v0 with 8 more edges into node "b": 10 predecessor edges, 12
    candidate lanes a lane under the connected-lane search; NPC 2 on the
    last of them, 10 m before the node."""

    def _build_scene(self):
        super()._build_scene()
        more_predecessors(self.net, network, 8)
        self.geo = self.net.build(device=self.device)
        self._placement = _placement(self, [("x7", "b", 0)], [120.0])

    def _place_vehicles(self, draws: dict):
        return _moved(self, super()._place_vehicles(draws), slice(2, 3), self._placement)


class PolyExit(ExitEnv):
    """exit-v0 with ``poly_edge`` "3" -> "p" past its end node: ``POLY_NPCS``
    NPCs moved onto the two poly lanes, alternately, 7 m apart along each
    from 4 m, with no route; the moved slots are the last NPCs, or straddle
    slot ``POLY_CENTRE`` where the NPCs reach past it."""

    def _build_scene(self):
        super()._build_scene()
        poly_edge(self.net, network, "3", "p", EXIT_END_X)
        self.geo = self.net.build(device=self.device)
        first = min(self.num_slots - POLY_NPCS, POLY_CENTRE - POLY_NPCS // 2)
        if first < 1:
            raise ValueError(f"PolyExit needs at least {POLY_NPCS} NPCs")
        self._poly_slots = slice(first, first + POLY_NPCS)
        k = np.arange(POLY_NPCS)
        self._placement = _placement(self, [("3", "p", int(i % 2)) for i in k],
                                     (4.0 + 7.0 * (k // 2)).tolist())

    def _place_vehicles(self, draws: dict):
        veh = _moved(self, super()._place_vehicles(draws), self._poly_slots, self._placement)
        route_len = veh.route_len.clone()
        route_len[:, self._poly_slots] = 0
        return veh.replace(route_len=route_len)
