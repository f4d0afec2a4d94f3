"""Host-side road-network builder: lane specs -> LaneGeometry.

PyTorch counterpart of ``highwayenv_tpu/road/network.py`` (straight, sine,
circular and poly lanes): node names become integer ids, lanes of one edge
get contiguous global indices, and successor / predecessor edges are
flattened into fixed-width padded tables, all built once in numpy and moved
to the env's device; poly lanes add their sample bank (``geo.poly``).  The
host-side queries the scenario resets use (lane lookup, global indices, BFS
routes compiled into route arrays) and the reference's serialization
(``to_config`` / ``from_config``) live here too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from highwayenv_tpu_torch.road.lane import (
    CIRCULAR,
    DEFAULT_WIDTH,
    LINE_CONTINUOUS,
    LINE_CONTINUOUS_LINE,
    LINE_NONE,
    LINE_STRIPED,
    POLY,
    SINE,
    STRAIGHT,
    LaneGeometry,
    PolyBank,
)


class LineType:
    """Lane side line types (reference road/lane.py)."""

    NONE = LINE_NONE
    STRIPED = LINE_STRIPED
    CONTINUOUS = LINE_CONTINUOUS
    CONTINUOUS_LINE = LINE_CONTINUOUS_LINE


@dataclasses.dataclass
class StraightLane:
    """Spec of a straight lane (reference road/lane.py StraightLane)."""

    start: Sequence[float]
    end: Sequence[float]
    width: float = DEFAULT_WIDTH
    line_types: Optional[Sequence[int]] = None
    forbidden: bool = False
    speed_limit: Optional[float] = 20.0
    priority: int = 0

    kind = STRAIGHT

    def __post_init__(self):
        self.start = np.asarray(self.start, dtype=np.float64)
        self.end = np.asarray(self.end, dtype=np.float64)
        delta = self.end - self.start
        self.length = float(np.linalg.norm(delta))
        self.heading = float(math.atan2(delta[1], delta[0]))
        self.direction = delta / self.length
        self.direction_lateral = np.array([-self.direction[1], self.direction[0]])
        if self.line_types is None:
            self.line_types = [LineType.STRIPED, LineType.STRIPED]

    # host-side geometry (spawn positions computed before the tables exist)
    def position(self, s, lat):
        return self.start + s * self.direction + lat * self.direction_lateral

    def heading_at(self, s):
        return self.heading

    def local_coordinates(self, pos):
        """(s, lat) of a host position, in float64 (the seeded resets' lane
        lookups, ``seeding.closest_lane_index``)."""
        delta = np.asarray(pos) - self.start
        return float(delta @ self.direction), float(delta @ self.direction_lateral)


class SineLane(StraightLane):
    """Spec of a sinusoidal lane (reference road/lane.py SineLane):
    positional arguments (start, end, amplitude, pulsation, phase, ...)."""

    kind = SINE

    def __init__(self, start, end, amplitude, pulsation, phase,
                 width=DEFAULT_WIDTH, line_types=None, forbidden=False,
                 speed_limit=20.0, priority=0):
        super().__init__(start, end, width, line_types, forbidden, speed_limit,
                         priority)
        self.amplitude = amplitude
        self.pulsation = pulsation
        self.phase = phase

    def position(self, s, lat):
        return super().position(
            s, lat + self.amplitude * np.sin(self.pulsation * s + self.phase)
        )

    def heading_at(self, s):
        return super().heading_at(s) + math.atan(
            self.amplitude * self.pulsation * np.cos(self.pulsation * s + self.phase)
        )

    def local_coordinates(self, pos):
        s, lat = super().local_coordinates(pos)
        return s, lat - self.amplitude * np.sin(self.pulsation * s + self.phase)


@dataclasses.dataclass
class CircularLane:
    """Spec of a circular-arc lane (reference road/lane.py CircularLane)."""

    center: Sequence[float]
    radius: float
    start_phase: float
    end_phase: float
    clockwise: bool = True
    width: float = DEFAULT_WIDTH
    line_types: Optional[Sequence[int]] = None
    forbidden: bool = False
    speed_limit: Optional[float] = 20.0
    priority: int = 0

    kind = CIRCULAR

    def __post_init__(self):
        self.center = np.asarray(self.center, dtype=np.float64)
        self.direction = 1 if self.clockwise else -1
        self.length = self.radius * (self.end_phase - self.start_phase) * self.direction
        if self.line_types is None:
            self.line_types = [LineType.STRIPED, LineType.STRIPED]

    def position(self, s, lat):
        phi = self.direction * np.asarray(s, np.float64) / self.radius + self.start_phase
        # stacked on the last axis, so that an (n, 1) array of s gives (n, 1, 2)
        pts = np.stack([np.cos(phi), np.sin(phi)], axis=-1)
        return self.center + (self.radius - lat * self.direction) * pts

    def heading_at(self, s):
        return self.direction * s / self.radius + self.start_phase + (
            np.pi / 2 * self.direction
        )

    def local_coordinates(self, pos):
        delta = np.asarray(pos) - self.center
        phi = math.atan2(delta[1], delta[0])
        phi = self.start_phase + ((phi - self.start_phase + np.pi) % (2 * np.pi) - np.pi)
        r = float(np.linalg.norm(delta))
        s = self.direction * (phi - self.start_phase) * self.radius
        lat = self.direction * (self.radius - r)
        return s, lat


def _interp_extrap(s, xs, ys):
    """Linear interpolation, extrapolated linearly past both ends
    (reference road/spline.py ``numpy_interp1d``)."""
    s = np.asarray(s, float)
    out = np.interp(s, xs, ys)
    left = s < xs[0]
    if np.any(left):
        slope = (ys[1] - ys[0]) / (xs[1] - xs[0])
        out = np.where(left, ys[0] + slope * (s - xs[0]), out)
    right = s > xs[-1]
    if np.any(right):
        slope = (ys[-1] - ys[-2]) / (xs[-1] - xs[-2])
        out = np.where(right, ys[-1] + slope * (s - xs[-1]), out)
    return out


class _Spline2D:
    """Piecewise-linear curve through control points, with pose samples
    every 1 m (reference road/spline.py LinearSpline2D)."""

    SAMPLE_DISTANCE = 1.0

    def __init__(self, points):
        pts = np.asarray(points, float)
        d = np.diff(pts, axis=0)
        d = np.vstack([d, d[-1]])
        arc = np.hstack([0.0, np.cumsum(np.linalg.norm(d[:-1], axis=1))])
        self.cp_s, self.cp_x, self.cp_y = arc, pts[:, 0], pts[:, 1]
        self.length = float(arc[-1])
        n = int(np.floor(self.length / self.SAMPLE_DISTANCE))
        self.s_samples = self.SAMPLE_DISTANCE * np.arange(n + 1)
        x = _interp_extrap(self.s_samples, arc, pts[:, 0])
        y = _interp_extrap(self.s_samples, arc, pts[:, 1])
        dx = np.diff(x)
        dx = np.hstack([dx, dx[-1]])
        dy = np.diff(y)
        dy = np.hstack([dy, dy[-1]])
        norm = np.sqrt(dx**2 + dy**2)
        self.pose_pos = np.stack([x, y], axis=1)
        self.pose_normal = np.stack([dx / norm, dy / norm], axis=1)

    def __call__(self, lon):
        return (float(_interp_extrap(lon, self.cp_s, self.cp_x)),
                float(_interp_extrap(lon, self.cp_s, self.cp_y)))

    def _segment(self, lon):
        """The pose sample below ``lon``: the first sample above it, minus
        one, clipped to the samples."""
        if lon >= self.s_samples[-1]:
            return len(self.s_samples) - 1
        if lon < self.s_samples[0]:
            return 0
        smaller = np.argwhere(lon < self.s_samples)
        if int(smaller[0].item()) == 0:
            return 0
        return int(smaller[0].item()) - 1

    def cartesian_to_frenet(self, position):
        """(s, lat) of a position: the last pose (index >= 1) it projects
        forward of wins, pose 0 is the fallback."""
        p = np.asarray(position, float)
        ortho = np.stack([-self.pose_normal[:, 1], self.pose_normal[:, 0]], axis=1)
        proj = np.einsum("sd,sd->s", self.pose_normal, p - self.pose_pos)
        for idx in range(len(self.s_samples) - 1, 0, -1):
            if proj[idx] >= 0:
                return (float(self.s_samples[idx] + proj[idx]),
                        float(ortho[idx] @ (p - self.pose_pos[idx])))
        return float(proj[0]), float(ortho[0] @ (p - self.pose_pos[0]))


class PolyLaneFixedWidth:
    """Fixed-width piecewise-linear lane (reference road/lane.py
    PolyLaneFixedWidth)."""

    kind = POLY

    def __init__(self, lane_points, width: float = DEFAULT_WIDTH, line_types=None,
                 forbidden: bool = False, speed_limit: float = 20, priority: int = 0):
        self.curve = _Spline2D(lane_points)
        self.lane_points = [list(map(float, p)) for p in lane_points]
        self.length = self.curve.length
        self.width = width
        self.line_types = list(line_types) if line_types else [1, 1]
        self.forbidden = forbidden
        self.speed_limit = speed_limit
        self.priority = priority

    def width_samples(self):
        """The width at each pose sample: constant here."""
        return np.full(len(self.curve.s_samples), self.width, float)

    def heading_at(self, s):
        n = self.curve.pose_normal[self.curve._segment(s)]
        return float(np.arctan2(n[1], n[0]))

    def position(self, s, lat):
        x, y = self.curve(s)
        yaw = self.heading_at(s)
        return np.array([x - np.sin(yaw) * lat, y + np.cos(yaw) * lat])

    def local_coordinates(self, pos):
        return self.curve.cartesian_to_frenet(pos)


class PolyLane(PolyLaneFixedWidth):
    """Variable-width poly lane between two boundary curves (reference
    road/lane.py PolyLane); its width is sampled every ~1 m."""

    def __init__(self, lane_points, left_boundary_points, right_boundary_points,
                 line_types=None, forbidden: bool = False, speed_limit: float = 20,
                 priority: int = 0):
        super().__init__(lane_points, line_types=line_types, forbidden=forbidden,
                         speed_limit=speed_limit, priority=priority)
        self.left_boundary = _Spline2D(left_boundary_points)
        self.right_boundary = _Spline2D(right_boundary_points)
        s_samples = np.linspace(0, self.curve.length,
                                num=int(np.ceil(self.curve.length)) + 1)
        self._width_samples = np.array([self._width_at_s(s) for s in s_samples])
        self.width = float(self._width_samples[0])

    def _width_at_s(self, s):
        cx, cy = self.position(s, 0)
        r_lon, _ = self.right_boundary.cartesian_to_frenet([cx, cy])
        rx, ry = self.right_boundary(r_lon)
        l_lon, _ = self.left_boundary.cartesian_to_frenet([cx, cy])
        lx, ly = self.left_boundary(l_lon)
        d_r = np.hypot(rx - cx, ry - cy)
        d_l = np.hypot(lx - cx, ly - cy)
        return max(min(d_r, d_l) * 2, DEFAULT_WIDTH)

    def width_samples(self):
        """The widths at int(s)."""
        return np.asarray(self._width_samples, float)


def lane_from_config(cfg: dict):
    """A lane spec from its serialized config (reference road/lane.py
    ``lane_from_config``; poly lanes under "class_name", the others under
    "class_path")."""
    path = cfg.get("class_path") or cfg.get("class_name")
    name = path.rsplit(".", 1)[-1]
    kwargs = dict(cfg["config"])
    if name == "StraightLane":
        return StraightLane(**kwargs)
    if name == "SineLane":
        return SineLane(**kwargs)
    if name == "CircularLane":
        return CircularLane(**kwargs)
    if name == "PolyLaneFixedWidth":
        return PolyLaneFixedWidth(**kwargs)
    if name == "PolyLane":
        pts = kwargs.pop("ordered_boundary_points")
        half = len(pts) // 2
        return PolyLane(left_boundary_points=list(reversed(pts[:half])),
                        right_boundary_points=pts[half:], **kwargs)
    raise ValueError(f"Unknown lane class {path}")


LANE_SPECS = (StraightLane, SineLane, CircularLane, PolyLaneFixedWidth, PolyLane)


class RoadNetworkBuilder:
    """Accumulates lanes per (from, to) edge, then compiles to LaneGeometry."""

    def __init__(self):
        # edge order = first appearance; lanes keep insertion order
        self._edges: dict[tuple[str, str], list] = {}
        self._node_ids: dict[str, int] = {}

    def add_lane(self, _from: str, _to: str, lane) -> None:
        if type(lane) not in LANE_SPECS:
            raise NotImplementedError(
                f"{type(lane).__name__}: lane kinds other than straight, sine, "
                "circular and poly are not ported"
            )
        self._edges.setdefault((_from, _to), []).append(lane)
        for node in (_from, _to):
            self._node_ids.setdefault(node, len(self._node_ids))

    @property
    def edges(self):
        return self._edges

    # ------------------------------------------------------------------ #
    # host-side queries of the scenario resets
    # ------------------------------------------------------------------ #
    def get_lane(self, index):
        _from, _to, _id = index
        lanes = self._edges[(_from, _to)]
        return lanes[0 if _id is None and len(lanes) == 1 else _id]

    def lanes_on_edge(self, _from: str, _to: str):
        return self._edges[(_from, _to)]

    def global_lane_index(self, index) -> int:
        """Global lane id of a (from, to, id) reference-style index."""
        _from, _to, _id = index
        base = 0
        for key, lanes in self._edges.items():
            if key == (_from, _to):
                return base + (0 if _id is None else _id)
            base += len(lanes)
        raise KeyError(index)

    def node_id(self, name: str) -> int:
        return self._node_ids[name]

    def lane_index_from_global(self, g: int) -> tuple[str, str, int]:
        """Inverse of ``global_lane_index``."""
        base = 0
        for (f, t), lanes in self._edges.items():
            if g < base + len(lanes):
                return (f, t, g - base)
            base += len(lanes)
        raise KeyError(g)

    def connectivity_matrix(self, depth: int = 3, same_lane: bool = False) -> np.ndarray:
        """(L, L) bool host matrix of reference road/road.py
        ``is_connected_road(l1, l2, depth=depth)`` on its route-less path:
        l2 is on l1's road, or on a road that leads into it, within
        ``depth`` successor edges of l1 keeping its lane id.  The
        time-to-collision grid (``observations/ttc.py``) gates on it."""
        indices = [(f, t, i) for (f, t), lanes in self._edges.items()
                   for i in range(len(lanes))]

        def connected(i1, i2, depth):
            f1, t1, id1 = i1
            f2, t2, id2 = i2
            lane_ok = not same_lane or id1 == id2
            if ((f1, t1) == (f2, t2) or t2 == f1) and lane_ok:
                return True
            return depth > 0 and any(
                connected((t1, nt, id1), i2, depth - 1)
                for nf, nt in self._edges if nf == t1
            )

        return np.array([[connected(i1, i2, depth) for i2 in indices]
                         for i1 in indices], dtype=bool).reshape(
            len(indices), len(indices))

    def bfs_shortest_path(self, start: str, goal: str) -> list[str]:
        """Breadth-first shortest node path (reference road/road.py
        ``bfs_paths``), successors visited in sorted order."""
        graph: dict[str, list[str]] = {}
        for f, t in self._edges:
            graph.setdefault(f, [])
            if t not in graph[f]:
                graph[f].append(t)
        if start not in graph:
            return []
        queue = [(start, [start])]
        while queue:
            node, path = queue.pop(0)
            for nxt in sorted(k for k in graph.get(node, []) if k not in path):
                if nxt == goal:
                    return path + [nxt]
                if nxt in graph:
                    queue.append((nxt, path + [nxt]))
        return []

    def route_arrays(self, start_index, destination: str, route_slots: int):
        """``ControlledVehicle.plan_route_to`` compiled into fixed-width
        arrays: the route ``[start_index] + [(path[i], path[i+1], None)]``
        over the BFS node path from the start lane's end node.  Returns
        (route_base, route_n, route_id, route_len): per segment its edge's
        global base lane, lane count and explicit lane id (-1 = ``None``)."""
        _from, _to, _id = start_index
        path = self.bfs_shortest_path(_to, destination)
        route = [start_index]
        if path:
            route += [(path[i], path[i + 1], None) for i in range(len(path) - 1)]
        base = np.full(route_slots, -1, np.int32)
        n = np.zeros(route_slots, np.int32)
        rid = np.full(route_slots, -1, np.int32)
        for i, (f, t, lid) in enumerate(route[:route_slots]):
            base[i] = self.global_lane_index((f, t, 0))
            n[i] = len(self._edges[(f, t)])
            rid[i] = -1 if lid is None else int(lid)
        return base, n, rid, min(len(route), route_slots)

    # ------------------------------------------------------------------ #
    # serialization (reference road/road.py ``to_config`` / ``from_config``)
    # ------------------------------------------------------------------ #
    _CLASS_PATHS = {
        "StraightLane": "highway_env.road.lane.StraightLane",
        "SineLane": "highway_env.road.lane.SineLane",
        "CircularLane": "highway_env.road.lane.CircularLane",
    }

    def to_config(self) -> dict:
        """Nested ``{from: {to: [lane config]}}`` dict with the reference's
        class paths and keys."""
        graph: dict = {}
        for (f, t), lanes in self._edges.items():
            graph.setdefault(f, {})[t] = [self._lane_to_config(lane) for lane in lanes]
        return graph

    def _lane_to_config(self, lane) -> dict:
        common = {
            "width": float(lane.width),
            "line_types": [int(x) for x in lane.line_types],
            "forbidden": bool(lane.forbidden),
            "speed_limit": lane.speed_limit,
            "priority": int(lane.priority),
        }
        if isinstance(lane, PolyLane):
            # the reference's poly lanes serialize under "class_name"
            bnd = [list(p) for p in reversed(self._spline_points(lane.left_boundary))]
            bnd += [list(p) for p in self._spline_points(lane.right_boundary)]
            cfg = {"lane_points": lane.lane_points, "ordered_boundary_points": bnd,
                   **{k: v for k, v in common.items() if k != "width"}}
            return {"class_name": "PolyLane", "config": cfg}
        if isinstance(lane, PolyLaneFixedWidth):
            return {"class_name": "PolyLaneFixedWidth",
                    "config": {"lane_points": lane.lane_points, **common}}
        if isinstance(lane, SineLane):
            cfg = {"start": [float(x) for x in lane.start],
                   "end": [float(x) for x in lane.end],
                   "amplitude": float(lane.amplitude), "pulsation": float(lane.pulsation),
                   "phase": float(lane.phase), **common}
            path = self._CLASS_PATHS["SineLane"]
        elif isinstance(lane, StraightLane):
            cfg = {"start": [float(x) for x in lane.start],
                   "end": [float(x) for x in lane.end], **common}
            path = self._CLASS_PATHS["StraightLane"]
        elif isinstance(lane, CircularLane):
            cfg = {"center": [float(x) for x in lane.center], "radius": float(lane.radius),
                   "start_phase": float(lane.start_phase),
                   "end_phase": float(lane.end_phase), "clockwise": bool(lane.clockwise),
                   **common}
            path = self._CLASS_PATHS["CircularLane"]
        else:
            raise TypeError(type(lane))
        return {"class_path": path, "config": cfg}

    @staticmethod
    def _spline_points(spline: _Spline2D):
        return list(zip(spline.cp_x.tolist(), spline.cp_y.tolist()))

    @classmethod
    def from_config(cls, config: dict) -> "RoadNetworkBuilder":
        net = cls()
        for _from, to_dict in config.items():
            for _to, lanes in to_dict.items():
                for lane_cfg in lanes:
                    net.add_lane(_from, _to, lane_from_config(lane_cfg))
        return net

    @staticmethod
    def straight_road_network(
        lanes: int = 4,
        start: float = 0.0,
        length: float = 10000.0,
        angle: float = 0.0,
        speed_limit: float = 30.0,
        nodes_str=None,
        net: "RoadNetworkBuilder | None" = None,
    ) -> "RoadNetworkBuilder":
        """Reference road/road.py ``straight_road_network``."""
        net = net or RoadNetworkBuilder()
        nodes_str = nodes_str or ("0", "1")
        rotation = np.array(
            [[np.cos(angle), np.sin(angle)], [-np.sin(angle), np.cos(angle)]]
        )
        for lane in range(lanes):
            origin = rotation @ np.array([start, lane * DEFAULT_WIDTH])
            end = rotation @ np.array([start + length, lane * DEFAULT_WIDTH])
            line_types = [
                LineType.CONTINUOUS_LINE if lane == 0 else LineType.STRIPED,
                LineType.CONTINUOUS_LINE if lane == lanes - 1 else LineType.NONE,
            ]
            net.add_lane(
                *nodes_str,
                StraightLane(
                    origin, end, line_types=line_types, speed_limit=speed_limit
                ),
            )
        return net

    def build(self, device=None) -> LaneGeometry:
        """Compile the lane tables onto ``device``."""
        lanes = [lane for ls in self._edges.values() for lane in ls]
        L = len(lanes)
        if L == 0:
            raise ValueError("empty road network")
        f32, i32 = np.float32, np.int32
        t = {
            "kind": np.zeros(L, i32),
            "start": np.zeros((L, 2), f32),
            "end": np.zeros((L, 2), f32),
            "direction": np.zeros((L, 2), f32),
            "direction_lateral": np.zeros((L, 2), f32),
            "heading0": np.zeros(L, f32),
            "amplitude": np.zeros(L, f32),
            "pulsation": np.zeros(L, f32),
            "phase": np.zeros(L, f32),
            "center": np.zeros((L, 2), f32),
            "radius": np.ones(L, f32),
            "start_phase": np.zeros(L, f32),
            "cw": np.ones(L, f32),
            "width": np.zeros(L, f32),
            "length": np.zeros(L, f32),
            "speed_limit": np.zeros(L, f32),
            "forbidden": np.zeros(L, bool),
            "priority": np.zeros(L, i32),
            "line_types": np.zeros((L, 2), i32),
            "from_node": np.zeros(L, i32),
            "to_node": np.zeros(L, i32),
            "lane_id": np.zeros(L, i32),
            "edge_id": np.zeros(L, i32),
            "edge_base": np.zeros(L, i32),
            "edge_n": np.zeros(L, i32),
        }
        edge_bases = {}
        g = 0
        for e, (key, edge_lanes) in enumerate(self._edges.items()):
            edge_bases[key] = g
            for i, lane in enumerate(edge_lanes):
                t["kind"][g] = lane.kind
                if lane.kind == CIRCULAR:
                    t["center"][g] = lane.center
                    t["radius"][g] = lane.radius
                    t["start_phase"][g] = lane.start_phase
                    t["cw"][g] = lane.direction
                elif lane.kind != POLY:  # poly lanes live in the sample bank
                    t["start"][g] = lane.start
                    t["end"][g] = lane.end
                    t["direction"][g] = lane.direction
                    t["direction_lateral"][g] = lane.direction_lateral
                    t["heading0"][g] = lane.heading
                if lane.kind == SINE:
                    t["amplitude"][g] = lane.amplitude
                    t["pulsation"][g] = lane.pulsation
                    t["phase"][g] = lane.phase
                t["width"][g] = lane.width
                t["length"][g] = lane.length
                t["speed_limit"][g] = (
                    np.inf if lane.speed_limit is None else lane.speed_limit
                )
                t["forbidden"][g] = lane.forbidden
                t["priority"][g] = lane.priority
                lt = list(lane.line_types)[:2]
                t["line_types"][g] = [int(x) for x in lt] if len(lt) == 2 else [1, 1]
                t["from_node"][g] = self._node_ids[key[0]]
                t["to_node"][g] = self._node_ids[key[1]]
                t["lane_id"][g] = i
                t["edge_id"][g] = e
                t["edge_base"][g] = edge_bases[key]
                t["edge_n"][g] = len(edge_lanes)
                g += 1

        # successors follow per-node edge insertion; predecessors follow the
        # from-node's first appearance as an outer graph key (PARITY #10)
        from_rank: dict[int, int] = {}
        for key in self._edges:
            from_rank.setdefault(self._node_ids[key[0]], len(from_rank))
        succ: dict[int, list] = {}
        pred_raw: dict[int, list] = {}
        for key, edge_lanes in self._edges.items():
            b, n = edge_bases[key], len(edge_lanes)
            fn, tn = self._node_ids[key[0]], self._node_ids[key[1]]
            succ.setdefault(fn, []).append((b, n))
            pred_raw.setdefault(tn, []).append((from_rank[fn], b, n))
        pred = {
            tn: [(b, n) for _, b, n in sorted(entries)]
            for tn, entries in pred_raw.items()
        }
        S = max(1, max(len(v) for v in succ.values()))
        P = max(1, max(len(v) for v in pred.values()))
        t["succ_edge_base"] = np.full((L, S), -1, i32)
        t["succ_edge_n"] = np.zeros((L, S), i32)
        t["pred_edge_base"] = np.full((L, P), -1, i32)
        t["pred_edge_n"] = np.zeros((L, P), i32)
        for g in range(L):
            for j, (b, n) in enumerate(succ.get(int(t["to_node"][g]), [])):
                t["succ_edge_base"][g, j] = b
                t["succ_edge_n"][g, j] = n
            for j, (b, n) in enumerate(pred.get(int(t["from_node"][g]), [])):
                t["pred_edge_base"][g, j] = b
                t["pred_edge_n"][g, j] = n
        # the connected-lane search's candidates: the lane itself (offset
        # 0), each successor edge's lane of the same id (or lane 0) at
        # +own length, each predecessor edge's at -its length
        t["conn_lanes"] = np.full((L, 1 + S + P), -1, i32)
        t["conn_offsets"] = np.zeros((L, 1 + S + P), f32)
        for g in range(L):
            lid = t["lane_id"][g]
            cands = [(g, 0.0)]
            for b, n in succ.get(int(t["to_node"][g]), []):
                cands.append((b + (lid if lid < n else 0), t["length"][g]))
            for b, n in pred.get(int(t["from_node"][g]), []):
                prev = b + (lid if lid < n else 0)
                cands.append((prev, -t["length"][prev]))
            for k, (lane, offset) in enumerate(cands):
                t["conn_lanes"][g, k] = lane
                t["conn_offsets"][g, k] = offset
        geo = LaneGeometry(**{k: torch.as_tensor(v, device=device) for k, v in t.items()})
        geo.all_straight = bool((t["kind"] == STRAIGHT).all())
        geo.poly = _poly_bank(lanes, device)
        return geo


def _poly_bank(lanes: list, device) -> PolyBank | None:
    """The sample bank of the poly lanes among ``lanes`` (global order), in
    float32 as the JAX package's ``build`` pads it, or None without one."""
    poly = [(g, lane) for g, lane in enumerate(lanes) if lane.kind == POLY]
    if not poly:
        return None
    f32, i32 = np.float32, np.int32
    P = len(poly)
    S = max(len(lane.curve.s_samples) for _, lane in poly)
    C = max(len(lane.curve.cp_s) for _, lane in poly)
    Sw = max(max(len(lane.width_samples()) for _, lane in poly), S)
    b = {
        "slot": np.full(len(lanes), -1, i32),
        "pos": np.zeros((P, S, 2), f32),
        "normal": np.zeros((P, S, 2), f32),
        "n": np.zeros(P, i32),
        "cp_s": np.full((P, C), np.inf, f32),
        "cp_x": np.zeros((P, C), f32),
        "cp_y": np.zeros((P, C), f32),
        "cp_n": np.zeros(P, i32),
        "width": np.zeros((P, Sw), f32),
    }
    for p, (g, lane) in enumerate(poly):
        curve = lane.curve
        b["slot"][g] = p
        n, c_n = len(curve.s_samples), len(curve.cp_s)
        b["pos"][p, :n], b["pos"][p, n:] = curve.pose_pos, curve.pose_pos[-1]
        b["normal"][p, :n], b["normal"][p, n:] = curve.pose_normal, curve.pose_normal[-1]
        b["n"][p] = n
        b["cp_s"][p, :c_n] = curve.cp_s
        b["cp_x"][p, :c_n], b["cp_x"][p, c_n:] = curve.cp_x, curve.cp_x[-1]
        b["cp_y"][p, :c_n], b["cp_y"][p, c_n:] = curve.cp_y, curve.cp_y[-1]
        b["cp_n"][p] = c_n
        ws = lane.width_samples()
        b["width"][p, :len(ws)], b["width"][p, len(ws):] = ws, ws[-1]
    return PolyBank(**{k: torch.as_tensor(v, device=device) for k, v in b.items()})
