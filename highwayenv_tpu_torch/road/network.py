"""Host-side road-network builder: straight lane specs -> LaneGeometry.

PyTorch counterpart of the straight subset of
``highwayenv_tpu/road/network.py``: node names become integer ids, lanes of
one edge get contiguous global indices, and successor / predecessor edges
are flattened into fixed-width padded tables, all built once in numpy and
moved to the env's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from highwayenv_tpu_torch.road.lane import (
    DEFAULT_WIDTH,
    LINE_CONTINUOUS,
    LINE_CONTINUOUS_LINE,
    LINE_NONE,
    LINE_STRIPED,
    STRAIGHT,
    LaneGeometry,
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


class RoadNetworkBuilder:
    """Accumulates lanes per (from, to) edge, then compiles to LaneGeometry."""

    def __init__(self):
        # edge order = first appearance; lanes keep insertion order
        self._edges: dict[tuple[str, str], list] = {}
        self._node_ids: dict[str, int] = {}

    def add_lane(self, _from: str, _to: str, lane) -> None:
        if type(lane) is not StraightLane:
            raise NotImplementedError(
                f"{type(lane).__name__} is not ported yet; straight lanes only"
            )
        self._edges.setdefault((_from, _to), []).append(lane)
        for node in (_from, _to):
            self._node_ids.setdefault(node, len(self._node_ids))

    @property
    def edges(self):
        return self._edges

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
                t["start"][g] = lane.start
                t["end"][g] = lane.end
                t["direction"][g] = lane.direction
                t["direction_lateral"][g] = lane.direction_lateral
                t["heading0"][g] = lane.heading
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
        return LaneGeometry(
            **{k: torch.as_tensor(v, device=device) for k, v in t.items()}
        )
