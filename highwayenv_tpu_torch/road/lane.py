"""Straight-lane geometry tables and the lane ops the highway path uses.

PyTorch counterpart of the StraightLane rows of
``highwayenv_tpu/road/lane.py``: the road network is compiled once into a
``LaneGeometry`` of per-lane tensors, and every lane op is a gather by lane
index plus elementwise arithmetic.  Sine, circular and poly lanes are not
ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Lane type enum
STRAIGHT = 0

# AbstractLane constants (reference road/lane.py)
DEFAULT_WIDTH = 4.0
VEHICLE_LENGTH = 5.0

# LineType enum (reference road/lane.py)
LINE_NONE = 0
LINE_STRIPED = 1
LINE_CONTINUOUS = 2
LINE_CONTINUOUS_LINE = 3


class LaneGeometry(NamedTuple):
    """Per-lane tables, leading dim L.  Lanes of one edge occupy contiguous
    global indices; ``global_id = edge_base + lane_id``."""

    kind: torch.Tensor  # (L,) i32
    start: torch.Tensor  # (L,2) f32
    end: torch.Tensor  # (L,2) f32
    direction: torch.Tensor  # (L,2) unit vector along the lane
    direction_lateral: torch.Tensor  # (L,2) left-normal
    heading0: torch.Tensor  # (L,) lane heading
    width: torch.Tensor  # (L,)
    length: torch.Tensor  # (L,)
    speed_limit: torch.Tensor  # (L,) +inf when unlimited
    forbidden: torch.Tensor  # (L,) bool
    priority: torch.Tensor  # (L,) i32
    line_types: torch.Tensor  # (L,2) i32
    from_node: torch.Tensor  # (L,) i32
    to_node: torch.Tensor  # (L,) i32
    lane_id: torch.Tensor  # (L,) i32 local id within its edge
    edge_id: torch.Tensor  # (L,) i32
    edge_base: torch.Tensor  # (L,) i32 global index of the edge's lane 0
    edge_n: torch.Tensor  # (L,) i32 lanes on this edge
    succ_edge_base: torch.Tensor  # (L,S) i32, -1 pad
    succ_edge_n: torch.Tensor  # (L,S) i32
    pred_edge_base: torch.Tensor  # (L,P) i32, -1 pad
    pred_edge_n: torch.Tensor  # (L,P) i32

    @property
    def num_lanes(self) -> int:
        return self.kind.shape[0]


def _gather(geo: LaneGeometry, lane: torch.Tensor) -> torch.Tensor:
    """Clip lane indices into range (callers mask invalid lanes themselves)."""
    return lane.clamp(0, geo.num_lanes - 1).long()


def local_coordinates(geo: LaneGeometry, lane: torch.Tensor, pos: torch.Tensor):
    """(longitudinal, lateral) coordinates of world positions on a lane.

    lane: (...,) int; pos: (..., 2).  Returns two (...,) tensors.
    """
    li = _gather(geo, lane)
    dx = pos[..., 0] - geo.start[li, 0]
    dy = pos[..., 1] - geo.start[li, 1]
    d, n = geo.direction[li], geo.direction_lateral[li]
    return dx * d[..., 0] + dy * d[..., 1], dx * n[..., 0] + dy * n[..., 1]


def position(geo: LaneGeometry, lane, s, lat):
    """World position at local lane coordinates: (..., 2)."""
    li = _gather(geo, lane)
    return (
        geo.start[li]
        + s[..., None] * geo.direction[li]
        + lat[..., None] * geo.direction_lateral[li]
    )


def heading_at(geo: LaneGeometry, lane, s):
    return geo.heading0[_gather(geo, lane)].expand(s.shape)


def on_lane(geo: LaneGeometry, lane, s, lat, margin: float = 0.0):
    """Reference road/lane.py ``on_lane`` with precomputed coordinates."""
    li = _gather(geo, lane)
    return (
        (lat.abs() <= geo.width[li] / 2 + margin)
        & (-VEHICLE_LENGTH <= s)
        & (s < geo.length[li] + VEHICLE_LENGTH)
    )


def is_reachable_from(geo: LaneGeometry, lane, pos):
    """Reference road/lane.py ``is_reachable_from``."""
    li = _gather(geo, lane)
    s, lat = local_coordinates(geo, lane, pos)
    close = (
        (lat.abs() <= 2 * geo.width[li])
        & (0 <= s)
        & (s < geo.length[li] + VEHICLE_LENGTH)
    )
    return close & ~geo.forbidden[li]
