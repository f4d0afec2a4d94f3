"""Lane geometry tables and the lane ops of the straight and general paths.

PyTorch counterpart of the analytic rows of ``highwayenv_tpu/road/lane.py``
(reference road/lane.py StraightLane, SineLane, CircularLane): the road
network is compiled once into a ``LaneGeometry`` of per-lane tensors, and
every lane op is a gather by lane index plus elementwise arithmetic.  Each
op computes the straight, sine and circular forms and selects by the lane's
kind, as the JAX package's ``_local_core`` / ``_position_core`` /
``_heading_core`` do; on a network of straight lanes only
(``geo.all_straight``, set when the network is built) it computes the
straight form alone, so the highway path runs the same operations as before
the curved lanes were ported.  Poly lanes are not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from highwayenv_tpu_torch.utils.math import wrap_to_pi

# Lane type enum
STRAIGHT = 0
SINE = 1
CIRCULAR = 2

# AbstractLane constants (reference road/lane.py)
DEFAULT_WIDTH = 4.0
VEHICLE_LENGTH = 5.0

# LineType enum (reference road/lane.py)
LINE_NONE = 0
LINE_STRIPED = 1
LINE_CONTINUOUS = 2
LINE_CONTINUOUS_LINE = 3


class LaneTables(NamedTuple):
    """Per-lane tables, leading dim L.  Lanes of one edge occupy contiguous
    global indices; ``global_id = edge_base + lane_id``."""

    kind: torch.Tensor  # (L,) i32: STRAIGHT / SINE / CIRCULAR
    start: torch.Tensor  # (L,2) f32 (straight and sine axis)
    end: torch.Tensor  # (L,2) f32
    direction: torch.Tensor  # (L,2) unit vector along the axis
    direction_lateral: torch.Tensor  # (L,2) left-normal
    heading0: torch.Tensor  # (L,) axis heading
    amplitude: torch.Tensor  # (L,) sine amplitude
    pulsation: torch.Tensor  # (L,) sine pulsation [rad/m]
    phase: torch.Tensor  # (L,) sine phase [rad]
    center: torch.Tensor  # (L,2) circle centre
    radius: torch.Tensor  # (L,) circle radius (1 on other kinds)
    start_phase: torch.Tensor  # (L,)
    cw: torch.Tensor  # (L,) +1 clockwise / -1 counter-clockwise
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
    #: the connected-lane search's candidates of each lane: itself, then its
    #: successor edges' lanes, then its predecessor edges' lanes, -1 pad
    conn_lanes: torch.Tensor  # (L,K) i32, K = 1 + S + P
    conn_offsets: torch.Tensor  # (L,K) f32: a candidate's s shifted into the lane's frame

    @property
    def num_lanes(self) -> int:
        return self.kind.shape[0]


class LaneGeometry(LaneTables):
    """The lane tables plus a host flag kept beside them, not among them."""

    #: every lane is straight, so the lane ops take the straight form alone;
    #: ``RoadNetworkBuilder.build`` sets it on the instance, and tables built
    #: otherwise take the general form, right on any network
    all_straight = False


def _gather(geo: LaneGeometry, lane: torch.Tensor) -> torch.Tensor:
    """Clip lane indices into range (callers mask invalid lanes themselves)."""
    return lane.clamp(0, geo.num_lanes - 1).long()


def _local_core(geo: LaneGeometry, li: torch.Tensor, px, py):
    """(s, lat) of the points (px, py) on the lanes ``li`` (clipped long
    indices), broadcast together (JAX ``_local_core``, float32 branch)."""
    dx = px - geo.start[li, 0]
    dy = py - geo.start[li, 1]
    d, n = geo.direction[li], geo.direction_lateral[li]
    s = dx * d[..., 0] + dy * d[..., 1]
    lat = dx * n[..., 0] + dy * n[..., 1]
    if geo.all_straight:
        return s, lat
    kind = geo.kind[li]
    lat_sin = lat - geo.amplitude[li] * torch.sin(
        geo.pulsation[li] * s + geo.phase[li]
    )
    dcx = px - geo.center[li, 0]
    dcy = py - geo.center[li, 1]
    sp = geo.start_phase[li]
    phi = sp + wrap_to_pi(torch.atan2(dcy, dcx) - sp)
    r = torch.sqrt(dcx * dcx + dcy * dcy)
    cw, radius = geo.cw[li], geo.radius[li]
    cir = kind == CIRCULAR
    return (
        torch.where(cir, cw * (phi - sp) * radius, s),
        torch.where(cir, cw * (radius - r), torch.where(kind == SINE, lat_sin, lat)),
    )


def local_coordinates(geo: LaneGeometry, lane: torch.Tensor, pos: torch.Tensor):
    """(longitudinal, lateral) coordinates of world positions on a lane.

    lane: (...,) int; pos: (..., 2), broadcast together.  Returns two
    tensors of the broadcast shape.
    """
    return _local_core(geo, _gather(geo, lane), pos[..., 0], pos[..., 1])


def position(geo: LaneGeometry, lane, s, lat):
    """World position at local lane coordinates: (..., 2)."""
    li = _gather(geo, lane)
    if geo.all_straight:
        return (
            geo.start[li]
            + s[..., None] * geo.direction[li]
            + lat[..., None] * geo.direction_lateral[li]
        )
    kind = geo.kind[li]
    lat_eff = torch.where(
        kind == SINE,
        lat + geo.amplitude[li] * torch.sin(geo.pulsation[li] * s + geo.phase[li]),
        lat,
    )
    p_str = (
        geo.start[li]
        + s[..., None] * geo.direction[li]
        + lat_eff[..., None] * geo.direction_lateral[li]
    )
    cw, radius = geo.cw[li], geo.radius[li]
    phi = cw * s / radius + geo.start_phase[li]
    p_cir = geo.center[li] + (radius - lat * cw)[..., None] * torch.stack(
        [torch.cos(phi), torch.sin(phi)], dim=-1
    )
    return torch.where((kind == CIRCULAR)[..., None], p_cir, p_str)


def heading_at(geo: LaneGeometry, lane, s):
    """Lane heading at longitudinal coordinate ``s`` (broadcast)."""
    li = _gather(geo, lane)
    if geo.all_straight:
        return geo.heading0[li].expand(torch.broadcast_shapes(li.shape, s.shape))
    kind = geo.kind[li]
    h_sin = geo.heading0[li] + torch.atan(
        geo.amplitude[li] * geo.pulsation[li]
        * torch.cos(geo.pulsation[li] * s + geo.phase[li])
    )
    cw = geo.cw[li]
    h_cir = cw * s / geo.radius[li] + geo.start_phase[li] + math.pi / 2 * cw
    return torch.where(
        kind == CIRCULAR, h_cir, torch.where(kind == SINE, h_sin, geo.heading0[li])
    )


def on_lane(geo: LaneGeometry, lane, s, lat, margin: float = 0.0):
    """Reference road/lane.py ``on_lane`` with precomputed coordinates."""
    li = _gather(geo, lane)
    return (
        (lat.abs() <= geo.width[li] / 2 + margin)
        & (-VEHICLE_LENGTH <= s)
        & (s < geo.length[li] + VEHICLE_LENGTH)
    )


def reachable_from_coords(geo: LaneGeometry, lane, s, lat):
    """Reference road/lane.py ``is_reachable_from`` with precomputed
    coordinates."""
    li = _gather(geo, lane)
    close = (
        (lat.abs() <= 2 * geo.width[li])
        & (0 <= s)
        & (s < geo.length[li] + VEHICLE_LENGTH)
    )
    return close & ~geo.forbidden[li]


def is_reachable_from(geo: LaneGeometry, lane, pos):
    """Reference road/lane.py ``is_reachable_from``."""
    s, lat = local_coordinates(geo, lane, pos)
    return reachable_from_coords(geo, lane, s, lat)


def distance(geo: LaneGeometry, lane, pos):
    """L1-ish distance from a position to the lane (reference road/lane.py
    ``distance``)."""
    li = _gather(geo, lane)
    s, lat = local_coordinates(geo, lane, pos)
    return lat.abs() + (s - geo.length[li]).clamp(min=0.0) + (-s).clamp(min=0.0)


def local_angle(geo: LaneGeometry, lane, heading, s):
    """The heading relative to the lane's at ``s``, wrapped to [-pi, pi)
    (reference road/lane.py ``local_angle``)."""
    return wrap_to_pi(heading - heading_at(geo, lane, s))


def _heading_distance(geo, s, lat, heading, heading_weight: float = 1.0):
    """``distance_with_heading`` over (..., L, V) tables of every lane:
    |lat| + overrun past either end + the weighted heading difference."""
    all_lanes = torch.arange(geo.num_lanes, device=s.device)[:, None]
    angle = wrap_to_pi(heading[..., None, :] - heading_at(geo, all_lanes, s)).abs()
    length = geo.length[:, None]
    return (
        lat.abs() + (s - length).clamp(min=0.0) + (-s).clamp(min=0.0)
        + heading_weight * angle
    )


def projection_table(geo: LaneGeometry, pos: torch.Tensor):
    """(s, lat) of every object on every lane: pos (..., V, 2) -> two
    (..., L, V) tensors."""
    all_lanes = torch.arange(geo.num_lanes, device=pos.device)[:, None]
    return _local_core(
        geo, all_lanes, pos[..., None, :, 0], pos[..., None, :, 1]
    )


def closest_lane_from_table(geo: LaneGeometry, s, lat, heading):
    """Global index of the lane minimizing ``distance_with_heading``, from a
    (..., L, V) projection table and the (..., V) headings; the first
    minimum wins (reference road/road.py ``get_closest_lane_index``)."""
    d = _heading_distance(geo, s, lat, heading)
    return torch.argmin(d, dim=-2).to(torch.int32)


def closest_lane(geo: LaneGeometry, pos: torch.Tensor, heading: torch.Tensor):
    """``closest_lane_from_table`` of positions (..., V, 2)."""
    s, lat = projection_table(geo, pos)
    return closest_lane_from_table(geo, s, lat, heading)
