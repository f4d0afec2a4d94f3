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
the curved lanes were ported.

Poly lanes (reference road/lane.py PolyLaneFixedWidth, PolyLane) live in a
sample bank (``PolyBank``: 1 m pose samples, control points, widths) that
``RoadNetworkBuilder.build`` sets on ``geo.poly`` only when the network has
one; the ops then compute the poly form too and select it by kind, as the
JAX package's ``has_poly`` branches do.  On a network without one
(``geo.poly is None``) every op runs the same operations as before poly
lanes were ported.
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
POLY = 3  # piecewise-linear lane of 1 m pose samples

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

    kind: torch.Tensor  # (L,) i32: STRAIGHT / SINE / CIRCULAR / POLY
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


class PolyBank(NamedTuple):
    """The sample bank of a network's P poly lanes (JAX ``LaneGeometry``'s
    ``poly_*`` fields): per lane an index into (P, S) pose tables and (P, C)
    control points, padded with the last entry (``cp_s`` with +inf)."""

    slot: torch.Tensor  # (L,) i32 bank row of a poly lane, -1 on the others
    pos: torch.Tensor  # (P,S,2) f32 1 m pose samples
    normal: torch.Tensor  # (P,S,2) f32 unit tangents
    n: torch.Tensor  # (P,) i32 pose samples
    cp_s: torch.Tensor  # (P,C) f32 control-point arc lengths, +inf pad
    cp_x: torch.Tensor  # (P,C) f32
    cp_y: torch.Tensor  # (P,C) f32
    cp_n: torch.Tensor  # (P,) i32 control points
    width: torch.Tensor  # (P,Sw) f32 widths at int(s) (PolyLane's variable width)


class LaneGeometry(LaneTables):
    """The lane tables plus host attributes kept beside them, not among
    them (so that the kernels' inputs stay the analytic tables)."""

    #: every lane is straight, so the lane ops take the straight form alone;
    #: ``RoadNetworkBuilder.build`` sets it on the instance, and tables built
    #: otherwise take the general form, right on any network
    all_straight = False
    #: the poly lanes' sample bank, or None on a network without one
    poly: PolyBank | None = None


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
    li = _gather(geo, lane)
    s, lat = _local_core(geo, li, pos[..., 0], pos[..., 1])
    if geo.poly is None:
        return s, lat
    s_pol, lat_pol, _ = _poly_frenet(geo, li, pos)
    pol = geo.kind[li] == POLY
    return torch.where(pol, s_pol, s), torch.where(pol, lat_pol, lat)


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
    out = torch.where((kind == CIRCULAR)[..., None], p_cir, p_str)
    if geo.poly is None:
        return out
    # PolyLaneFixedWidth.position: the control points' interpolation, then
    # the lateral offset along the pose segment's normal
    p = _poly_row(geo, li)
    x, y = _poly_interp(geo.poly, p, s)
    nrm = _poly_segment_normal(geo.poly, p, s)
    p_pol = torch.stack([x - nrm[..., 1] * lat, y + nrm[..., 0] * lat], dim=-1)
    return torch.where((kind == POLY)[..., None], p_pol, out)


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
    out = torch.where(
        kind == CIRCULAR, h_cir, torch.where(kind == SINE, h_sin, geo.heading0[li])
    )
    if geo.poly is None:
        return out
    nrm = _poly_segment_normal(geo.poly, _poly_row(geo, li), s)
    return torch.where(kind == POLY, torch.atan2(nrm[..., 1], nrm[..., 0]), out)


def width_at(geo: LaneGeometry, lane, s):
    """Lane width at ``s``: a PolyLane's sample at int(s), the lane's width
    elsewhere (reference road/lane.py ``width_at``)."""
    li = _gather(geo, lane)
    out = geo.width[li]
    if geo.poly is None:
        return out.expand(torch.broadcast_shapes(li.shape, s.shape))
    bank = geo.poly
    p, s = torch.broadcast_tensors(_poly_row(geo, li), s)
    idx = _floor_index(s, bank.n[p])
    w_pol = torch.gather(bank.width[p], -1, idx[..., None])[..., 0]
    return torch.where(geo.kind[li] == POLY, w_pol, out)


def on_lane(geo: LaneGeometry, lane, s, lat, margin: float = 0.0):
    """Reference road/lane.py ``on_lane`` with precomputed coordinates."""
    li = _gather(geo, lane)
    width = geo.width[li] if geo.poly is None else width_at(geo, lane, s)
    return (
        (lat.abs() <= width / 2 + margin)
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
    if geo.poly is not None:
        return local_coordinates(geo, all_lanes, pos[..., None, :, :])
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


# --------------------------------------------------------------------------- #
# poly lanes (JAX ``_poly_slot`` / ``_poly_interp`` / ``_poly_segment_normal``
# / ``_poly_frenet``; reference road/spline.py LinearSpline2D)
# --------------------------------------------------------------------------- #


def _poly_row(geo: LaneGeometry, li: torch.Tensor) -> torch.Tensor:
    """Bank rows of the lanes ``li`` (clipped: a lane that is not poly reads
    row 0, which its kind then discards)."""
    return geo.poly.slot[li].clamp(0, geo.poly.n.shape[0] - 1).long()


def _floor_index(s: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """int(floor(s)) clipped to [0, n - 1]: the 1 m sample ``s`` lies on."""
    return torch.minimum(torch.floor(s).to(torch.int32).clamp(min=0), n - 1).long()


def _take(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tab (..., C) at idx (...,) along its last axis."""
    return torch.gather(tab, -1, idx[..., None])[..., 0]


def _poly_interp(bank: PolyBank, p: torch.Tensor, s: torch.Tensor):
    """(x, y) at arc length ``s`` of the control points' polyline, linear
    between them and extrapolated past either end (road/spline.py
    ``numpy_interp1d``).  p: (...,) bank rows; s: (...,)."""
    p, s = torch.broadcast_tensors(p, s)
    cp_s, cp_n = bank.cp_s[p], bank.cp_n[p]  # (..., C), (...,)
    cols = torch.arange(cp_s.shape[-1], device=s.device)
    count = ((cp_s <= s[..., None]) & (cols < cp_n[..., None])).sum(-1)
    k = torch.minimum((count - 1).clamp(min=0), (cp_n - 2).clamp(min=0)).long()
    s0, s1 = _take(cp_s, k), _take(cp_s, k + 1)
    t = (s - s0) / torch.where(s1 == s0, torch.ones_like(s1), s1 - s0)
    cp_x, cp_y = bank.cp_x[p], bank.cp_y[p]
    x0, y0 = _take(cp_x, k), _take(cp_y, k)
    return x0 + t * (_take(cp_x, k + 1) - x0), y0 + t * (_take(cp_y, k + 1) - y0)


def _poly_segment_normal(bank: PolyBank, p: torch.Tensor, s: torch.Tensor):
    """Unit tangent (..., 2) of the 1 m pose segment ``s`` lies on
    (road/spline.py ``_get_segment_for_position``)."""
    p, s = torch.broadcast_tensors(p, s)
    seg = _floor_index(s, bank.n[p])
    return bank.normal[p, seg]


def _poly_frenet(geo: LaneGeometry, li: torch.Tensor, pos: torch.Tensor):
    """(s, lat, pose index) of positions on the lanes ``li``
    (road/spline.py ``cartesian_to_frenet``): the highest pose index >= 1
    with a non-negative projection on its tangent wins, pose 0 is the
    fallback."""
    bank = geo.poly
    p = _poly_row(geo, li)
    p, px, py = torch.broadcast_tensors(p, pos[..., 0], pos[..., 1])
    samples, normals = bank.pos[p], bank.normal[p]  # (..., S, 2)
    dx = px[..., None] - samples[..., 0]
    dy = py[..., None] - samples[..., 1]
    proj = normals[..., 0] * dx + normals[..., 1] * dy
    lat_all = -normals[..., 1] * dx + normals[..., 0] * dy
    idxs = torch.arange(samples.shape[-2], device=pos.device)
    valid = (idxs >= 1) & (idxs < bank.n[p][..., None]) & (proj >= 0)
    idx = torch.where(valid, idxs, torch.zeros_like(idxs)).amax(-1)
    s = idx.to(proj.dtype) + _take(proj, idx)  # the samples are 1 m apart
    return s, _take(lat_all, idx), idx


def poly_pose_index(geo: LaneGeometry, lane, pos: torch.Tensor) -> torch.Tensor:
    """The pose sample whose frame ``local_coordinates`` takes for positions
    (..., 2) on poly lanes ``lane`` (...,)."""
    return _poly_frenet(geo, _gather(geo, lane), pos)[2]
