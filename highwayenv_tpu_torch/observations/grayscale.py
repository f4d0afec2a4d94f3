"""Grayscale frame-stack observation over a batch of envs, rasterized on the device.

PyTorch counterpart of ``highwayenv_tpu/observations/grayscale.py``
(reference envs/common/observation.py ``GrayscaleObservation``).  The frame
is rasterized in the step, on the env's device, from the state: the lane
markings as the 1-px chords pygame draws for each stripe, and the vehicles
and road objects as the surface-space rectangles of the reference's
``VehicleGraphics`` (body, headlights, 1-px border, tires), then gray by
the configured weights.  The DQN frame stack is ``EnvState.obs_stack``
(B, stack, W, H) uint8, so the observation stays a function of the state.

Where the JAX package works on (V, N) and (L, N) arrays of each env's N =
H * W pixels and vmaps over envs, this module paints lane by lane and slot
by slot on (B, H, W) tensors: a frame never holds a (B, V, N) tensor.  The
slot with the highest draw priority that covers a pixel wins it (objects
before traffic, both in slot order), as the JAX package's ``argmax`` over
``prio`` picks it; the winner's gray level and coverage are kept as the
slots go by.

The float operations are the ones XLA compiles the JAX frame to, on the
CPU and the card alike, so the frames match the JAX package's pixel for
pixel on the tested scenes: a division by a constant is a product with its
float32 reciprocal, a product feeding a sum is contracted (``fma``, through
float64), cos and sin are correctly rounded (``cos_sin``).  A straight lane
along an axis (every lane of the highway) has its chords tested on one row
or column of pixel centres (``aligned_hit``): its Bresenham test reduces to
an interval, exactly.

``backend="pygame"`` is the host path of the JAX package: each frame
rendered by ``pygame_render.PygameFrameRenderer`` (pixel-exact to the
reference) and the stack kept on the observation object; the batched step
then carries a zero placeholder and the single-env ``GymEnv`` fills it in.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from highwayenv_tpu_torch.road import lane as lane_ops
from highwayenv_tpu_torch.road.lane import LaneGeometry
from highwayenv_tpu_torch.vehicle.state import (
    KIND_EGO,
    KIND_IDM,
    KIND_LANDMARK,
    KIND_OBSTACLE,
    KIND_PLAIN,
    VehicleState,
)

# the reference's palette (vehicle/graphics.py, road/graphics.py), turned to
# gray levels by the observation's weights
COLORS = {
    "grey": (100, 100, 100),
    "white": (255, 255, 255),
    "black": (60, 60, 60),
    "yellow": (200, 200, 0),
    "green": (50, 200, 0),
    "red": (255, 100, 100),
    "blue": (100, 200, 255),
}
STRIPE_SPACING = 4.33
STRIPE_LENGTH = 3.0

_INV_SPACING = 1.0 / STRIPE_SPACING


def _f64(x):
    """A float32 tensor, or a Python number as its float32 value, in float64."""
    return x.double() if torch.is_tensor(x) else float(np.float32(x))


def fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as XLA contracts a product
    and a sum (through float64, where the product of two float32 values is
    exact)."""
    return (_f64(a) * _f64(b) + _f64(c)).float()


def cos_sin(x: torch.Tensor):
    """cos and sin of float32 ``x`` correctly rounded to float32 (through
    float64), as XLA's float32 cos and sin round: the float32 libm of torch
    on the CPU and on CUDA are each an ulp off at some points, which moves a
    chord's end by a pixel."""
    xd = x.double()
    return torch.cos(xd).float(), torch.sin(xd).float()


def chord_end(geo: LaneGeometry, lane: int, kind: int, s, lat) -> torch.Tensor:
    """World position (..., 2) at ``(s, lat)`` on lane ``lane`` (a Python
    index: a view of each table, no host read under a CUDA graph's capture)
    of host kind ``kind``: ``lane_ops.position``'s form for that kind, with XLA's
    contractions and trigonometry."""
    if kind == lane_ops.CIRCULAR:
        phi = geo.cw[lane] * s / geo.radius[lane] + geo.start_phase[lane]
        c, sn = cos_sin(phi)
        rr = geo.radius[lane] - lat * geo.cw[lane]
        centre = geo.center[lane]
        return torch.stack([fma(rr, c, centre[0]), fma(rr, sn, centre[1])], dim=-1)
    if kind == lane_ops.SINE:
        _, sn = cos_sin(fma(geo.pulsation[lane], s, geo.phase[lane]))
        lat = fma(geo.amplitude[lane], sn, lat)
    start, d, n = geo.start[lane], geo.direction[lane], geo.direction_lateral[lane]
    return torch.stack([fma(lat, n[k], fma(s, d[k], start[k])) for k in (0, 1)], dim=-1)


def lighten(color):
    """Reference ``VehicleGraphics.lighten``."""
    return tuple(min(int(c / 0.68), 255) for c in color)


class GrayscaleObservation:
    """Config-compatible with the reference GrayscaleObservation:
    ``observation_shape`` (W, H), ``stack_size``, RGB ``weights``,
    ``scaling`` and ``centering_position`` (the env's by default),
    ``backend`` "rasterizer" (on the device, the default) or "pygame"."""

    host_side = False
    stateful_stack = True

    def __init__(self, env, observation_shape, stack_size: int, weights,
                 scaling: float | None = None, centering_position=None,
                 backend: str = "rasterizer", **kwargs):
        self.env = env
        self.observation_shape = tuple(observation_shape)
        self.stack_size = stack_size
        self.shape = (stack_size,) + self.observation_shape
        self.weights = np.asarray(weights, np.float64)
        self.scaling = float(scaling or env.config["scaling"])
        self.centering = list(centering_position or env.config["centering_position"])
        w = self.weights
        self.gray = {k: float(np.dot(c, w)) for k, c in COLORS.items()}
        # colour ids of the entity layer: 0 yellow, 1 blue, 2 green, 3 red,
        # 4 the env's ego_color; each with its lightened headlight gray
        base = [COLORS["yellow"], COLORS["blue"], COLORS["green"], COLORS["red"]]
        override = getattr(env, "ego_color", None)
        base.append(tuple(override) if override is not None else base[0])
        self._cid_gray = np.array([np.dot(c, w) for c in base], np.float32)
        self._cid_gray_light = np.array([np.dot(lighten(c), w) for c in base], np.float32)
        self._has_ego_override = override is not None
        # MDPVehicle egos (green, no tires) against plain and bicycle egos
        # (yellow, tires), by the action family
        self._meta_ego = type(env.action_type).__name__ in (
            "DiscreteMetaAction", "MultiAgentAction")
        if backend not in ("rasterizer", "pygame"):
            raise ValueError(f"unknown grayscale backend {backend!r}")
        self.backend = backend
        if backend == "pygame":
            self.host_side = True
            self.stateful_stack = False
            self._renderer = None
            self._host_stack = np.zeros(self.shape, np.uint8)
        #: (L, 2) side line types, on the host: they pick each lane's chords
        self._line_types = env.geo.line_types.cpu().numpy()
        self._lane_kinds = env.geo.kind.cpu().numpy()
        dirs = env.geo.direction.cpu().numpy()
        #: each lane's axis: "x" or "y" for a straight lane along one, whose
        #: chords ``aligned_hit`` tests, else ""
        aligned = (self._lane_kinds == lane_ops.STRAIGHT) & (
            np.isin(dirs, (0.0, 1.0, -1.0)).all(axis=1))
        self._lane_axis = ["" if not ok else ("x" if d[1] == 0 else "y")
                           for ok, d in zip(aligned, dirs)]
        self._consts: dict = {}

    # ------------------------------------------------------------------ #
    # the pygame host path (one env)
    # ------------------------------------------------------------------ #
    def reset_stack(self) -> None:
        self._host_stack = np.zeros(self.shape, np.uint8)

    def observe_host(self, env, state) -> np.ndarray:
        """Reference ``GrayscaleObservation.observe``: render row 0 of
        ``state`` with the pygame pipeline, gray it, roll the host stack."""
        from highwayenv_tpu_torch.pygame_render import PygameFrameRenderer

        if self._renderer is None:
            self._renderer = PygameFrameRenderer(
                env, self.observation_shape[0], self.observation_shape[1],
                scaling=self.scaling, centering=self.centering,
            )
        self._renderer.display(state)
        raw_rgb = np.moveaxis(self._renderer.get_image(), 0, 1)  # W x H x C
        frame = np.dot(raw_rgb[..., :3], self.weights).clip(0, 255).astype(np.uint8)
        self._host_stack = np.roll(self._host_stack, -1, axis=0)
        self._host_stack[-1, :, :] = frame
        return self._host_stack

    def space(self):
        from gymnasium import spaces

        return spaces.Box(shape=self.shape, low=0, high=255, dtype=np.uint8)

    # ------------------------------------------------------------------ #
    # the stack in the state
    # ------------------------------------------------------------------ #
    def init_stack(self, batch: int, device) -> torch.Tensor:
        return torch.zeros((batch,) + self.shape, dtype=torch.uint8, device=device)

    def push(self, geo: LaneGeometry, veh: VehicleState, ego: int,
             stack: torch.Tensor) -> torch.Tensor:
        """The stack rolled by one, the current frame last."""
        return torch.cat([stack[:, 1:], self.frame(geo, veh, ego)[:, None]], dim=1)

    def _const(self, device) -> dict:
        """The frame's constants on ``device``, made at its first frame there
        (before a CUDA graph captures a step, whose warm-up step runs
        eagerly): each column's and row's pixel-centre offset from the
        camera origin in metres, (W,) and (H,) float32, the pixel indices as
        floats, the colour ids' gray levels and the ego slots' mask."""
        if device not in self._consts:
            W, H = self.observation_shape
            inv = np.float32(1.0 / self.scaling)
            arrays = {
                "cw": (np.arange(W, dtype=np.float32) + np.float32(0.5)) * inv,
                "ch": (np.arange(H, dtype=np.float32) + np.float32(0.5)) * inv,
                "ix": np.arange(W, dtype=np.float32),
                "iy": np.arange(H, dtype=np.float32),
                "cid_gray": self._cid_gray,
                "cid_gray_light": self._cid_gray_light,
            }
            ego = np.zeros(self.env.num_slots, bool)
            ego[list(self.env.ego_slots)] = True
            arrays["is_ego_slot"] = ego
            self._consts[device] = {k: torch.from_numpy(a).to(device)
                                    for k, a in arrays.items()}
        return self._consts[device]

    def frame(self, geo: LaneGeometry, veh: VehicleState, ego: int) -> torch.Tensor:
        """One (B, W, H) uint8 frame an env, centred on slot ``ego``.

        The pygame pipeline's integer camera: metres to pixels by
        truncation, the lane markings' 1-px lines, the vehicles' surface
        rectangles at integer surface coordinates.  Exact for entities
        within 2 degrees of the x axis (pygame does not rotate them);
        rotated ones are the continuous inverse rotation of their surface,
        their body's edges anti-aliased."""
        W, H = self.observation_shape
        gamma = self.scaling
        const = self._const(veh.pos.device)
        cw, ch = const["cw"], const["ch"]
        x0 = veh.pos[:, ego, 0] - self.centering[0] * W / gamma  # (B,)
        y0 = veh.pos[:, ego, 1] - self.centering[1] * H / gamma
        # pixel centres in metres: columns (B, 1, W), rows (B, H, 1)
        gx = (x0[:, None] + cw)[:, None, :]
        gy = (y0[:, None] + ch)[:, :, None]
        g = self._lane_layer(geo, gx, gy, const)
        g = self._entity_layer(veh, x0, y0, const, g)
        return g.clamp(0, 255).to(torch.uint8).transpose(1, 2)

    def _lane_layer(self, geo: LaneGeometry, gx, gy, const: dict) -> torch.Tensor:
        """White lane markings on a grey ground, (B, H, W) float32.

        The reference fills the surface grey and draws each lane's side
        lines as pygame lines between the truncated pixels of a segment's
        ends: a stripe [k SPACING, k SPACING + LENGTH] of a striped line, a
        [k SPACING, (k + 1) SPACING] piece of a continuous one, the whole
        lane of a CONTINUOUS_LINE, each clipped to the lane and dropped
        when 0.5 LENGTH or less is left.  A pixel tests, by Bresenham, the
        chords of the segment its own projection on the lane falls in and
        of the neighbour segment nearer to it.  Lines wider than 1 px are
        not modelled (1 px up to a scaling of 3.3 px/m)."""
        gamma = self.scaling
        # the camera origin again from each pixel centre, as the JAX
        # package rounds it
        ox = gx - const["cw"][None, None, :]  # (B, 1, W)
        oy = gy - const["ch"][None, :, None]  # (B, H, 1)
        ixg = const["ix"][None, None, :]
        iyg = const["iy"][None, :, None]

        def chord_hit(lane, kind, a, b, lat):
            """Bresenham membership of the 1-px chord from position(a) to
            position(b) at lateral ``lat``."""
            e0 = chord_end(geo, lane, kind, a, lat)
            e1 = chord_end(geo, lane, kind, b, lat)
            # pygame's int() truncates toward zero
            p0x = torch.trunc(gamma * (e0[..., 0] - ox))
            p0y = torch.trunc(gamma * (e0[..., 1] - oy))
            p1x = torch.trunc(gamma * (e1[..., 0] - ox))
            p1y = torch.trunc(gamma * (e1[..., 1] - oy))
            dx = p1x - p0x
            dy = p1y - p0y
            tx = torch.where(dx != 0, (ixg - p0x) / dx, 0.0)
            ty = torch.where(dy != 0, (iyg - p0y) / dy, 0.0)
            yx = fma(tx, dy, p0y)  # the ideal y at this integer x
            xy = fma(ty, dx, p0x)
            inx = (ixg >= torch.minimum(p0x, p1x)) & (ixg <= torch.maximum(p0x, p1x))
            iny = (iyg >= torch.minimum(p0y, p1y)) & (iyg <= torch.maximum(p0y, p1y))
            lit_x = inx & (iyg == torch.floor(yx + 0.5))
            lit_y = iny & (ixg == torch.floor(xy + 0.5))
            return torch.where(dx.abs() >= dy.abs(), lit_x, lit_y)

        def aligned_hit(lane, along_x, a, b, lat, keep):
            """``keep`` & ``chord_hit`` of a straight lane along an axis.
            The chord's two ends share the pixel across the axis, so the
            Bresenham test is an interval along the axis at that row (or
            column), and every term but the last varies along the axis only:
            a, b and ``keep`` are (B, 1, W) along x, (B, H, 1) along y.  The
            products by 0 and +-1 are exact, so the sums round as XLA's
            contractions do."""
            start, d, n = geo.start[lane], geo.direction[lane], geo.direction_lateral[lane]
            i, j = (0, 1) if along_x else (1, 0)
            o_i, o_j = (ox, oy) if along_x else (oy, ox)
            g_i, g_j = (ixg, iyg) if along_x else (iyg, ixg)
            p0 = torch.trunc(gamma * (start[i] + a * d[i] + lat * n[i] - o_i))
            p1 = torch.trunc(gamma * (start[i] + b * d[i] + lat * n[i] - o_i))
            across = torch.trunc(gamma * (start[j] + lat * n[j] - o_j))
            inside = keep & (g_i >= torch.minimum(p0, p1)) & (g_i <= torch.maximum(p0, p1))
            return inside & (g_j == across)

        white = None
        for lane in range(self._line_types.shape[0]):
            kind = int(self._lane_kinds[lane])
            length = geo.length[lane]
            axis = self._lane_axis[lane]  # "x", "y" or "" (any other lane)
            # pixel centres: along an axis-aligned lane one row or column
            px, py = {"x": (gx, gy[:, :1]), "y": (gx[:, :, :1], gy)}.get(axis, (gx, gy))
            s_tab = None
            for side, sign in ((0, -1.0), (1, 1.0)):
                ctype = int(self._line_types[lane, side])
                if ctype == lane_ops.LINE_NONE:
                    continue
                lat = sign * geo.width[lane] / 2
                if ctype == lane_ops.LINE_CONTINUOUS_LINE:
                    # one chord over the whole lane
                    zero = torch.zeros_like(px + py)
                    segments = [(zero, zero + length, torch.ones_like(zero, dtype=torch.bool))]
                else:
                    if s_tab is None:
                        s_tab, _ = lane_ops._local_core(geo, lane, px, py)
                        k0 = torch.floor(s_tab * _INV_SPACING)
                        knear = k0 + torch.where(
                            torch.remainder(s_tab, STRIPE_SPACING) > STRIPE_SPACING / 2,
                            1.0, -1.0)
                    seg_len = (STRIPE_LENGTH if ctype == lane_ops.LINE_STRIPED
                               else STRIPE_SPACING)
                    segments = []
                    for k in (k0, knear):
                        a = (k * STRIPE_SPACING).clamp(min=0.0)
                        b = torch.minimum(fma(k, STRIPE_SPACING, seg_len), length)
                        segments.append((a, b, (b - a) > 0.5 * STRIPE_LENGTH))
                for a, b, keep in segments:
                    if axis:
                        hit = aligned_hit(lane, axis == "x", a, b, lat, keep)
                    else:
                        hit = keep & chord_hit(lane, kind, a, b, lat)
                    white = hit if white is None else white | hit
        grey = torch.full_like(gx + gy, self.gray["grey"])
        if white is None:
            return grey
        return torch.where(white, self.gray["white"], grey)

    def _entity_layer(self, veh: VehicleState, x0, y0, const: dict,
                      g: torch.Tensor) -> torch.Tensor:
        """Vehicles and road objects over ``g``, with the pygame backend's
        surface detail: body, headlights, 1-px black border, tires on plain
        vehicles and non-meta egos, coloured by the reference's
        ``get_color`` cascade; drawn objects first, then traffic, each in
        slot order, so the last-drawn slot wins a pixel."""
        gamma = self.scaling
        dev = g.device
        kind = veh.kind
        V = kind.shape[1]
        is_ego_slot = const["is_ego_slot"]
        is_obj = (kind == KIND_OBSTACLE) | (kind == KIND_LANDMARK)
        length, width = veh.length, veh.width
        side = torch.where(is_obj, length, length + 2.0)  # tire_length = 1.0

        # pygame skips the rotation below 2 degrees
        h = torch.where(veh.heading.abs() > 2.0 * math.pi / 180.0, veh.heading, 0.0)
        pos_px_x = torch.trunc(gamma * (veh.pos[..., 0] - x0[:, None]))  # blit pivot
        pos_px_y = torch.trunc(gamma * (veh.pos[..., 1] - y0[:, None]))
        c, s = cos_sin(h)
        c0 = torch.floor(gamma * side) / 2.0  # the surface's centre, px

        # the body at integer surface coordinates
        pl = torch.floor(gamma * length)
        pw = torch.floor(gamma * width)
        bx0 = torch.where(is_obj, 0.0, math.floor(gamma * 1.0))
        by0 = torch.floor(gamma * (side / 2 - width / 2))
        # headlights: two lightened rectangles at the front
        hx0 = torch.floor(gamma * (1.0 + length - 0.72))
        hw = math.floor(gamma * 0.72)
        hh = math.floor(gamma * 0.6)
        hy1 = torch.floor(gamma * (side / 2 - 1.4 * width * (1.0 / 3.0)))
        hy2 = torch.floor(gamma * (side / 2 + 0.6 * width * (1.0 / 5.0)))
        # tires: four black rectangles over the body's corners, on plain
        # vehicles and non-meta egos; none below a scaling of ~3.3 px/m
        tire_slot = (kind == KIND_PLAIN) | (is_ego_slot & (not self._meta_ego))
        ptl = math.floor(gamma * 1.0)
        toff = math.floor((ptl + 1.0) / 2.0)  # the blit origin's truncation
        ty0 = math.floor(gamma * 0.35)
        th = math.floor(gamma * 0.3)
        tires = th >= 1
        if tires:
            # the four tires' origins: two columns (rear, front) by two rows
            # (either side), so their union is the product of the unions
            tire_x = [torch.floor(gamma * tx) - toff for tx in (torch.full_like(side, 1.0),
                                                                side - 1.0)]
            tire_y = [torch.floor(gamma * ty) - toff + ty0
                      for ty in (side / 2 - width / 2, side / 2 + width / 2)]

        # the get_color cascade as a colour id
        cid = torch.where(
            kind == KIND_LANDMARK, torch.where(veh.hit, 2, 1),
            torch.where(
                is_obj, torch.where(veh.crashed, 3, 0),
                torch.where(
                    veh.crashed, 3,
                    torch.where(kind == KIND_IDM, 1,
                                torch.where((kind == KIND_EGO) & is_ego_slot & self._meta_ego,
                                            2, 0)))))
        if self._has_ego_override:
            # an explicit ego_color beats even crashed
            cid = torch.where(is_ego_slot, 4, cid)
        body_gray = const["cid_gray"][cid]
        hl_gray = const["cid_gray_light"][cid]
        black = self.gray["black"]
        prio = (torch.arange(V, device=dev) + torch.where(is_obj, 0, V)).to(torch.int32)

        # the winner so far: its priority (-1: none), gray level, coverage
        best = torch.full(g.shape, -1, dtype=torch.int32, device=dev)
        g_win = torch.zeros_like(g)
        a_win = torch.zeros_like(g)
        dxg = const["ix"][None, None, :] + 0.5  # (1, 1, W)
        dyg = const["iy"][None, :, None] + 0.5  # (1, H, 1)

        def col(t, v):
            """Slot v's (B,) values shaped to broadcast over (B, H, W)."""
            return t[:, v, None, None]

        for v in range(V):
            dx = dxg - col(pos_px_x, v)  # (B, 1, W)
            dy = dyg - col(pos_px_y, v)  # (B, H, 1)
            cv, sv, c0v = col(c, v), col(s, v), col(c0, v)
            # the inverse rotation, contracted as XLA contracts it
            ux = fma(sv, dy, fma(cv, dx, c0v))  # (B, H, W)
            uy = fma(cv, dy, fma(-sv, dx, c0v))

            def span(u, lo, size):
                return (u >= lo) & (u < lo + size)

            bx, by, bl, bw = col(bx0, v), col(by0, v), col(pl, v), col(pw, v)
            # the body from the signed distances to its four sides (a float
            # difference has the sign of the comparison), their minimum the
            # distance to its boundary in surface px
            near = torch.minimum(ux - bx, uy - by)
            far = torch.minimum((bx + bl) - ux, (by + bw) - uy)
            d_body = torch.minimum(near, far)
            body = (near >= 0.0) & (far > 0.0)
            border = body & ~(span(ux, bx + 1, bl - 2) & span(uy, by + 1, bw - 2))
            headlight = col(~is_obj, v) & span(ux, col(hx0, v), hw) & (
                span(uy, col(hy1, v), hh) | span(uy, col(hy2, v), hh))
            if tires:
                tire = col(tire_slot, v) & (
                    span(ux, col(tire_x[0], v), ptl) | span(ux, col(tire_x[1], v), ptl)) & (
                    span(uy, col(tire_y[0], v), th) | span(uy, col(tire_y[1], v), th))
            else:
                tire = torch.zeros_like(body)
            gv = torch.where(tire | border, black,
                             torch.where(headlight, col(hl_gray, v), col(body_gray, v)))
            # rotated entities: the body's edges anti-aliased, where
            # pygame's nearest-neighbour rotated blit leaves ragged edges
            rot = col(h != 0.0, v)
            alpha = torch.where(rot & ~tire, (d_body + 0.5).clamp(0.0, 1.0),
                                (body | tire).to(g.dtype))
            covered = ((body | tire) | (rot & (alpha > 0.0))) & col(veh.active, v)
            win = covered & (col(prio, v) > best)
            best = torch.where(win, col(prio, v), best)
            g_win = torch.where(win, gv, g_win)
            a_win = torch.where(win, alpha, a_win)
        return torch.where(best >= 0, fma(a_win, g_win, (1 - a_win) * g), g)
