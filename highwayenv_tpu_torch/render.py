"""A numpy rasterizer of one env's scene for ``rgb_array`` rendering.

PyTorch counterpart of ``highwayenv_tpu/render.py``: a pygame-free
re-creation of the reference viewer's look (envs/common/graphics.py,
road/graphics.py, vehicle/graphics.py): the camera at the configured
scaling and centering on the first controlled vehicle, a grey background,
the lanes' side lines (continuous or 3 m stripes every 4.33 m) sampled from
the host lane objects of ``env.net``, and every object as a filled rotated
rectangle coloured by its state (ego green, crashed red, traffic yellow,
obstacles grey-red, landmarks blue).

Host code, off the step: ``render_rgb`` copies row 0 of a batched state, on
whatever device it lives, to numpy and draws from that copy.  Pixel-exact
parity with pygame is not its aim (``pygame_render.py`` is that).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from highwayenv_tpu_torch.vehicle.state import KIND_LANDMARK, KIND_OBSTACLE

# colours (reference vehicle/graphics.py, road/graphics.py)
GREY = (100, 100, 100)
WHITE = (255, 255, 255)
YELLOW = (200, 200, 0)
GREEN = (50, 200, 0)
RED = (255, 100, 100)
BLUE = (100, 200, 255)
BLACK = (60, 60, 60)

STRIPE_SPACING = 4.33
STRIPE_LENGTH = 3.0


def row0(veh) -> dict:
    """Row 0 of a batched ``VehicleState`` as numpy arrays by field name,
    with ``active``."""
    out = {f.name: getattr(veh, f.name)[0].cpu().numpy() for f in dataclasses.fields(veh)}
    out["active"] = veh.active[0].cpu().numpy()
    return out


class Camera:
    def __init__(self, width, height, scaling, center, centering):
        self.w, self.h = int(width), int(height)
        self.scaling = float(scaling)
        cx, cy = center
        self.x0 = cx - centering[0] * self.w / self.scaling
        self.y0 = cy - centering[1] * self.h / self.scaling

    def to_px(self, pos):
        pos = np.asarray(pos, np.float64)
        px = (pos[..., 0] - self.x0) * self.scaling
        py = (pos[..., 1] - self.y0) * self.scaling
        return px, py


def _draw_points(img, px, py, color):
    xi = np.round(px).astype(int)
    yi = np.round(py).astype(int)
    ok = (0 <= xi) & (xi < img.shape[1]) & (0 <= yi) & (yi < img.shape[0])
    img[yi[ok], xi[ok]] = color


def _draw_polyline(img, cam, pts, color, step_px=1.0):
    """A world-space polyline, sampled densely."""
    pts = np.asarray(pts, np.float64)
    if len(pts) < 2:
        return
    seg = np.diff(pts, axis=0)
    lens = np.linalg.norm(seg, axis=-1)
    for p0, d, ln in zip(pts[:-1], seg, lens):
        n = max(2, int(ln * cam.scaling / step_px) + 1)
        t = np.linspace(0.0, 1.0, n)[:, None]
        px, py = cam.to_px(p0 + t * d)
        _draw_points(img, px, py, color)


def _fill_rect(img, cam, center, length, width, heading, color):
    """A filled rotated rectangle, by a membership test over its bounding
    box."""
    c, s = np.cos(heading), np.sin(heading)
    corners = np.array(
        [[dx * length / 2, dy * width / 2] for dx, dy in
         ((-1, -1), (-1, 1), (1, 1), (1, -1))]
    )
    world = center + corners @ np.array([[c, s], [-s, c]])
    px, py = cam.to_px(world)
    x_min = max(int(np.floor(px.min())), 0)
    y_min = max(int(np.floor(py.min())), 0)
    x_max = min(int(np.ceil(px.max())), img.shape[1] - 1)
    y_max = min(int(np.ceil(py.max())), img.shape[0] - 1)
    if x_min > x_max or y_min > y_max:
        return
    gx, gy = np.meshgrid(np.arange(x_min, x_max + 1), np.arange(y_min, y_max + 1))
    wx = gx / cam.scaling + cam.x0 - center[0]
    wy = gy / cam.scaling + cam.y0 - center[1]
    rx = c * wx + s * wy
    ry = -s * wx + c * wy
    inside = (np.abs(rx) <= length / 2) & (np.abs(ry) <= width / 2)
    img[gy[inside], gx[inside]] = color


def _positions_at(lane, s, lat):
    """The host lane's positions at an array of arc lengths, (n, 2)."""
    n = len(s)
    pts = np.asarray(lane.position(s[:, None], float(lat)), float)
    if pts.shape == (n, 1, 2):  # lanes that broadcast on the last axis
        return pts[:, 0, :]
    return pts


def _draw_lane_line(img, cam, lane, lat, s0, s1, color, dashed=False):
    """A lane-parallel line in one pass: arc lengths about 1 px apart
    (masked to the 3 m / 4.33 m stripes, phase-locked to s = 0, where
    dashed), one host ``lane.position`` call, one scatter of pixels."""
    if s1 <= s0:
        return
    step = max(1.0 / cam.scaling, 1e-3)  # ~1 px along the arc, in metres
    s = np.arange(s0, s1, step)
    if dashed:
        s = s[np.mod(s, STRIPE_SPACING) < STRIPE_LENGTH]
    if len(s) == 0:
        return
    px, py = cam.to_px(_positions_at(lane, s, lat))
    _draw_points(img, px, py, color)


def _visible_s_window(lane, cam_center, cam):
    """The arc-length window of a lane the camera sees, with a margin."""
    s_c, _ = (float(x) for x in lane.local_coordinates(np.asarray(cam_center)))
    half = (cam.w + cam.h) / cam.scaling  # a generous half-diagonal, metres
    return max(0.0, s_c - half), min(float(lane.length), s_c + half)


def render_rgb(env, state, history=None) -> np.ndarray:
    """(H, W, 3) uint8 frame of row 0 of ``state``, centred on the first
    controlled vehicle.

    ``history``: per slot, a deque of past (pos, heading, length, width)
    poses (the stateful viewer keeps it), drawn as faded trajectory ghosts
    under ``config["show_trajectories"]``."""
    cfg = env.config
    veh = row0(state.vehicles)
    pos = veh["pos"]
    ego = env.ego_slots[0]
    cam = Camera(cfg["screen_width"], cfg["screen_height"], cfg["scaling"], pos[ego],
                 cfg.get("centering_position", [0.3, 0.5]))
    img = np.empty((cam.h, cam.w, 3), np.uint8)
    img[:] = GREY

    # lanes: a darker band and the side lines, over the visible window
    line_types = env.geo.line_types.cpu().numpy()
    lanes = [lane for ls in env.net.edges.values() for lane in ls]
    for li, lane in enumerate(lanes):
        half = lane.width / 2
        s0, s1 = _visible_s_window(lane, pos[ego], cam)
        if s1 <= s0:
            continue
        _draw_lane_line(img, cam, lane, 0.0, s0, s1, BLACK)
        for side, lat in ((0, -half), (1, half)):
            lt = int(line_types[li, side])
            if lt == 0:
                continue
            # striped (1): 3 m dashes every 4.33 m; else continuous
            _draw_lane_line(img, cam, lane, lat, s0, s1, WHITE, dashed=(lt == 1))

    # trajectory ghosts at every 5th past pose
    if history and cfg.get("show_trajectories"):
        for i, snaps in history.items():
            for hp, hh, hl, hw in list(snaps)[::5]:
                fade = 0.25
                base = np.array(YELLOW if i not in env.ego_slots else GREEN)
                ghost = tuple((fade * base + (1 - fade) * np.array(GREY)).astype(int))
                _fill_rect(img, cam, hp, hl, hw, hh, ghost)

    # the lidar's rays, each cut at its measured distance
    if type(env.observation_type).__name__ == "LidarObservation":
        ot = env.observation_type
        one = type(state.vehicles)(**{
            f.name: getattr(state.vehicles, f.name)[:1]
            for f in dataclasses.fields(state.vehicles)})
        grid = ot.observe(env.geo, one, ego)[0].cpu().numpy()
        dist = grid[:, 0] * (ot.maximum_range if getattr(ot, "normalize", True) else 1.0)
        angles = np.arange(grid.shape[0]) * ot.angle
        for a, d in zip(angles, dist):
            end = pos[ego] + d * np.array([np.cos(a), np.sin(a)])
            _draw_polyline(img, cam, np.stack([pos[ego], end]), (200, 200, 200))

    # objects and vehicles: objects first, egos last
    kind = veh["kind"]
    for i in np.argsort(kind)[::-1]:
        if not veh["active"][i]:
            continue
        if kind[i] == KIND_LANDMARK:
            color = BLUE
        elif kind[i] == KIND_OBSTACLE:
            color = RED if veh["crashed"][i] else (150, 120, 120)
        elif veh["crashed"][i]:
            color = RED
        elif i in env.ego_slots:
            color = GREEN
        else:
            color = YELLOW
        _fill_rect(img, cam, pos[i], float(veh["length"][i]), float(veh["width"][i]),
                   float(veh["heading"][i]), color)
    return img
