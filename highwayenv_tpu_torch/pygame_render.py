"""A pixel-exact pygame frame renderer of one env's scene (host code).

PyTorch counterpart of ``highwayenv_tpu/pygame_render.py``: the reference
viewer's draw pipeline replayed on the port's state, so that a frame (and a
GrayscaleObservation of ``backend="pygame"``) is byte-identical to the
reference's for the same scene: the same pygame primitives in the same
order with the same integer camera math.

The stages (reference files):
  - camera, metres to integer pixels: road/graphics.py (WorldSurface);
  - lane lines, the stripes' phase anchored at the window's origin:
    road/graphics.py (LaneGraphics);
  - road objects (obstacle and landmark squares): road/graphics.py;
  - vehicles (body, headlights, border, tires; a rotated blit):
    vehicle/graphics.py (VehicleGraphics, blit_rotate);
  - the frame and its RGB array: envs/common/graphics.py (EnvViewer.display,
    get_image).

Off the step: ``display(state)`` copies row 0 of a batched state to numpy.
``pygame`` is imported when a renderer is made, never by
``import highwayenv_tpu_torch``.
"""

from __future__ import annotations

import numpy as np

from highwayenv_tpu_torch.render import row0
from highwayenv_tpu_torch.road.network import LineType
from highwayenv_tpu_torch.vehicle.state import (
    KIND_EGO,
    KIND_IDM,
    KIND_LANDMARK,
    KIND_LINEAR,
    KIND_OBSTACLE,
    KIND_PAD,
    KIND_PLAIN,
)

BLACK = (60, 60, 60)
GREY = (100, 100, 100)
GREEN = (50, 200, 0)
YELLOW = (200, 200, 0)
WHITE = (255, 255, 255)
RED = (255, 100, 100)
BLUE = (100, 200, 255)

STRIPE_SPACING = 4.33
STRIPE_LENGTH = 3.0
STRIPE_WIDTH = 0.3


class Camera:
    """WorldSurface's coordinate math over a plain pygame surface
    (road/graphics.py:42-95): int-truncating meters->pixels, origin set so
    the window centers on the observer at the configured centering."""

    def __init__(self, surface, scaling, centering):
        self.surface = surface
        self.scaling = float(scaling)
        self.centering = list(centering)
        self.origin = np.array([0.0, 0.0])

    def pix(self, length):
        return int(length * self.scaling)

    def pos2pix(self, x, y):
        return self.pix(x - self.origin[0]), self.pix(y - self.origin[1])

    def vec2pix(self, vec):
        return self.pos2pix(vec[0], vec[1])

    def is_visible(self, vec, margin=50):
        x, y = self.vec2pix(vec)
        w, h = self.surface.get_size()
        return -margin < x < w + margin and -margin < y < h + margin

    def move_to(self, position):
        w, h = self.surface.get_size()
        self.origin = np.asarray(position, np.float64) - np.array(
            [
                self.centering[0] * w / self.scaling,
                self.centering[1] * h / self.scaling,
            ]
        )


# --------------------------------------------------------------------------- #
# lanes
# --------------------------------------------------------------------------- #
def _draw_stripes(pygame, cam, lane, starts, ends, lats):
    """One pygame line per stripe, skipping fully-clipped ones
    (road/graphics.py:229-260)."""
    starts = np.clip(np.asarray(starts, np.float64), 0, lane.length)
    ends = np.clip(np.asarray(ends, np.float64), 0, lane.length)
    width_px = max(cam.pix(STRIPE_WIDTH), 1)
    for k in range(len(starts)):
        if abs(starts[k] - ends[k]) > 0.5 * STRIPE_LENGTH:
            pygame.draw.line(
                cam.surface,
                WHITE,
                cam.vec2pix(lane.position(starts[k], lats[k])),
                cam.vec2pix(lane.position(ends[k], lats[k])),
                width_px,
            )


def draw_lane(pygame, cam, lane):
    """Side lines of one lane, stripe phase anchored at the camera origin
    (road/graphics.py:128-228)."""
    w, h = cam.surface.get_size()
    stripes_count = int(2 * (h + w) / (STRIPE_SPACING * cam.scaling))
    s_origin, _ = lane.local_coordinates(cam.origin)
    s0 = (int(s_origin) // STRIPE_SPACING - stripes_count // 2) * STRIPE_SPACING
    for side in range(2):
        lt = lane.line_types[side]
        if lt == LineType.STRIPED:
            starts = s0 + np.arange(stripes_count) * STRIPE_SPACING
            ends = starts + STRIPE_LENGTH
        elif lt == LineType.CONTINUOUS:
            starts = s0 + np.arange(stripes_count) * STRIPE_SPACING
            ends = starts + STRIPE_SPACING
        elif lt == LineType.CONTINUOUS_LINE:
            starts = np.array([s0])
            ends = np.array([s0 + stripes_count * STRIPE_SPACING + STRIPE_LENGTH])
        else:
            continue
        lats = [(side - 0.5) * float(lane.width) for _ in starts]
        _draw_stripes(pygame, cam, lane, starts, ends, lats)


# --------------------------------------------------------------------------- #
# rotated blits
# --------------------------------------------------------------------------- #
def blit_rotate(pygame, surf, image, pos, angle_deg, origin_pos=None):
    """Rotate ``image`` by ``angle_deg`` about its center point placed at
    ``pos`` and blit onto ``surf`` (vehicle/graphics.py:149-190; the
    pivot-compensation construction from stackoverflow.com/a/54714144)."""
    V2 = pygame.math.Vector2
    w, h = image.get_size()
    box = [V2(p).rotate(angle_deg) for p in [(0, 0), (w, 0), (w, -h), (0, -h)]]
    min_x = min(p[0] for p in box)
    min_y = min(p[1] for p in box)
    max_y = max(p[1] for p in box)
    if origin_pos is None:
        origin_pos = (w / 2, h / 2)
    pivot = V2(origin_pos[0], -origin_pos[1])
    pivot_move = pivot.rotate(angle_deg) - pivot
    origin = (
        pos[0] - origin_pos[0] + min_x - pivot_move[0],
        pos[1] - origin_pos[1] - max_y + pivot_move[1],
    )
    surf.blit(pygame.transform.rotate(image, angle_deg), origin)


def _vehicle_color(kind, crashed, is_meta_ego, hit=False):
    """get_color's isinstance cascade by engine kind code
    (vehicle/graphics.py:234-250, road/graphics.py:439-459)."""
    if kind == KIND_OBSTACLE:
        return RED if crashed else YELLOW
    if kind == KIND_LANDMARK:
        return GREEN if hit else BLUE
    if crashed:
        return RED
    if kind == KIND_LINEAR:
        return YELLOW
    if kind == KIND_IDM:
        return BLUE
    if kind == KIND_EGO and is_meta_ego:
        return GREEN  # MDPVehicle ego under DiscreteMetaAction
    return YELLOW  # plain Vehicle / continuous-action ego: DEFAULT_COLOR


def _lighten(color):
    return tuple(min(int(c / 0.68), 255) for c in color[:3]) + color[3:]


def draw_vehicle(
    pygame, cam, pos, heading, length, width, color, tires, steering
):
    """One vehicle: body rect + headlights + 1px border (+ tires for plain
    Vehicle / BicycleVehicle kinds), rotated about its center
    (vehicle/graphics.py:31-141)."""
    if not cam.is_visible(pos):
        return
    tire_length, tire_width = 1.0, 0.3
    headlight_length, headlight_width = 0.72, 0.6
    side = length + 2 * tire_length
    vs = pygame.Surface((cam.pix(side), cam.pix(side)), pygame.SRCALPHA)
    rect = (
        cam.pix(tire_length),
        cam.pix(side / 2 - width / 2),
        cam.pix(length),
        cam.pix(width),
    )
    pygame.draw.rect(vs, color, rect, 0)
    for ly in (side / 2 - (1.4 * width) / 3, side / 2 + (0.6 * width) / 5):
        pygame.draw.rect(
            vs,
            _lighten(color),
            (
                cam.pix(tire_length + length - headlight_length),
                cam.pix(ly),
                cam.pix(headlight_length),
                cam.pix(headlight_width),
            ),
            0,
        )
    pygame.draw.rect(vs, BLACK, rect, 1)
    if tires:
        for tx, ty, ta in (
            (tire_length, side / 2 - width / 2, 0.0),
            (tire_length, side / 2 + width / 2, 0.0),
            (side - tire_length, side / 2 - width / 2, steering),
            (side - tire_length, side / 2 + width / 2, steering),
        ):
            ts = pygame.Surface(
                (cam.pix(tire_length), cam.pix(tire_length)), pygame.SRCALPHA
            )
            pygame.draw.rect(
                ts,
                BLACK,
                (
                    0,
                    cam.pix(tire_length / 2 - tire_width / 2),
                    cam.pix(tire_length),
                    cam.pix(tire_width),
                ),
                0,
            )
            blit_rotate(
                pygame, vs, ts, (cam.pix(tx), cam.pix(ty)), np.rad2deg(-ta)
            )
    h = heading if abs(heading) > 2 * np.pi / 180 else 0.0
    blit_rotate(
        pygame, cam.surface, vs, list(cam.pos2pix(pos[0], pos[1])),
        np.rad2deg(-h),
    )


def draw_object(pygame, cam, pos, heading, length, width, color):
    """Obstacle/landmark square surface (road/graphics.py:357-395)."""
    s = pygame.Surface((cam.pix(length), cam.pix(length)), pygame.SRCALPHA)
    rect = (0, cam.pix(length / 2 - width / 2), cam.pix(length), cam.pix(width))
    pygame.draw.rect(s, color, rect, 0)
    pygame.draw.rect(s, BLACK, rect, 1)
    h = heading if abs(heading) > 2 * np.pi / 180 else 0.0
    blit_rotate(
        pygame, cam.surface, s, cam.pos2pix(pos[0], pos[1]), np.rad2deg(-h)
    )


# --------------------------------------------------------------------------- #
# frame renderer
# --------------------------------------------------------------------------- #
class PygameFrameRenderer:
    """Offscreen surface + camera bound to an env; ``display(state)`` redraws
    the frame, ``get_image()`` extracts H x W x C uint8 (the reference's
    EnvViewer.display/get_image contract, envs/common/graphics.py:120-180)."""

    def __init__(self, env, width, height, scaling=None, centering=None):
        import pygame

        self._pygame = pygame
        pygame.display.init()
        self.env = env
        self.surface = pygame.Surface((int(width), int(height)))
        self.cam = Camera(
            self.surface,
            scaling if scaling is not None else env.config["scaling"],
            centering
            if centering is not None
            else env.config.get("centering_position", [0.3, 0.5]),
        )
        # MDPVehicle egos (green, no tires) vs plain/bicycle egos
        # (yellow, tires): decided by the action family, matching the
        # reference's vehicle_class choice (envs/common/action.py)
        name = type(env.action_type).__name__
        self._meta_ego = name in ("DiscreteMetaAction", "MultiAgentAction")
        self._lanes = [lane for ls in env.net.edges.values() for lane in ls]

    def display(self, state, observer_slot=None):
        """Redraw the frame of row 0 of the batched ``state``."""
        pygame = self._pygame
        veh = row0(state.vehicles)
        pos = np.asarray(veh["pos"], np.float64)
        obs_slot = (
            observer_slot if observer_slot is not None else self.env.ego_slots[0]
        )
        self.cam.move_to(pos[obs_slot])

        # RoadGraphics.display: background + every lane's side lines
        self.surface.fill(GREY)
        for lane in self._lanes:
            draw_lane(pygame, self.cam, lane)

        kind = veh["kind"]
        heading = np.asarray(veh["heading"], np.float64)
        length = np.asarray(veh["length"], np.float64)
        width = np.asarray(veh["width"], np.float64)
        crashed = veh["crashed"]
        hit = veh["hit"]
        steering = np.asarray(veh["steering"], np.float64)
        ego_set = set(int(s) for s in self.env.ego_slots)

        # display_road_objects BEFORE display_traffic (graphics.py:133-151)
        for i in range(self.env.num_slots):
            if kind[i] in (KIND_OBSTACLE, KIND_LANDMARK):
                draw_object(
                    pygame,
                    self.cam,
                    pos[i],
                    float(heading[i]),
                    float(length[i]),
                    float(width[i]),
                    _vehicle_color(
                        int(kind[i]), bool(crashed[i]), False, bool(hit[i])
                    ),
                )
        for i in range(self.env.num_slots):
            k = int(kind[i])
            if k in (KIND_PAD, KIND_OBSTACLE, KIND_LANDMARK):
                continue
            is_ego = i in ego_set
            tires = k == KIND_PLAIN or (is_ego and not self._meta_ego)
            # explicit per-env ego color attribute is the FIRST branch of
            # get_color's cascade — it beats even crashed
            # (vehicle/graphics.py:235-236)
            override = getattr(self.env, "ego_color", None)
            if is_ego and override is not None:
                color = tuple(override)
            else:
                color = _vehicle_color(
                    k, bool(crashed[i]), self._meta_ego and is_ego
                )
            draw_vehicle(
                pygame,
                self.cam,
                pos[i],
                float(heading[i]),
                float(length[i]),
                float(width[i]),
                color,
                tires,
                float(steering[i]),
            )

    def get_image(self) -> np.ndarray:
        """H x W x C rgb array (graphics.py:168-180)."""
        data = self._pygame.surfarray.array3d(self.surface)  # W x H x C
        return np.moveaxis(data, 0, 1)

    def close(self):
        pass
