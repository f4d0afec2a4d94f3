"""Interval observers and route-hypothesis tracking: the robust-control tools.

PyTorch counterpart of ``highwayenv_tpu/ops/uncertainty.py`` (reference
highway_env/vehicle/uncertainty/prediction.py IntervalVehicle and
estimation.py RegressionVehicle / MultipleModelVehicle): [min, max] bounds on
a LinearVehicle's position, speed and heading under box uncertainty on its
acceleration and steering parameters, the worst-case collision test against
such a box, and a tracker of a vehicle's route hypotheses.

- The host tools (``IntervalObserver`` and its modes "observer", "partial"
  and "predictor", ``worst_case_collision``, the route and feature tools,
  ``MultipleModelTracker``) run in float64 numpy between steps, as the JAX
  package's do.  They read one row of a batched (B, V) state: each takes a
  ``row`` (default 0) and copies that row's fields to the host once per call
  (``host_row``), so a CUDA state costs one transfer a field, not one a
  value.  Their lane ops run in float32 on the tables' device, as the JAX
  package's float32 lane ops do.
- ``observer_step_batch`` steps a fleet of observers as batched torch on
  the device of the tensors it is given.

One difference from the JAX package: ``neighbour_slots`` skips landmarks
(``KIND_LANDMARK``), as the reference's ``Road.neighbour_vehicles`` does;
the JAX package tests kind 7, which no slot has, so it counts them.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import torch

from highwayenv_tpu_torch.ops.interval import (
    LPV,
    box_absolute_to_local,
    box_integrator,
    box_section,
    integrator_interval,
    interval_absolute_to_local,
    interval_local_to_absolute,
    interval_negative_part,
    intervals_diff,
    intervals_product,
    polytope,
    vector_interval_section,
)
from highwayenv_tpu_torch.road import lane as lane_ops
from highwayenv_tpu_torch.utils.estimation import confidence_polytope, is_consistent_dataset
from highwayenv_tpu_torch.utils.math import rects_intersecting, wrap_to_pi
from highwayenv_tpu_torch.vehicle.state import KIND_LANDMARK, KIND_PAD

F32 = torch.float32

# LinearVehicle's class constants (reference vehicle/behavior.py)
ACCELERATION_PARAMETERS = np.array([0.3, 0.3, 2.0])
STEERING_PARAMETERS = np.array([5.0, 5.0 / 0.6])
ACCELERATION_RANGE = np.array([0.5 * ACCELERATION_PARAMETERS, 1.5 * ACCELERATION_PARAMETERS])
STEERING_RANGE = np.array([STEERING_PARAMETERS - np.array([0.07, 1.5]),
                           STEERING_PARAMETERS + np.array([0.07, 1.5])])
DISTANCE_WANTED = 10.0
TIME_WANTED = 2.5
ACC_MAX = 6.0
TAU_PURSUIT = 0.1
NOISE_PARTIAL = 0.3
VEHICLE_LENGTH = 5.0

#: the fields the host tools read from a state's row
ROW_FIELDS = ("pos", "speed", "heading", "kind", "lane", "target_lane", "target_speed",
              "route_base", "route_id", "route_ptr", "route_len")


def host_row(state, row: int = 0) -> SimpleNamespace:
    """Row ``row`` of a batched state's ``ROW_FIELDS`` as host numpy
    arrays, one device-to-host copy a field."""
    veh = state.vehicles
    return SimpleNamespace(**{f: getattr(veh, f)[row].cpu().numpy() for f in ROW_FIELDS})


@dataclass
class VehicleInterval:
    """Interval of a vehicle's state (reference prediction.py)."""

    position: np.ndarray  # (2, 2): [min, max] of (x, y)
    speed: np.ndarray  # (2,)
    heading: np.ndarray  # (2,)

    @classmethod
    def degenerate(cls, position, speed, heading):
        return cls(position=np.array([position, position], float),
                   speed=np.array([speed, speed], float),
                   heading=np.array([heading, heading], float))


@dataclass
class IntervalObserver:
    """Interval observer of one vehicle on the lane tables ``geo``."""

    geo: object  # LaneGeometry
    target_lane: int
    target_speed: float
    theta_a_i: np.ndarray = field(default_factory=lambda: ACCELERATION_RANGE)
    theta_b_i: np.ndarray = field(default_factory=lambda: STEERING_RANGE)
    interval: VehicleInterval | None = None
    longitudinal_lpv: LPV | None = None
    lateral_lpv: LPV | None = None

    def _lane_heading_at_position(self, position) -> float:
        """The target lane's heading at a position, by float32 lane ops."""
        dev = self.geo.kind.device
        lane = torch.tensor(self.target_lane, dtype=torch.int32, device=dev)
        pos = torch.as_tensor(np.asarray(position, float), device=dev).to(F32)
        s, _ = lane_ops.local_coordinates(self.geo, lane, pos)
        return float(lane_ops.heading_at(self.geo, lane, s))

    def observer_step(self, dt: float, position, speed: float,
                      front: VehicleInterval | None = None) -> None:
        """One step of the nonlinear interval observer, in place on
        ``self.interval`` (reference ``IntervalVehicle.observer_step``)."""
        o = self.interval
        position_i = o.position
        v_i = o.speed
        psi_i = o.heading

        phi_a_i = np.zeros((2, 3))
        lane_psi = self._lane_heading_at_position(position)
        if front is not None:
            phi_a_i[:, 1] = interval_negative_part(intervals_diff(front.speed, v_i))
            lane_direction = [np.cos(lane_psi), np.sin(lane_psi)]
            diff_i = intervals_diff(front.position, position_i)
            d_i = vector_interval_section(diff_i, lane_direction)
            d_safe_i = DISTANCE_WANTED + TIME_WANTED * v_i
            phi_a_i[:, 2] = interval_negative_part(intervals_diff(d_i, d_safe_i))

        # the steering features on the followed (target) lane
        _, lateral_i = interval_absolute_to_local(position_i, self.geo, self.target_lane)
        lateral_i = -np.flip(lateral_i)
        i_v_i = 1 / np.flip(v_i, 0)
        phi_b_i = np.transpose(np.array([[0, 0], intervals_product(lateral_i, i_v_i)]))

        a_i = intervals_product(self.theta_a_i, phi_a_i)
        b_i = intervals_product(self.theta_b_i, phi_b_i)

        dv_i = intervals_product(self.theta_a_i[:, 0], self.target_speed - np.flip(v_i, 0))
        dv_i += a_i
        dv_i = np.clip(dv_i, -ACC_MAX, ACC_MAX)

        delta_psi = [float(((x - lane_psi) + np.pi) % (2 * np.pi) - np.pi) for x in psi_i]
        d_psi_i = integrator_interval(delta_psi, self.theta_b_i[:, 0])  # float32
        d_psi_i += b_i

        cos_i = [
            -1 if psi_i[0] <= np.pi <= psi_i[1] else min(map(np.cos, psi_i)),
            1 if psi_i[0] <= 0 <= psi_i[1] else max(map(np.cos, psi_i)),
        ]
        sin_i = [
            -1 if psi_i[0] <= -np.pi / 2 <= psi_i[1] else min(map(np.sin, psi_i)),
            1 if psi_i[0] <= np.pi / 2 <= psi_i[1] else max(map(np.sin, psi_i)),
        ]
        dx_i = intervals_product(v_i, cos_i)
        dy_i = intervals_product(v_i, sin_i)

        o.speed = o.speed + dv_i * dt
        o.heading = o.heading + d_psi_i * dt
        o.position[:, 0] += dx_i * dt + NOISE_PARTIAL * dt * np.array([-1, 1])
        o.position[:, 1] += dy_i * dt + NOISE_PARTIAL * dt * np.array([-1, 1])
        o.heading = o.heading + NOISE_PARTIAL * dt * np.array([-1, 1])

    def partial_step(self, dt: float, position, speed: float,
                     front: VehicleInterval | None = None, alpha: float = 0.0) -> None:
        """Split the interval, step each part, merge (reference
        ``IntervalVehicle.partial_observer_step``)."""
        o = self.interval
        minus = copy.deepcopy(self)
        minus.interval = copy.deepcopy(o)
        minus.interval.position[1, :] = (1 - alpha) * o.position[0, :] + alpha * o.position[1, :]
        minus.interval.speed[1] = (1 - alpha) * o.speed[0] + alpha * o.speed[1]
        minus.interval.heading[1] = (1 - alpha) * o.heading[0] + alpha * o.heading[1]
        plus = copy.deepcopy(self)
        plus.interval = copy.deepcopy(o)
        plus.interval.position[0, :] = alpha * o.position[0, :] + (1 - alpha) * o.position[1, :]
        plus.interval.speed[0] = alpha * o.speed[0] + (1 - alpha) * o.speed[1]
        plus.interval.heading[0] = alpha * o.heading[0] + (1 - alpha) * o.heading[1]
        minus.observer_step(dt, position, speed, front)
        plus.observer_step(dt, position, speed, front)
        self.interval = VehicleInterval(
            position=np.array([minus.interval.position[0], plus.interval.position[1]]),
            speed=np.array([minus.interval.speed[0], plus.interval.speed[1]]),
            heading=np.array([min(minus.interval.heading[0], plus.interval.heading[0]),
                              max(minus.interval.heading[1], plus.interval.heading[1])]),
        )

    def __deepcopy__(self, memo):
        # the lane tables are shared, not copied (they may be on the card)
        out = copy.copy(self)
        for name in ("theta_a_i", "theta_b_i", "interval", "longitudinal_lpv",
                     "lateral_lpv"):
            setattr(out, name, copy.deepcopy(getattr(self, name), memo))
        return out

    # -- the LPV predictor --------------------------------------------------- #
    def _longitudinal_structure(self, front_exists: bool, at_safe_gap: bool):
        """LinearVehicle.longitudinal_structure."""
        A = np.array([[0, 0, 1, 0], [0, 0, 0, 1], [0, 0, 0, 0], [0, 0, 0, 0]], float)
        phi0 = np.array([[0, 0, 0, 0], [0, 0, 0, 0], [0, 0, -1, 0], [0, 0, 0, -1]], float)
        phi1 = np.array([[0, 0, 0, 0], [0, 0, 0, 0], [0, 0, -1, 1], [0, 0, 0, 0]], float)
        phi2 = np.array([[0, 0, 0, 0], [0, 0, 0, 0], [-1, 1, -TIME_WANTED, 0], [0, 0, 0, 0]],
                        float)
        if not front_exists:
            phi1 = phi1 * 0
        if not (front_exists and at_safe_gap):
            phi2 = phi2 * 0
        return A, np.array([phi0, phi1, phi2])

    @staticmethod
    def _lateral_structure():
        """LinearVehicle.lateral_structure."""
        A = np.array([[0, 1], [0, 0]], float)
        phi0 = np.array([[0, 0], [0, -1]], float)
        phi1 = np.array([[0, 0], [-1, 0]], float)
        return A, np.array([phi0, phi1])

    def predictor_init(self, position, speed, front: VehicleInterval | None = None) -> None:
        """The longitudinal and lateral LPVs, built once from the interval
        (reference ``IntervalVehicle.predictor_init``)."""
        o = self.interval
        longi_i, lat_i = interval_absolute_to_local(o.position, self.geo, self.target_lane)
        v_i = o.speed
        psi_i = o.heading - self._lane_heading_at_position(position)

        if self.longitudinal_lpv is None:
            if front is not None:
                f_longi_i, _ = interval_absolute_to_local(front.position, self.geo,
                                                          self.target_lane)
                f_pos, f_vel = f_longi_i[0], front.speed[0]
            else:
                f_pos, f_vel = 0.0, 0.0
            x0 = [longi_i[0], f_pos, v_i[0], f_vel]
            center = [-DISTANCE_WANTED - self.target_speed * TIME_WANTED, 0,
                      self.target_speed, self.target_speed]
            a, phi = self._longitudinal_structure(front_exists=front is not None,
                                                  at_safe_gap=False)
            a0, da = polytope(lambda p: a + np.tensordot(phi, p, axes=[0, 0]), self.theta_a_i)
            self.longitudinal_lpv = LPV(
                x0, a0, da, b=np.eye(4), d=np.array([[1], [0], [0], [0]]),
                omega_i=np.array([[-1], [1]]) * 1.0,
                u=[[self.target_speed], [self.target_speed], [0], [0]], center=center,
            )
        if self.lateral_lpv is None:
            a, phi = self._lateral_structure()
            a0, da = polytope(lambda p: a + np.tensordot(phi, p, axes=[0, 0]), self.theta_b_i)
            self.lateral_lpv = LPV(
                [lat_i[0], psi_i[0]], a0, da, b=np.identity(2), d=np.array([[1], [0]]),
                omega_i=np.array([[-1], [1]]) * 0.5, u=[[0], [0]], center=[0, 0],
            )

    def predictor_step(self, dt: float, position, speed, front=None) -> None:
        """One step of the LPV predictors (reference
        ``IntervalVehicle.predictor_step``, without its rebase on a lane
        change)."""
        self.predictor_init(position, speed, front)
        self.longitudinal_lpv.step(dt)
        self.lateral_lpv.step(dt)
        x_i_long = self.longitudinal_lpv.change_coordinates(
            self.longitudinal_lpv.x_i_t, back=True, interval=True)
        x_i_lat = self.lateral_lpv.change_coordinates(
            self.lateral_lpv.x_i_t, back=True, interval=True)
        self.interval = VehicleInterval(
            position=interval_local_to_absolute(x_i_long[:, 0], x_i_lat[:, 0], self.geo,
                                                self.target_lane),
            speed=x_i_long[:, 2],
            heading=x_i_lat[:, 1],
        )


def worst_case_collision(interval: VehicleInterval, self_heading: float, other_position,
                         other_length: float, other_width: float, other_heading: float,
                         self_length: float = 5.0, self_width: float = 2.0):
    """Whether a planned ego pose could collide with a vehicle anywhere in
    its interval (reference ``IntervalVehicle.handle_collisions``):
    (collides, projection), the projection the box's point closest to the
    ego, or None when the rectangular pre-check rules a collision out."""
    lo, hi = interval.position[0], interval.position[1]
    p = np.asarray(other_position, float)
    if not np.all((lo - self_length <= p) & (p <= hi + self_length)):
        return False, None
    projection = np.minimum(np.maximum(p, lo), hi)

    def f32(x):
        return torch.as_tensor(np.asarray(x, float)).to(F32)

    hit, _, _ = rects_intersecting(
        f32(projection), f32(self_length), f32(self_width), f32(self_heading),
        f32(p), f32(0.9 * other_length), f32(0.9 * other_width), f32(other_heading),
    )
    return bool(hit), projection


def polytope_from_estimation(data: dict, parameter_box, structure):
    """The matrix polytope of a structure from the data's confidence
    polytope, or from the prior box without data (reference
    ``RegressionVehicle.polytope_from_estimation``)."""
    a, phi = structure()
    if not data:
        return polytope(lambda p: a + np.tensordot(phi, p, axes=[0, 0]), parameter_box)
    theta, d_theta, _, _ = confidence_polytope(data, parameter_box=parameter_box)
    a0 = a + np.tensordot(theta, phi, axes=[0, 0])
    da = [np.tensordot(dt, phi, axes=[0, 0]) for dt in d_theta]
    return a0, da


def _observer_of(env, h: SimpleNamespace, slot: int) -> IntervalObserver:
    obs = IntervalObserver(geo=env.geo, target_lane=int(h.target_lane[slot]),
                           target_speed=float(h.target_speed[slot]))
    obs.interval = VehicleInterval.degenerate(np.asarray(h.pos[slot], float),
                                              float(h.speed[slot]), float(h.heading[slot]))
    return obs


def observer_for_slot(env, state, slot: int, row: int = 0) -> IntervalObserver:
    """An observer of ``slot`` in row ``row`` of a state, its interval the
    slot's own state."""
    return _observer_of(env, host_row(state, row), slot)


# --------------------------------------------------------------------------- #
# multiple-model route-hypothesis tracking (reference estimation.py)
# --------------------------------------------------------------------------- #
def _route_of(env, h: SimpleNamespace, slot: int):
    n, ptr = int(h.route_len[slot]), int(h.route_ptr[slot])
    out = []
    for i in range(ptr, n):
        base = int(h.route_base[slot, i])
        if base < 0:
            break
        f, t, _ = env.net.lane_index_from_global(base)
        rid = int(h.route_id[slot, i])
        out.append((f, t, rid if rid >= 0 else None))
    return out


def route_of_slot(env, state, slot: int, row: int = 0):
    """A slot's route arrays as reference-style (from, to, lane id | None)
    tuples, from its cursor on (the reference pops the route's head as its
    lanes end)."""
    return _route_of(env, host_row(state, row), slot)


def routes_at_intersection(net, route):
    """Every route followable at the next intersection (reference
    ``ControlledVehicle.get_routes_at_intersection``); ``route`` a list of
    (from, to, lane id) tuples."""
    if not route:
        return []
    graph: dict[str, list[str]] = {}
    for f, t in net.edges:
        graph.setdefault(f, [])
        if t not in graph[f]:
            graph[f].append(t)
    index = None
    for i in range(min(len(route), 3)):
        dests = graph.get(route[i][1])
        if dests is None:
            continue
        if len(dests) >= 2:
            index = i
            break
    if index is None:
        return [list(route)]
    return [list(route[: index + 1]) + [(route[index][1], destination, route[index][2])]
            for destination in graph[route[index][1]]]


def _on_lane(lane, s, lat, margin=1.0) -> bool:
    """AbstractLane.on_lane with its default margin of 1 m."""
    half = lane.width / 2 + margin
    return abs(lat) <= half and -VEHICLE_LENGTH <= s < lane.length + VEHICLE_LENGTH


def _neighbours(env, h: SimpleNamespace, slot: int, lane_index):
    pos = np.asarray(h.pos, float)
    kind = np.asarray(h.kind, int)
    lane = env.net.get_lane(lane_index)
    s = float(np.asarray(lane.local_coordinates(pos[slot])[0]))
    s_front = s_rear = None
    front = rear = None
    for j in range(pos.shape[0]):
        if j == slot or kind[j] == KIND_PAD or kind[j] == KIND_LANDMARK:
            continue
        s_v, lat_v = (float(x) for x in lane.local_coordinates(pos[j]))
        if not _on_lane(lane, s_v, lat_v):
            continue
        if s <= s_v and (s_front is None or s_v <= s_front):
            s_front, front = s_v, j
        if s_v < s and (s_rear is None or s_v > s_rear):
            s_rear, rear = s_v, j
    return front, rear


def neighbour_slots(env, state, slot: int, lane_index, row: int = 0):
    """(front slot | None, rear slot | None) of ``slot`` projected on
    ``lane_index`` (reference ``Road.neighbour_vehicles``, one lane):
    landmarks and padding are no neighbours."""
    return _neighbours(env, host_row(state, row), slot, lane_index)


def _acceleration_features(env, h: SimpleNamespace, slot: int, self_lane_index):
    speed = float(h.speed[slot])
    target_speed = float(h.target_speed[slot])
    vt = target_speed - speed
    dv = dp = 0.0
    front, _ = _neighbours(env, h, slot, self_lane_index)
    if front is not None:
        lane = env.net.get_lane(self_lane_index)
        pos = np.asarray(h.pos, float)
        d = (float(np.asarray(lane.local_coordinates(pos[front])[0]))
             - float(np.asarray(lane.local_coordinates(pos[slot])[0])))
        d_safe = DISTANCE_WANTED + max(speed, 0.0) * TIME_WANTED
        dv = min(float(h.speed[front]) - speed, 0.0)
        dp = min(d - d_safe, 0.0)
    return np.array([vt, dv, dp])


def acceleration_features(env, state, slot: int, self_lane_index, row: int = 0):
    """LinearVehicle.acceleration_features: [target speed error, the
    front's closing speed (<= 0), the gap short of the safe one (<= 0)]."""
    return _acceleration_features(env, host_row(state, row), slot, self_lane_index)


def _not_zero32(x: np.float32) -> float:
    """``utils.math.not_zero`` of a float32 scalar."""
    if abs(x) > 1e-2:
        return float(x)
    return float(np.float32(1e-2) if x >= 0 else np.float32(-1e-2))


def _steering_features(env, h: SimpleNamespace, slot: int, lane_index):
    pos = np.asarray(h.pos[slot], float)
    speed = float(h.speed[slot])
    heading = float(h.heading[slot])
    lane = env.net.get_lane(lane_index)
    s, lat = (float(np.asarray(x)) for x in lane.local_coordinates(pos))
    s_next = s + speed * 0.1  # TAU_PURSUIT = 0.5 * TAU_HEADING
    future_heading = float(np.asarray(lane.heading_at(s_next)))
    nz = _not_zero32(np.float32(speed))
    # wrap_to_pi of a float32 scalar, in float32 as the JAX package's
    wrapped = (np.float32(future_heading - heading) + np.pi) % (2 * np.pi) - np.pi
    return np.array([float(wrapped) * VEHICLE_LENGTH / nz,
                     -lat * VEHICLE_LENGTH / (nz**2)])


def steering_features(env, state, slot: int, lane_index, row: int = 0):
    """LinearVehicle.steering_features: [heading error ahead, lateral
    offset], both scaled by the speed."""
    return _steering_features(env, host_row(state, row), slot, lane_index)


class MultipleModelTracker:
    """Route hypotheses of one vehicle slot in row ``row`` of a batch
    (reference MultipleModelVehicle): each step it adds the routes
    followable at the next intersection, collects (features, output)
    regression data under each, and drops the hypotheses whose lateral data
    is inconsistent with LinearVehicle's steering box; ``assume_model_is_valid``
    gives an observer as if one hypothesis held.  It runs on the host
    between steps, reading the row once a call."""

    def __init__(self, env, slot: int, route=None, row: int = 0):
        self.env = env
        self.slot = slot
        self.row = row
        self.route = [tuple(r) for r in (route or [])]
        self.data: list[tuple[list, dict]] = []  # (route, data) hypotheses
        self.collecting_data = True

    def act(self, state) -> None:
        if self.collecting_data:
            h = host_row(state, self.row)
            self._update_possible_routes(h)
            self._collect_data(h)

    def collect_data(self, state) -> None:
        self._collect_data(host_row(state, self.row))

    def _collect_data(self, h) -> None:
        """Features under each route hypothesis, outputs from the target
        lane the vehicle really follows."""
        output_lane = self.env.net.lane_index_from_global(int(h.target_lane[self.slot]))
        for route, data in self.data:
            self._add_features(h, data, route[0], output_lane=output_lane)

    def add_features(self, state, data, lane_index, output_lane=None) -> None:
        self._add_features(host_row(state, self.row), data, lane_index, output_lane)

    def _add_features(self, h, data, lane_index, output_lane=None) -> None:
        """LinearVehicle.add_features."""
        self_lane = self.env.net.lane_index_from_global(int(h.lane[self.slot]))
        features = _acceleration_features(self.env, h, self.slot, self_lane)
        output = float(np.dot(ACCELERATION_PARAMETERS, features))
        data.setdefault("longitudinal", {"features": [], "outputs": []})
        data["longitudinal"]["features"].append(features)
        data["longitudinal"]["outputs"].append(output)

        if output_lane is None:
            output_lane = lane_index
        features = _steering_features(self.env, h, self.slot, lane_index)
        out_features = _steering_features(self.env, h, self.slot, output_lane)
        output = float(np.dot(STEERING_PARAMETERS, out_features))
        data.setdefault("lateral", {"features": [], "outputs": []})
        data["lateral"]["features"].append(features)
        data["lateral"]["outputs"].append(output)

    def update_possible_routes(self, state) -> None:
        self._update_possible_routes(host_row(state, self.row))

    def _update_possible_routes(self, h) -> None:
        """Add the candidate routes at the next intersection, advance each
        hypothesis past the lanes it has finished, drop the laterally
        inconsistent ones."""
        position = np.asarray(h.pos[self.slot], float)
        # the tracked vehicle's own route advances as its lanes end
        while len(self.route) > 1:
            lane0 = self.env.net.get_lane(self.route[0])
            s0 = float(np.asarray(lane0.local_coordinates(position)[0]))
            if s0 > lane0.length - VEHICLE_LENGTH / 2:
                self.route.pop(0)
            else:
                break

        for route in routes_at_intersection(self.env.net, self.route):
            # an unknown lane id is lane 0
            route = [idx if idx[2] is not None and idx[2] >= 0 else (idx[0], idx[1], 0)
                     for idx in route]
            for known_route, _ in self.data:
                if known_route == route:
                    break
                if len(known_route) < len(route) and route[: len(known_route)] == known_route:
                    self.data = [(r, d) if r != known_route else (route, d)
                                 for r, d in self.data]
                    break
            else:
                self.data.append((list(route), {}))

        for route, _ in self.data:
            lane = self.env.net.get_lane(route[0])
            s = float(np.asarray(lane.local_coordinates(position)[0]))
            if len(route) > 1 and s > lane.length - VEHICLE_LENGTH / 2:
                route.pop(0)

        for route, data in list(self.data):
            if data and not is_consistent_dataset(data["lateral"],
                                                  parameter_box=STEERING_RANGE):
                self.data.remove((route, data))

    def assume_model_is_valid(self, state, index: int):
        """(observer, route, data) of hypothesis ``index``: the observer
        follows the hypothesis' first lane."""
        obs = observer_for_slot(self.env, state, self.slot, self.row)
        if not self.data:
            return obs, list(self.route), {}
        index = min(index, len(self.data) - 1)
        route, data = self.data[index]
        obs.target_lane = self.env.net.global_lane_index(route[0])
        return obs, list(route), data


# --------------------------------------------------------------------------- #
# the nonlinear interval observer over a fleet, batched torch
# --------------------------------------------------------------------------- #
def _iprod(a_i: torch.Tensor, b_i: torch.Tensor) -> torch.Tensor:
    """Interval product of scalar intervals (..., 2) x (..., 2)."""
    cands = torch.stack([a_i[..., 0] * b_i[..., 0], a_i[..., 0] * b_i[..., 1],
                         a_i[..., 1] * b_i[..., 0], a_i[..., 1] * b_i[..., 1]], dim=-1)
    return torch.stack([cands.amin(-1), cands.amax(-1)], dim=-1)


def _iprod_rowvec(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Interval dot product of (..., 2, K) intervals theta and phi, the K
    products summed left to right."""
    out = _iprod(theta[..., 0], phi[..., 0])
    for k in range(1, theta.shape[-1]):
        out = out + _iprod(theta[..., k], phi[..., k])
    return out


def observer_step_batch(geo, target_lane, target_speed, theta_a_i, theta_b_i, position_i,
                        speed_i, heading_i, position, dt, front_position_i=None,
                        front_speed_i=None, front_mask=None):
    """One nonlinear interval-observer step of a batch of observers (the
    host ``IntervalObserver.observer_step`` of each at once), on the device
    of its tensors, with leading batch dims everywhere.

    target_lane (...,) int; target_speed (...,); theta_a_i (..., 2, 3);
    theta_b_i (..., 2, 2); position_i (..., 2, 2) [min / max of x, y];
    speed_i, heading_i (..., 2); position (..., 2) the measured position;
    ``front_mask`` (...,) bool couples a row to its leader's
    ``front_position_i`` / ``front_speed_i``.  Returns (position_i,
    speed_i, heading_i)."""
    position_i = torch.as_tensor(position_i).to(F32)
    v_i = torch.as_tensor(speed_i).to(F32)
    psi_i = torch.as_tensor(heading_i).to(F32)
    theta_a_i = torch.as_tensor(theta_a_i).to(F32)
    theta_b_i = torch.as_tensor(theta_b_i).to(F32)
    if isinstance(target_speed, torch.Tensor):
        target_speed = target_speed.to(F32)
    if front_mask is None:
        front_mask = torch.zeros(v_i.shape[:-1], dtype=torch.bool, device=v_i.device)
        front_position_i = torch.zeros_like(position_i)
        front_speed_i = torch.zeros_like(v_i)

    # the lane frame at the measured position
    s0, _ = lane_ops.local_coordinates(geo, target_lane, torch.as_tensor(position).to(F32))
    lane_psi = lane_ops.heading_at(geo, target_lane, s0)

    # the IDM-like features phi_a (..., 2, 3): [target speed error, dv-, gap-]
    zero = torch.zeros_like(v_i)
    dvf = torch.stack([front_speed_i[..., 0] - v_i[..., 1],
                       front_speed_i[..., 1] - v_i[..., 0]], dim=-1)
    phi_a1 = torch.where(front_mask[..., None], dvf.clamp(max=0.0), zero)
    lane_dir = torch.stack([torch.cos(lane_psi), torch.sin(lane_psi)], dim=-1)
    diff_box = torch.stack([front_position_i[..., 0, :] - position_i[..., 1, :],
                            front_position_i[..., 1, :] - position_i[..., 0, :]], dim=-2)
    d_i = box_section(diff_box, lane_dir)
    d_safe_i = DISTANCE_WANTED + TIME_WANTED * v_i
    gap = torch.stack([d_i[..., 0] - d_safe_i[..., 1], d_i[..., 1] - d_safe_i[..., 0]], dim=-1)
    phi_a2 = torch.where(front_mask[..., None], gap.clamp(max=0.0), zero)
    phi_a = torch.stack([torch.zeros_like(phi_a1), phi_a1, phi_a2], dim=-1)

    # the steering feature phi_b (..., 2, 2) from the lateral interval
    _, lat_i = box_absolute_to_local(geo, target_lane, position_i)
    lateral_i = -torch.flip(lat_i, dims=(-1,))
    i_v_i = 1.0 / torch.flip(v_i, dims=(-1,))
    phi_b1 = _iprod(lateral_i, i_v_i)
    phi_b = torch.stack([torch.zeros_like(phi_b1), phi_b1], dim=-1)

    a_i = _iprod_rowvec(theta_a_i, phi_a)
    b_i = _iprod_rowvec(theta_b_i, phi_b)

    dv_err = torch.stack([target_speed - v_i[..., 1], target_speed - v_i[..., 0]], dim=-1)
    dv_i = _iprod(torch.stack([theta_a_i[..., 0, 0], theta_a_i[..., 1, 0]], dim=-1), dv_err)
    dv_i = (dv_i + a_i).clamp(-ACC_MAX, ACC_MAX)

    delta_psi = wrap_to_pi(psi_i - lane_psi[..., None])
    d_psi_i = box_integrator(
        delta_psi, torch.stack([theta_b_i[..., 0, 0], theta_b_i[..., 1, 0]], dim=-1))
    d_psi_i = d_psi_i + b_i

    # the cos / sin bounds of the heading interval
    lo, hi = psi_i[..., 0], psi_i[..., 1]
    one = torch.ones_like(lo)
    cos_lo = torch.where((lo <= math.pi) & (math.pi <= hi), -one,
                         torch.minimum(torch.cos(lo), torch.cos(hi)))
    cos_hi = torch.where((lo <= 0.0) & (0.0 <= hi), one,
                         torch.maximum(torch.cos(lo), torch.cos(hi)))
    sin_lo = torch.where((lo <= -math.pi / 2) & (-math.pi / 2 <= hi), -one,
                         torch.minimum(torch.sin(lo), torch.sin(hi)))
    sin_hi = torch.where((lo <= math.pi / 2) & (math.pi / 2 <= hi), one,
                         torch.maximum(torch.sin(lo), torch.sin(hi)))
    dx_i = _iprod(v_i, torch.stack([cos_lo, cos_hi], dim=-1))
    dy_i = _iprod(v_i, torch.stack([sin_lo, sin_hi], dim=-1))

    # [-1, 1] made on the device: no host copy, so no sync in the step
    noise = (torch.arange(2, dtype=F32, device=v_i.device) * 2 - 1) * (NOISE_PARTIAL * dt)
    new_speed = v_i + dv_i * dt
    new_heading = psi_i + d_psi_i * dt + noise
    new_pos = torch.stack([position_i[..., 0] + (dx_i * dt + noise),
                           position_i[..., 1] + (dy_i * dt + noise)], dim=-1)
    return new_pos, new_speed, new_heading
