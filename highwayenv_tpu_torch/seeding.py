"""Seeded reset: replay the reference's NumPy draw schedule on the host.

PyTorch counterpart of ``highwayenv_tpu/seeding.py``.  The reference seeds
one ``np.random.Generator`` per env (Gymnasium ``Env.reset(seed=...)``) and
every scene draw (spawn lanes, speeds, longitudinal offsets, behaviour
randomization) consumes it in an order fixed by the Python control flow of
each scenario's ``_create_vehicles`` (reference
highway_env/envs/common/abstract.py ``reset``,
highway_env/vehicle/kinematics.py ``create_random``).

This module replays those draw schedules on the host with the same
Generator calls in the same order, in float64 as the reference computes,
so ``reset(seed=s)`` gives the reference's initial scene, cast once to
float32 into a (1, V) ``VehicleState`` on the env's device.  The batched
``torch.Generator`` reset stays the throughput path; this one backs the
single-env ``GymEnv``.

Every registered id is supported, the intersection's 3 s warm-up included
(it draws nothing in the reference; the port runs it on the regulated frame
kernel K5 on CUDA, on its plain version on the CPU).
The one excluded mode is racetrack-oval with a random layout (``length`` or
``no_lanes`` 0): the reference draws that layout from an unseeded
generator, so there is nothing to replay.

The episode's own randomness after the scene (the intersection's spawns,
lane-keeping's observation noise) comes from a ``torch.Generator`` seeded
from the replay generator's state, which consumes no draw
(``generator_from``).  Its bits differ from the JAX package's key, the
distributions do not.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from highwayenv_tpu_torch.vehicle.state import (
    KIND_EGO,
    KIND_IDM,
    KIND_LANDMARK,
    KIND_OBSTACLE,
    KIND_PAD,
    KIND_PLAIN,
    VEHICLE_LENGTH,
    VEHICLE_WIDTH,
    VehicleState,
    empty_state,
)

# IDMVehicle.DELTA_RANGE and LANE_CHANGE_DELAY (reference vehicle/behavior.py)
DELTA_RANGE = (3.5, 4.5)
LANE_CHANGE_DELAY = 1.0
DEFAULT_INITIAL_SPEEDS = (23.0, 25.0)  # Vehicle.DEFAULT_INITIAL_SPEEDS


def np_random(seed=None) -> np.random.Generator:
    """The reference's generator, as ``gymnasium.utils.seeding.np_random``
    builds it: ``Generator(PCG64(SeedSequence(seed)))``."""
    if seed is not None and not (isinstance(seed, (int, np.integer)) and seed >= 0):
        raise ValueError(f"seed must be a non-negative int or None, got {seed!r}")
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))


# --------------------------------------------------------------------------- #
# host scene records
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class HostVehicle:
    """Host spawn record (the fields ``scene_to_state`` reads)."""

    kind: int
    position: np.ndarray
    heading: float = 0.0
    speed: float = 0.0
    lane_index: tuple | None = None
    target_lane_index: tuple | None = None
    target_speed: float = 0.0
    speed_index: int = 0
    route: list | None = None
    delta: float = 4.0
    timer: float = 0.0
    enable_lane_change: bool = True
    length: float = VEHICLE_LENGTH
    width: float = VEHICLE_WIDTH
    check_collisions: bool = True
    is_ego: bool = False
    slot: int | None = None  # an explicit slot (else packed in list order)


def graph_order(net):
    """{from: [to, ...]} in the reference's nested-dict iteration order:
    from-nodes by first appearance, to-nodes by first appearance within each
    (reference road/road.py graph construction)."""
    order: dict[str, list[str]] = {}
    for (f, t) in net.edges.keys():
        order.setdefault(f, [])
        if t not in order[f]:
            order[f].append(t)
    return order


def closest_lane_index(net, position, heading=None):
    """network.get_closest_lane_index (reference road/road.py): the first
    argmin of lane.distance_with_heading over the nested graph order."""
    best, best_d = None, np.inf
    for f, tos in graph_order(net).items():
        for t in tos:
            for i, lane in enumerate(net.lanes_on_edge(f, t)):
                s, r = lane.local_coordinates(position)
                d = abs(r) + max(s - lane.length, 0) + max(0 - s, 0)
                if heading is not None:
                    angle = (heading - lane.heading_at(s) + np.pi) % (2 * np.pi) - np.pi
                    d += abs(angle)
                if d < best_d:
                    best, best_d = (f, t, i), d
    return best


def plan_route_to(net, lane_index, destination):
    """ControlledVehicle.plan_route_to (reference vehicle/controller.py)."""
    path = net.bfs_shortest_path(lane_index[1], destination)
    if path:
        return [lane_index] + [(path[i], path[i + 1], None) for i in range(len(path) - 1)]
    return [lane_index]


def near_split(x, num_bins):
    """utils.near_split (reference utils.py)."""
    quotient, remainder = divmod(x, num_bins)
    return [quotient + 1] * remainder + [quotient] * (num_bins - remainder)


# --------------------------------------------------------------------------- #
# reference constructors (draw-free: position and lane bookkeeping only)
# --------------------------------------------------------------------------- #
def _controlled(env, net, position, heading=0.0, speed=0.0):
    """action_type.vehicle_class(road, position, heading, speed): a plain
    Vehicle for continuous actions, an MDPVehicle (target speed snapped to
    the grid, reference vehicle/controller.py) for DiscreteMetaAction."""
    position = np.asarray(position, np.float64)
    lane_index = closest_lane_index(net, position, heading)
    v = HostVehicle(
        kind=KIND_EGO, position=position, heading=float(heading), speed=float(speed),
        lane_index=lane_index, target_lane_index=lane_index, target_speed=float(speed),
        is_ego=True,
    )
    ts = getattr(env.action_type, "target_speeds", None)
    if ts is not None:
        ts = np.asarray(ts, np.float64)
        # speed_to_index with clip (reference vehicle/controller.py)
        x = (v.target_speed - ts[0]) / (ts[-1] - ts[0])
        idx = int(np.clip(np.round(x * (len(ts) - 1)), 0, len(ts) - 1))
        v.speed_index = idx
        v.target_speed = float(ts[idx])
    return v


def _idm(net, position, heading=0.0, speed=0.0, target_speed=None):
    """IDMVehicle(road, position, ...) (reference vehicle/behavior.py): the
    timer from the position, DELTA at its default until randomize_behavior."""
    position = np.asarray(position, np.float64)
    lane_index = closest_lane_index(net, position, heading)
    return HostVehicle(
        kind=KIND_IDM, position=position, heading=float(heading), speed=float(speed),
        lane_index=lane_index, target_lane_index=lane_index,
        target_speed=float(speed if target_speed is None else target_speed),
        delta=4.0, timer=float((np.sum(position) * np.pi) % LANE_CHANGE_DELAY),
    )


def _plain(net, position, heading=0.0, speed=0.0):
    """A plain Vehicle: no lane lookup, as the reference's seed vehicles."""
    return HostVehicle(kind=KIND_PLAIN, position=np.asarray(position, np.float64),
                       heading=float(heading), speed=float(speed))


def _make_on_lane(net, lane_index, longitudinal, speed=None, ctor=_idm):
    """RoadObject.make_on_lane (reference vehicle/objects.py)."""
    lane = net.get_lane(lane_index)
    if speed is None:
        speed = lane.speed_limit
    return ctor(net, lane.position(longitudinal, 0), heading=lane.heading_at(longitudinal),
                speed=speed)


def _create_random(env, rng, existing, ctor, speed=None, lane_from=None, lane_to=None,
                   lane_id=None, spacing=1.0):
    """Vehicle.create_random's draw schedule (reference
    vehicle/kinematics.py): choice(from), choice(to), choice(id), [uniform
    speed], uniform offset."""
    net = env.net
    order = graph_order(net)
    _from = lane_from or rng.choice(list(order.keys()))
    _to = lane_to or rng.choice(order[_from])
    lanes = net.lanes_on_edge(_from, _to)
    _id = lane_id if lane_id is not None else rng.choice(len(lanes))
    lane = lanes[int(_id)]
    if speed is None:
        if lane.speed_limit is not None:
            speed = rng.uniform(0.7 * lane.speed_limit, 0.8 * lane.speed_limit)
        else:
            speed = rng.uniform(*DEFAULT_INITIAL_SPEEDS)
    default_spacing = 12 + 1.0 * speed
    offset = spacing * default_spacing * np.exp(-5 / 40 * len(lanes))
    x0 = (max(lane.local_coordinates(v.position)[0] for v in existing)
          if existing else 3 * offset)
    x0 += offset * rng.uniform(0.9, 1.1)
    return ctor(net, lane.position(x0, 0), lane.heading_at(x0), float(speed))


def _randomize_idm(v, rng):
    """IDMVehicle.randomize_behavior (reference vehicle/behavior.py)."""
    v.delta = float(rng.uniform(*DELTA_RANGE))
    return v


# --------------------------------------------------------------------------- #
# per-scenario draw schedules
# --------------------------------------------------------------------------- #
def _spawns_highway(env, rng):
    """HighwayEnv._create_vehicles (reference envs/highway_env.py)."""
    cfg = env.config
    objs = []
    for others in near_split(cfg["vehicles_count"], cfg["controlled_vehicles"]):
        ego_seed = _create_random(env, rng, objs, ctor=_plain, speed=25.0,
                                  lane_id=cfg["initial_lane_id"], spacing=cfg["ego_spacing"])
        objs.append(_controlled(env, env.net, ego_seed.position, ego_seed.heading,
                                ego_seed.speed))
        for _ in range(others):
            v = _create_random(env, rng, objs, ctor=_idm, spacing=1 / cfg["vehicles_density"])
            _randomize_idm(v, rng)
            objs.append(v)
    return objs


def _obstacle(net, position, slot=None):
    """The end-of-ramp obstacle of the merge envs (a 2 x 2 RoadObject)."""
    opos = np.asarray(position, np.float64)
    return HostVehicle(kind=KIND_OBSTACLE, position=opos, length=2.0, width=2.0,
                       lane_index=closest_lane_index(net, opos, 0.0), slot=slot)


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor of the env (on any device) as a float64 host array."""
    return t.detach().cpu().numpy().astype(np.float64)


def _spawns_merge(env, rng):
    """MergeEnv._make_vehicles (reference envs/merge_env.py)."""
    net = env.net
    objs = [_controlled(env, net, net.get_lane(("a", "b", 1)).position(30.0, 0.0), speed=30.0)]
    for position, speed in [(90.0, 29.0), (70.0, 31.0), (5.0, 31.5)]:
        lane = net.get_lane(("a", "b", int(rng.integers(2))))
        pos = lane.position(position + rng.uniform(-5.0, 5.0), 0.0)
        speed += rng.uniform(-1.0, 1.0)
        objs.append(_idm(net, pos, speed=float(speed)))
    objs.append(_idm(net, net.get_lane(("j", "k", 0)).position(110.0, 0.0), speed=20.0,
                     target_speed=30.0))
    objs.append(_obstacle(net, _host(env._obstacle_pos)))
    return objs


def _spawns_roundabout(env, rng):
    """RoundaboutEnv._make_vehicles (reference envs/roundabout_env.py)."""
    net = env.net
    cfg = env.config
    position_deviation = 2.0
    speed_deviation = 2.0
    ego_lane = net.get_lane(("ser", "ses", 0))
    ego = _controlled(env, net, ego_lane.position(125.0, 0.0), speed=8.0,
                      heading=ego_lane.heading_at(140.0))
    ego.route = plan_route_to(net, ego.lane_index, "nxs")
    objs = [ego]
    destinations = ["exr", "sxr", "nxr"]

    def incoming(lane_index, longitudinal_base, dest=None):
        v = _make_on_lane(
            net, lane_index,
            longitudinal=longitudinal_base + rng.normal() * position_deviation,
            speed=16.0 + rng.normal() * speed_deviation,
        )
        v.route = plan_route_to(net, v.lane_index,
                                dest if dest is not None else rng.choice(destinations))
        _randomize_idm(v, rng)
        objs.append(v)

    dest0 = None
    if cfg["incoming_vehicle_destination"] is not None:
        dest0 = destinations[cfg["incoming_vehicle_destination"]]
    incoming(("we", "sx", 1), 5.0, dest0)
    for i in [1, -1]:
        incoming(("we", "sx", 0), 20.0 * float(i))
    incoming(("eer", "ees", 0), 50.0)
    return objs


def _spawns_parking(env, rng):
    """ParkingEnv._create_vehicles (reference envs/parking_env.py)."""
    net = env.net
    cfg = env.config
    objs = []
    empty_spots = [(f, t, i) for f, tos in graph_order(net).items() for t in tos
                   for i in range(len(net.lanes_on_edge(f, t)))]

    egos = []
    for i in range(cfg["controlled_vehicles"]):
        x0 = float(i - cfg["controlled_vehicles"] // 2) * 10.0
        ego = _controlled(env, net, [x0, 0.0], heading=2.0 * np.pi * rng.uniform(), speed=0.0)
        objs.append(ego)
        egos.append(ego)
        empty_spots.remove(ego.lane_index)

    goals = []
    for k, _ in enumerate(egos):
        lane_index = empty_spots[int(rng.choice(np.arange(len(empty_spots))))]
        lane = net.get_lane(lane_index)
        goals.append(HostVehicle(
            slot=env._goal_base + k, kind=KIND_LANDMARK,
            position=np.asarray(lane.position(lane.length / 2, 0), np.float64),
            heading=float(lane.heading),
            lane_index=closest_lane_index(net, lane.position(lane.length / 2, 0),
                                          lane.heading),
            length=2.0, width=2.0,  # a Landmark is a 2 x 2 RoadObject
        ))
        empty_spots.remove(lane_index)

    npcs = []
    for _ in range(cfg["vehicles_count"]):
        if not empty_spots:
            continue
        lane_index = empty_spots[int(rng.choice(np.arange(len(empty_spots))))]
        v = _make_on_lane(
            net, lane_index, longitudinal=4.0, speed=0.0,
            ctor=lambda net, p, heading=0.0, speed=0.0: HostVehicle(
                kind=KIND_PLAIN, position=np.asarray(p, np.float64), heading=float(heading),
                speed=float(speed), lane_index=closest_lane_index(net, p, heading),
                slot=cfg["controlled_vehicles"] + len(npcs),
            ),
        )
        npcs.append(v)
        objs.append(v)
        empty_spots.remove(lane_index)

    walls = []
    if cfg.get("add_walls", True):
        width, height = 70.0, 42.0
        wb = env._wall_base
        for y in (-height / 2, height / 2):
            walls.append(HostVehicle(
                slot=wb + len(walls), kind=KIND_OBSTACLE, position=np.array([0.0, y]),
                length=width, width=1.0, lane_index=closest_lane_index(net, [0.0, y], 0.0),
            ))
        for x in (-width / 2, width / 2):
            walls.append(HostVehicle(
                slot=wb + len(walls), kind=KIND_OBSTACLE, position=np.array([x, 0.0]),
                heading=np.pi / 2, length=height, width=1.0,
                lane_index=closest_lane_index(net, [x, 0.0], np.pi / 2),
            ))
    # the reference's list order: vehicles (egos, parked), then objects
    # (goal landmarks, walls)
    return objs + goals + walls


def _spawns_two_way(env, rng):
    """TwoWayEnv._make_vehicles (reference envs/two_way_env.py)."""
    net = env.net
    objs = [_controlled(env, net, net.get_lane(("a", "b", 1)).position(30.0, 0.0), speed=30.0)]
    # same-direction traffic on ("a", "b", 1), no lane changes
    ab1 = net.get_lane(("a", "b", 1))
    for i in range(3):
        v = _idm(net, ab1.position(70.0 + 40.0 * float(i) + 10.0 * rng.normal(), 0.0),
                 heading=ab1.heading_at(70.0 + 40.0 * float(i)),
                 speed=24.0 + 2.0 * rng.normal())
        v.enable_lane_change = False
        objs.append(v)
    # oncoming traffic on ("b", "a", 0), its target lane set explicitly
    ba0 = net.get_lane(("b", "a", 0))
    for i in range(2):
        v = _idm(net, ba0.position(200.0 + 100.0 * float(i) + 10.0 * rng.normal(), 0.0),
                 heading=ba0.heading_at(200.0 + 100.0 * float(i)),
                 speed=20.0 + 5.0 * rng.normal())
        v.enable_lane_change = False
        v.target_lane_index = ("b", "a", 0)
        objs.append(v)
    return objs


def _spawns_u_turn(env, rng):
    """UTurnEnv._make_vehicles (reference envs/u_turn_env.py): the ego on
    ("a", "b", 0), six IDM blockers with N(0, 2) jitter; only the first calls
    randomize_behavior."""
    net = env.net
    ego = _controlled(env, net, net.get_lane(("a", "b", 0)).position(0, 0), speed=16.0)
    ego.route = plan_route_to(net, ego.lane_index, "d")
    objs = [ego]
    npcs = [
        (("a", "b", 0), 25.0, 13.5, True),
        (("a", "b", 1), 56.0, 14.5, False),
        (("b", "c", 1), 0.5, 4.5, False),
        (("b", "c", 0), 17.5, 5.5, False),
        (("c", "d", 0), 1.0, 3.5, False),
        (("c", "d", 1), 30.0, 5.5, False),
    ]
    for lane_index, s, speed, randomize in npcs:
        v = _make_on_lane(net, lane_index, longitudinal=s + rng.normal() * 2.0,
                          speed=speed + rng.normal() * 2.0)
        v.route = plan_route_to(net, v.lane_index, "d")
        if randomize:
            _randomize_idm(v, rng)
        objs.append(v)
    return objs


def _spawns_exit(env, rng):
    """ExitEnv._create_vehicles (reference envs/exit_env.py)."""
    net = env.net
    cfg = env.config
    objs = []
    for _ in range(cfg["controlled_vehicles"]):
        seed_v = _create_random(env, rng, objs, ctor=_plain, speed=25.0, lane_from="0",
                                lane_to="1", lane_id=0, spacing=cfg["ego_spacing"])
        objs.append(_controlled(env, net, seed_v.position, seed_v.heading, seed_v.speed))
    for _ in range(cfg["vehicles_count"]):
        lanes = np.arange(cfg["lanes_count"])
        lane_id = int(rng.choice(lanes, size=1, p=lanes / lanes.sum()).astype(int)[0])
        lane = net.get_lane(("0", "1", lane_id))
        v = _create_random(env, rng, objs, ctor=_idm, lane_from="0", lane_to="1",
                           lane_id=lane_id, speed=lane.speed_limit,
                           spacing=1 / cfg["vehicles_density"])
        v.route = plan_route_to(net, v.lane_index, "3")
        v.enable_lane_change = False
        objs.append(v)
    return objs


def _spawns_roundabout_generic(env, rng):
    """RoundaboutGenericEnv._make_vehicles: rejection-sampled spawns over
    fixed spawn edges; a try draws integers(edge), integers(lane),
    uniform(longitudinal); a success normal(speed), [integers(destination)],
    then the IDM exponent."""
    cfg = env.config
    net = env.net
    destinations = ["exr", "sxr", "nxr", "wxr"]
    ego_lane = net.get_lane(("ser", "ses", 0))
    ego_long = ego_lane.length - 2.5
    ego = _controlled(env, net, ego_lane.position(ego_long, 0.0), speed=8.0,
                      heading=ego_lane.heading_at(ego_long))
    ego.route = plan_route_to(net, ego.lane_index, "nxs")
    objs = [ego]

    spawn_lanes = [("we", "sx"), ("sx", "se"), ("ee", "nx"), ("nx", "ne"),
                   ("eer", "ees"), ("ner", "nes"), ("wer", "wes")]
    points = [np.asarray(ego_lane.position(ego_long, 0.0))]
    for _ in range(cfg["vehicles_count"]):
        for _ in range(10):
            lt = spawn_lanes[int(rng.integers(0, len(spawn_lanes)))]
            li = int(rng.integers(0, len(net.lanes_on_edge(*lt))))
            lane_id = (lt[0], lt[1], li)
            lane = net.get_lane(lane_id)
            lon = float(rng.uniform(5.0, max(5.0, lane.length - 5.0)))
            cand = np.asarray(lane.position(lon, 0.0))
            if any(np.linalg.norm(cand - pt) < 7.0 for pt in points):
                continue
            v = _make_on_lane(net, lane_id, longitudinal=lon,
                              speed=14.0 + float(rng.normal()) * 2.0)
            if cfg.get("incoming_vehicle_destination") is not None:
                dest = destinations[min(cfg["incoming_vehicle_destination"],
                                        len(destinations) - 1)]
            else:
                dest = destinations[int(rng.integers(0, len(destinations)))]
            v.route = plan_route_to(net, v.lane_index, dest)
            _randomize_idm(v, rng)
            objs.append(v)
            points.append(cand)
            break
    return objs


def _spawns_merge_generic(env, rng):
    """MergeGenericEnv._make_vehicles: rejection-sampled NPCs (10 tries each,
    15 m clearance); a try draws integers(lane), uniform(position), and a
    success uniform(speed)."""
    cfg = env.config
    net = env.net
    lanes = cfg["lanes_count"]
    vc = cfg["vehicles_count"]
    max_pos = (cfg["before_merge_length"] + cfg["converge_merge_length"]
               + cfg["parallel_merge_length"])
    ego_long = 30.0
    objs = [_controlled(env, net, net.get_lane(("a", "b", lanes - 1)).position(ego_long, 0.0),
                        speed=30.0)]

    spawned = {i: [] for i in range(lanes)}
    spawned[lanes - 1].append(ego_long)
    n = 0
    for _ in range(vc):
        for _ in range(10):
            li = int(rng.integers(lanes))
            lon = float(rng.uniform(0, max_pos))
            if all(abs(lon - p) > 15.0 for p in spawned[li]):
                spd = 30.0 + float(rng.uniform(-2.0, 2.0))
                v = _idm(net, net.get_lane(("a", "b", li)).position(lon, 0.0), speed=spd)
                v.slot = 1 + n
                n += 1
                spawned[li].append(lon)
                objs.append(v)
                break

    merging = _idm(net, net.get_lane(("j", "k", 0)).position(ego_long + 30.0, 0.0),
                   speed=20.0, target_speed=30.0)
    merging.slot = 1 + vc
    objs.append(merging)
    objs.append(_obstacle(net, _host(env._obstacle_pos), slot=2 + vc))
    return objs


def _spawns_lane_keeping(env, rng):
    """LaneKeepingEnv._make_vehicles (reference envs/lane_keeping_env.py):
    deterministic (only the observation noise draws during the episode)."""
    net = env.net
    lane = net.get_lane(("c", "d", 0))
    return [_controlled(env, net, lane.position(50, -4), heading=lane.heading_at(0),
                        speed=8.3)]


def _random_lane_index(net, rng):
    """RoadNetwork.random_lane_index (reference road/road.py)."""
    order = graph_order(net)
    _from = rng.choice(list(order.keys()))
    _to = rng.choice(order[_from])
    _id = int(rng.integers(len(net.lanes_on_edge(_from, _to))))
    return (_from, _to, _id)


def _spawns_racetrack(env, rng, n_first=2):
    """RacetrackEnv._make_vehicles (reference envs/racetrack_env.py).

    ``n_first`` is the ego's first-lane draw width: the base and large
    tracks draw ``rng.integers(2)``, the oval ``rng.integers(no_lanes)``;
    the rest of the schedule is the same."""
    net = env.net
    cfg = env.config
    objs = []
    lane_index = None
    for i in range(cfg["controlled_vehicles"]):
        lane_index = (("a", "b", int(rng.integers(n_first))) if i == 0
                      else _random_lane_index(net, rng))
        longitudinal = float(rng.uniform(20, 50))
        objs.append(_make_on_lane(
            net, lane_index, longitudinal,
            ctor=lambda net, p, heading=0.0, speed=0.0: _controlled(env, net, p, heading, speed),
        ))

    if cfg["other_vehicles"] > 0:
        objs.append(_make_on_lane(
            net, ("b", "c", int(lane_index[-1])),
            longitudinal=float(rng.uniform(0.0, net.get_lane(("b", "c", 0)).length)),
            speed=6.0 + float(rng.uniform(high=3.0)),
        ))
        for _ in range(int(rng.integers(cfg["other_vehicles"]))):
            rand_lane = _random_lane_index(net, rng)
            v = _make_on_lane(
                net, rand_lane,
                longitudinal=float(rng.uniform(0.0, net.get_lane(rand_lane).length)),
                speed=6.0 + float(rng.uniform(high=3.0)),
            )
            # no early collisions (the reference's 20 m test)
            if all(np.linalg.norm(v.position - np.asarray(o.position)) >= 20 for o in objs):
                objs.append(v)
    return objs


def _spawns_racetrack_oval(env, rng):
    """RacetrackEnvOval._make_vehicles: the base racetrack's schedule with
    the ego's first lane drawn over all ``no_lanes`` lanes."""
    return _spawns_racetrack(env, rng, n_first=int(env.config["no_lanes"]))


def _spawn_vehicle_intersection(env, rng, vehicles, longitudinal=0.0,
                                position_deviation=1.0, speed_deviation=1.0,
                                spawn_probability=0.6, go_straight=False):
    """IntersectionEnv._spawn_vehicle (reference envs/intersection_env.py)."""
    net = env.net
    if rng.uniform() > spawn_probability:
        return None
    route = rng.choice(range(4), size=2, replace=False)
    route[1] = (route[0] + 2) % 4 if go_straight else route[1]
    v = _make_on_lane(
        net, (f"o{route[0]}", f"ir{route[0]}", 0),
        longitudinal=longitudinal + 5.0 + rng.normal() * position_deviation,
        speed=8.0 + rng.normal() * speed_deviation,
    )
    for other in vehicles:
        if np.linalg.norm(np.asarray(other.position) - v.position) < 15:
            return None
    v.route = plan_route_to(net, v.lane_index, f"o{route[1]}")
    _randomize_idm(v, rng)
    vehicles.append(v)
    return v


# --------------------------------------------------------------------------- #
# scene -> VehicleState
# --------------------------------------------------------------------------- #
_SCENE_FIELDS = (
    "pos heading speed lane target_lane target_speed speed_index timer delta crashed kind "
    "length width check_collisions enable_lane_change route_base route_n route_id route_len"
).split()


def scene_to_state(env, objs) -> VehicleState:
    """The (1, V) VehicleState of host spawn records, on ``env.device``:
    egos into ``env.ego_slots``, the others into the free slots in list
    order, a record with a ``slot`` into that slot.  The host values are
    float64, cast once to float32."""
    net = env.net
    V = env.num_slots
    if len(objs) > V:
        raise ValueError(f"{len(objs)} objects > {V} slots")
    R = env.route_slots
    st = empty_state(1, V, route_slots=R)
    ego_slots = list(env.ego_slots)
    free_slots = [i for i in range(V) if i not in set(ego_slots)]

    def host(t):
        x = t[0].numpy()
        return x.astype(np.float64) if np.issubdtype(x.dtype, np.floating) else x.copy()

    arr = {name: host(getattr(st, name)) for name in _SCENE_FIELDS}
    for v in objs:
        if v.slot is not None:
            i = v.slot
            if i in free_slots:
                free_slots.remove(i)
        else:
            i = ego_slots.pop(0) if v.is_ego else free_slots.pop(0)
        arr["pos"][i] = v.position
        arr["heading"][i] = v.heading
        arr["speed"][i] = v.speed
        arr["kind"][i] = v.kind
        arr["length"][i] = v.length
        arr["width"][i] = v.width
        arr["timer"][i] = v.timer
        arr["delta"][i] = v.delta
        arr["target_speed"][i] = v.target_speed
        arr["speed_index"][i] = v.speed_index
        arr["enable_lane_change"][i] = v.enable_lane_change
        arr["check_collisions"][i] = v.check_collisions
        if v.lane_index is not None:
            arr["lane"][i] = net.global_lane_index(v.lane_index)
        tli = v.target_lane_index or v.lane_index
        arr["target_lane"][i] = net.global_lane_index(tli) if tli is not None else arr["lane"][i]
        if v.route:
            if len(v.route) > R:
                raise ValueError(f"route length {len(v.route)} > {R} slots")
            for j, (f, t, lid) in enumerate(v.route):
                arr["route_base"][i, j] = net.global_lane_index((f, t, 0))
                arr["route_n"][i, j] = len(net.lanes_on_edge(f, t))
                arr["route_id"][i, j] = -1 if lid is None else int(lid)
            arr["route_len"][i] = len(v.route)

    def device(name):
        x = arr[name]
        dtype = getattr(st, name).dtype
        x = x.astype(np.float32) if dtype == torch.float32 else x
        return torch.as_tensor(x[None]).to(dtype).to(env.device)

    return VehicleState(**{
        f.name: device(f.name) if f.name in arr else getattr(st, f.name).to(env.device)
        for f in dataclasses.fields(VehicleState)
    })


# --------------------------------------------------------------------------- #
# entry points
# --------------------------------------------------------------------------- #
_BUILDERS = {
    "HighwayEnv": _spawns_highway,
    "HighwayEnvFast": _spawns_highway,
    "MergeEnv": _spawns_merge,
    "RoundaboutEnv": _spawns_roundabout,
    "ParkingEnv": _spawns_parking,
    "TwoWayEnv": _spawns_two_way,
    "UTurnEnv": _spawns_u_turn,
    "ExitEnv": _spawns_exit,
    "RacetrackEnv": _spawns_racetrack,
    "RacetrackEnvOval": _spawns_racetrack_oval,
    "LaneKeepingEnv": _spawns_lane_keeping,
    "MergeGenericEnv": _spawns_merge_generic,
    "RoundaboutGenericEnv": _spawns_roundabout_generic,
}


def _is_intersection(env) -> bool:
    return any(cls.__name__ == "IntersectionEnv" for cls in type(env).__mro__)


def supports_seeded_reset(env) -> bool:
    """Whether the reference's seeded scene can be replayed: every env but
    the racetrack oval with a random layout (its layout generator is
    unseeded in the reference)."""
    for cls in type(env).__mro__:
        if cls.__name__ == "RacetrackEnvOval" and (
            not env.config.get("length") or not env.config.get("no_lanes")
        ):
            return False
        if cls.__name__ in _BUILDERS or cls.__name__ == "IntersectionEnv":
            return True
    return False


def _builder_for(env):
    for cls in type(env).__mro__:
        if cls.__name__ in _BUILDERS:
            return _BUILDERS[cls.__name__]
    return None


def generator_from(rng: np.random.Generator, device, generator=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (``generator`` itself, reseeded,
    where given) seeded from ``rng``'s PCG64 state modulo 2**31 - 1.  Reads
    the state and consumes no draw: a draw here would shift every later
    draw of the chained Gymnasium generator."""
    state = rng.bit_generator.state["state"]["state"]
    generator = generator if generator is not None else torch.Generator(device=device)
    return generator.manual_seed(int(state % (2**31 - 1)))


def seeded_reset_state(env, rng: np.random.Generator, generator=None):
    """The (B=1) EnvState of the reference's ``reset(seed)`` scene, of the
    env's own state type, from the replay generator ``rng``.  After the
    scene's draws ``generator_from(rng, ...)`` (reseeding ``generator`` where
    given) supplies the state's own draws (lane-keeping's noise) and, in the
    caller's hands, the episode's."""
    if _is_intersection(env):
        veh = _seeded_intersection_vehicles(env, rng)
    else:
        builder = _builder_for(env)
        if builder is None or not supports_seeded_reset(env):
            raise NotImplementedError(f"{type(env).__name__}: no seeded reset")
        veh = scene_to_state(env, builder(env, rng))
    generator = generator_from(rng, env.device, generator)
    return env._state_of(veh, env._state_draws(1, generator))


def seeded_reset(env, rng: np.random.Generator, generator=None):
    """(obs, EnvState) of ``seeded_reset_state``; a shuffled observation
    draws from the generator reseeded from ``rng`` (``generator`` itself,
    or a new one)."""
    generator = generator if generator is not None else torch.Generator(device=env.device)
    state = seeded_reset_state(env, rng, generator)
    return env._observe(state, generator), state


# the fields the reference's challenger sets on its slot
_CHALLENGER_FIELDS = ("pos heading speed lane target_lane target_speed timer delta kind "
                      "route_base route_n route_id route_ptr route_len").split()


def _seeded_intersection_vehicles(env, rng) -> VehicleState:
    """IntersectionEnv._make_vehicles' draw replay (reference
    envs/intersection_env.py): the initial spawns, the 3 s warm-up (no draws
    in the reference; ``env._warm_up``: one launch of K5 on CUDA), the
    challenger, then the controlled vehicles."""
    cfg = env.config
    net = env.net
    n_vehicles = cfg["initial_vehicle_count"]
    vehicles = []
    for t in range(n_vehicles - 1):
        # the initial population takes _spawn_vehicle's default probability
        # 0.6; the config's spawn_probability gates the episode's spawns
        _spawn_vehicle_intersection(env, rng, vehicles,
                                    longitudinal=float(np.linspace(0, 80, n_vehicles)[t]))
    if len(vehicles) > env._warmup_slots:
        raise ValueError(f"{len(vehicles)} initial vehicles > {env._warmup_slots} warm-up slots")
    veh = env._warm_up(scene_to_state(env, vehicles))

    def put(field, slot, value):
        field = field.clone()
        field[0, slot] = value
        return field

    # the challenger, its clearance read from the warmed-up positions
    pos_np, kind_np = veh.pos[0].cpu().numpy(), veh.kind[0].cpu().numpy()
    live = [HostVehicle(kind=int(k), position=p) for p, k in zip(pos_np, kind_np)
            if k != KIND_PAD]
    challenger = _spawn_vehicle_intersection(
        env, rng, live, longitudinal=60.0, position_deviation=0.1, speed_deviation=0.0,
        spawn_probability=1.0, go_straight=True,
    )
    if challenger is not None:
        slot = int(np.argmax(kind_np[: env._n_npc] == KIND_PAD))
        one = scene_to_state(env, [challenger])  # the challenger in slot 0
        veh = veh.replace(**{name: put(getattr(veh, name), slot, getattr(one, name)[0, 0])
                             for name in _CHALLENGER_FIELDS})

    # the controlled vehicles (draws: the destination's integers where the
    # config names none, then the station's normal)
    rb, rn, rid, rlen = env._routes
    for ego_id, slot in enumerate(env.ego_slots):
        corner = ego_id % 4
        lane_index = (f"o{corner}", f"ir{corner}", 0)
        lane = net.get_lane(lane_index)
        destination = cfg["destination"] or "o" + str(int(rng.integers(1, 4)))
        dest = int(destination[1:])
        s = 60.0 + 5.0 * float(rng.normal(1.0))
        pos = torch.as_tensor(np.asarray(lane.position(s, 0), np.float64).astype(np.float32),
                              device=env.device)
        glane = net.global_lane_index(lane_index)
        veh = veh.replace(
            pos=put(veh.pos, slot, pos),
            heading=put(veh.heading, slot, float(lane.heading_at(60.0))),
            speed=put(veh.speed, slot, float(lane.speed_limit)),
            lane=put(veh.lane, slot, glane),
            target_lane=put(veh.target_lane, slot, glane),
            kind=put(veh.kind, slot, KIND_EGO),
        )
        if hasattr(env.action_type, "target_speeds"):
            from highwayenv_tpu_torch.vehicle import controller

            si = controller.speed_to_index(veh.speed[:, slot], env.action_type.target_speeds)
            table = env.action_type.speed_table(env.device)
            veh = veh.replace(
                target_speed=put(veh.target_speed, slot, table[si.long()][0]),
                speed_index=put(veh.speed_index, slot, si[0]),
                route_base=put(veh.route_base, slot, rb[corner, dest]),
                route_n=put(veh.route_n, slot, rn[corner, dest]),
                route_id=put(veh.route_id, slot, rid[corner, dest]),
                route_len=put(veh.route_len, slot, rlen[corner, dest]),
            )
        # no NPC within 20 m of the ego (the reference's early-collision test)
        d = veh.pos - pos
        near = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) < 20.0
        drop = (veh.kind != KIND_PAD) & (veh.kind != KIND_EGO) & near
        veh = veh.replace(kind=torch.where(drop, KIND_PAD, veh.kind).to(torch.int32))
    return veh

