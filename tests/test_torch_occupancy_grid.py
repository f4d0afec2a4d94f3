"""The OccupancyGrid observation in the port against the JAX package, on the
CPU.

The same states (JAX reset batches carried across, and a compressed highway
scene that puts several vehicles in one cell) go through the JAX
``OccupancyGridObservation.observe`` (vmapped) and the port's batched
``observe``: the racetrack configuration (presence and on_road, a 12 x 12
grid of 3 m aligned to the ego's axes) and the default one (presence, vx,
vy, on_road on 11 x 11 cells of 5 m), aligned and unaligned, plus the other
features, the normalization ranges, ``clip=False`` and ``as_image``.

Cells must be exactly equal, except where a vehicle or a lane waypoint lies
within 1e-4 m of a cell edge: there the two packages' float32 rotations and
lane positions (about 1e-5 m apart at 100 m) may put it on either side.  The
test finds those points, counts them and the cells that differ, prints
both, and holds every differing cell to one such point's cells.
"""

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import highwayenv_tpu as hj
import highwayenv_tpu_torch as ht
from highwayenv_tpu.observations.occupancy_grid import (
    OccupancyGridObservation as JGrid,
)
from highwayenv_tpu_torch.bridge import from_numpy_state
from highwayenv_tpu_torch.observations.occupancy_grid import (
    LANE_PERCEPTION_DISTANCE,
    OccupancyGridObservation as TGrid,
)
from highwayenv_tpu_torch.road import lane as t_lane
from highwayenv_tpu_torch.vehicle.state import VehicleState

torch.set_num_threads(1)

B = 16
EDGE_M = 1e-4
RACETRACK_OBS = {
    "features": ["presence", "on_road"],
    "grid_size": [[-18, 18], [-18, 18]],
    "grid_step": [3, 3],
    "as_image": False,
    "align_to_vehicle_axes": True,
}
CASES = {
    # (env id, scene, observation config)
    "racetrack": ("racetrack-v0", "reset", RACETRACK_OBS),
    "racetrack-large": ("racetrack-large-v0", "reset", RACETRACK_OBS),
    "racetrack-oval-blocks": ("racetrack-oval-v0", "reset", RACETRACK_OBS),
    "default-unaligned": ("highway-v0", "compressed", {}),
    "default-aligned": ("racetrack-v0", "turned", {"align_to_vehicle_axes": True}),
    "features-image": ("highway-v0", "compressed", {
        "features": ["presence", "x", "y", "vx", "vy", "on_road"],
        "features_range": {"x": [-50, 50], "y": [-20, 20], "vx": [-20, 20],
                           "vy": [-20, 20]},
        "as_image": True,
    }),
    "no-clip": ("highway-v0", "compressed", {
        "features": ["presence", "x", "vx"], "features_range": {"x": [-5, 5]},
        "clip": False, "align_to_vehicle_axes": True,
    }),
}
_STATES: dict = {}


def _numpy_state(states) -> dict:
    return {
        "vehicles": {
            f.name: np.asarray(getattr(states.vehicles, f.name))
            for f in dataclasses.fields(VehicleState)
        },
        "time": np.asarray(states.time),
        "steps": np.asarray(states.steps),
    }


def _scene(env_id, scene):
    """(JAX env, port env, JAX vehicles, port vehicles) of a scene: a JAX
    reset batch; 'compressed' with every x * 0.2 (vehicles share cells);
    'turned' with the headings turned by seeded angles and the NPC moved
    beside the ego."""
    key = (env_id, scene)
    if key not in _STATES:
        config = {"block_lane": True} if env_id == "racetrack-oval-v0" else None
        ej, et = hj.make(env_id, config), ht.make(env_id, config, device="cpu")
        _, sj = jax.jit(jax.vmap(ej._reset))(jax.random.split(jax.random.PRNGKey(7), B))
        d = _numpy_state(sj)
        v = {k: np.array(a) for k, a in d["vehicles"].items()}
        rng = np.random.default_rng(5)
        if scene == "compressed":
            v["pos"][..., 0] *= 0.2
        elif scene == "turned":
            v["heading"] += rng.uniform(-np.pi, np.pi, v["heading"].shape).astype(np.float32)
            v["pos"][:, 1] = v["pos"][:, 0] + rng.uniform(-15, 15, (B, 2)).astype(np.float32)
        vj = sj.vehicles.replace(**{k: jnp.asarray(a) for k, a in v.items()})
        vt = from_numpy_state(dict(d, vehicles=v)).vehicles
        _STATES[key] = (ej, et, vj, vt)
    return _STATES[key]


def _cells_near_edges(grid: TGrid, geo, veh, ego: int) -> tuple[np.ndarray, int]:
    """(B, W * H) cells a point within EDGE_M of a cell edge may fall in,
    in float64 from the port's float32 inputs, and the count of such
    points: the vehicles, and the lane waypoints where on_road is
    observed."""
    W, H = grid.grid_shape
    lo = grid.grid_size[:, 0].astype(np.float64)
    step = grid.grid_step.astype(np.float64)
    pos = veh.pos.numpy().astype(np.float64)
    ego_pos = pos[:, ego]
    h = veh.heading.numpy().astype(np.float64)[:, ego]
    points = [np.where(veh.is_vehicle.numpy()[..., None], pos - ego_pos[:, None], np.nan)]
    if "on_road" in grid.features:
        L = geo.num_lanes
        lanes = torch.arange(L, dtype=torch.int32)
        spacing = float(np.amin(grid.grid_step))
        n_wp = int(math.ceil(2 * LANE_PERCEPTION_DISTANCE / spacing))
        origin, _ = t_lane.local_coordinates(geo, lanes, veh.pos[:, ego][:, None, :])
        s = origin[..., None] - LANE_PERCEPTION_DISTANCE + torch.arange(n_wp) * spacing
        s = torch.minimum(s.clamp(min=0.0), geo.length[:, None])
        wp = t_lane.position(geo, lanes[:, None], s, torch.zeros_like(s)).numpy()
        points.append(wp.reshape(B, -1, 2).astype(np.float64) - ego_pos[:, None])
    rel = np.concatenate(points, axis=1)  # (B, K, 2)
    x, y = rel[..., 0], rel[..., 1]
    if grid.align_to_vehicle_axes:
        c, s_ = np.cos(h)[:, None], np.sin(h)[:, None]
        x, y = c * x + s_ * y, -s_ * x + c * y
    u, w = (x - lo[0]) / step[0], (y - lo[1]) / step[1]
    near = (np.abs(u - np.round(u)) * step[0] < EDGE_M) | (
        np.abs(w - np.round(w)) * step[1] < EDGE_M)
    cells = np.zeros((B, W * H + 1), bool)
    for dx in (-EDGE_M, 0.0, EDGE_M):
        for dy in (-EDGE_M, 0.0, EDGE_M):
            ci = np.floor((x + dx - lo[0]) / step[0])
            cj = np.floor((y + dy - lo[1]) / step[1])
            ok = near & (0 <= ci) & (ci < W) & (0 <= cj) & (cj < H)
            flat = np.where(ok, ci * H + cj, W * H).astype(np.int64)
            np.put_along_axis(cells, flat, True, axis=1)
    return cells[:, : W * H], int(near.sum())


@pytest.mark.parametrize("case", CASES)
def test_occupancy_grid_matches_jax(case):
    env_id, scene, cfg = CASES[case]
    ej, et, vj, vt = _scene(env_id, scene)
    grid_t, grid_j = TGrid(**cfg), JGrid(**cfg)
    assert grid_t.shape == grid_j.shape and grid_t.space() == grid_j.space()
    ego = 0
    obs_j = np.asarray(jax.vmap(lambda v: grid_j.observe(ej.geo, v, ego))(vj))
    obs_t = grid_t.observe(et.geo, vt, ego).numpy()
    assert obs_t.dtype == obs_j.dtype and obs_t.shape == (B,) + grid_t.shape

    W, H = grid_t.grid_shape
    differ = (obs_t != obs_j).reshape(B, -1, W * H).any(axis=1)
    allowed, n_near = _cells_near_edges(grid_t, et.geo, vt, ego)
    print(f"{case}: {n_near} points within {EDGE_M} m of a cell edge, "
          f"{int(differ.sum())} of {B * W * H} cells differ")
    assert not (differ & ~allowed).any(), (
        f"{int((differ & ~allowed).sum())} cells differ away from every cell edge")
    # the scenes observe something: at least the ego's cell, and road
    assert (obs_t[:, 0] != 0).sum() >= B
    if "on_road" in grid_t.features:
        assert obs_t[:, grid_t.features.index("on_road")].sum() > B


def test_first_vehicle_wins_a_shared_cell():
    """Slots 1 and 2 in one cell ahead of the ego (5 m cells), slot 3 in
    the next, at distinct speeds: the shared cell shows the lower slot's
    relative speed, as the reference's reversed fill leaves it."""
    ej, et, vj, vt = _scene("highway-v0", "compressed")
    grid_t, grid_j = TGrid(features=["vx"]), JGrid(features=["vx"])
    v = {f.name: getattr(vt, f.name).clone() for f in dataclasses.fields(VehicleState)}
    v["pos"][:, 1:4] = v["pos"][:, :1] + torch.tensor([[6.0, 0.3], [7.0, 0.6], [8.0, 0.9]])
    v["speed"][:, 1:4] = torch.tensor([10.0, 20.0, 30.0])
    v["heading"][:, :4] = 0.0
    veh = VehicleState(**v)
    obs_t = grid_t.observe(et.geo, veh, 0).numpy()
    obs_j = np.asarray(jax.vmap(lambda x: grid_j.observe(ej.geo, x, 0))(
        vj.replace(**{k: jnp.asarray(t.numpy()) for k, t in v.items()})))
    np.testing.assert_array_equal(obs_t, obs_j)
    W, H = grid_t.grid_shape
    rel = ((veh.speed[:, 1:4] - veh.speed[:, :1]) / 80.0).numpy()
    np.testing.assert_array_equal(obs_t[:, 0, W // 2 + 1, H // 2], rel[:, 0])
    np.testing.assert_array_equal(obs_t[:, 0, W // 2 + 2, H // 2], rel[:, 2])


def test_absolute_grid_is_refused():
    with pytest.raises(NotImplementedError, match="absolute"):
        TGrid(absolute=True)
    with pytest.raises(NotImplementedError, match="absolute"):
        ht.make("racetrack-v0", {"observation": dict(RACETRACK_OBS, type="OccupancyGrid",
                                                     absolute=True)}, device="cpu")
