"""The port's general analytic-lane path against the JAX package, on the CPU.

Geometry (lane tables, local coordinates, positions, headings, closest
lanes, route arrays), lane following at lane ends, and whole policy steps
of ``ops/general_frames.py`` on roundabout-v0 (circular, sine and straight
lanes, routes) and merge-v0 (a forbidden ramp, a 3-lane edge, an
obstacle).  On CPU tensors ``simulate_general`` runs
``frames_general_plain``, the plain version of the CUDA kernel K4 (the
kernel itself is held against it on the card by chip_smoke.py); it is held
against the JAX XLA path ``env._simulate`` under ``jax.vmap`` (the general
``BaseEnv._frame``), over 3 policy steps resynced to the JAX state, as
tests/test_general_pallas.py holds the TPU kernel to it.

Tolerances: discrete fields and route arrays exact; pos, speed and heading
5e-4 absolute, the bound the JAX package holds its own K4 to XLA with; the
other continuous fields 1e-4 times their magnitude, as in
test_torch_straight_frames.py.  Geometry queries: 1e-4 absolute on
coordinates up to ~200 m (the two CPU libms' atan2 / sin differ by ~1 ulp).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import highwayenv_tpu as hj
import highwayenv_tpu_torch as ht
from highwayenv_tpu.road import lane as j_lane
from highwayenv_tpu.vehicle import controller as j_controller
from highwayenv_tpu_torch.bridge import from_numpy_state
from highwayenv_tpu_torch.ops import general_frames
from highwayenv_tpu_torch.road import lane as t_lane
from highwayenv_tpu_torch.vehicle import controller as t_controller
from highwayenv_tpu_torch.vehicle.state import VehicleState

torch.set_num_threads(1)

B = 8
STEPS = 3
ENV_IDS = ["roundabout-v0", "merge-v0"]
DISCRETE = ("lane", "target_lane", "route_ptr", "crashed", "hit",
            "impact_pending", "speed_index")
CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer", "impact",
              "steering", "accel")
STEP_ATOL = {"pos": 5e-4, "speed": 5e-4, "heading": 5e-4}
SCENES = {
    "roundabout-v0": ("reset", "wrap", "lane_end", "mid_change"),
    "merge-v0": ("reset", "lane_end", "obstacle"),
}
GEO_FIELDS = ("kind", "start", "end", "direction", "direction_lateral",
              "heading0", "amplitude", "pulsation", "phase", "center",
              "radius", "start_phase", "cw", "width", "length", "speed_limit",
              "forbidden", "priority", "from_node", "to_node", "lane_id",
              "edge_id", "edge_base", "edge_n", "succ_edge_base",
              "succ_edge_n", "pred_edge_base", "pred_edge_n")

_SETUP: dict = {}


def _setup(env_id):
    """JAX env, port env, a JAX reset batch and the jitted JAX policy step
    (``jax.vmap(env._simulate)``), built once per env so the L=32 XLA frame
    compiles once per test process."""
    if env_id not in _SETUP:
        ej = hj.make(env_id)
        et = ht.make(env_id, device="cpu")
        _, states = jax.jit(jax.vmap(ej._reset))(jax.random.split(jax.random.PRNGKey(5), B))

        def sim(st, acts):
            return jax.vmap(ej._simulate)(st, jax.vmap(ej._action_to_slots)(acts))

        _SETUP[env_id] = (ej, et, states, jax.jit(sim))
    return _SETUP[env_id]


def _numpy_state(states) -> dict:
    return {
        "vehicles": {
            f.name: np.asarray(getattr(states.vehicles, f.name))
            for f in dataclasses.fields(VehicleState)
        },
        "time": np.asarray(states.time),
        "steps": np.asarray(states.steps),
    }


def _with(states, **fields):
    """The JAX EnvState batch with vehicle fields replaced by numpy arrays."""
    return states.replace(vehicles=states.vehicles.replace(
        **{k: jnp.asarray(v) for k, v in fields.items()}
    ))


def _geo_table(geo, name):
    t = getattr(geo, name)
    return np.asarray(t.a if hasattr(t, "a") else t)


def _place(et, lane_index, s, lat=0.0):
    """(x, y, heading, global lane) of a point on a reference lane index."""
    g = et.net.global_lane_index(lane_index)
    lane = torch.tensor([g], dtype=torch.int32)
    s_t = torch.tensor([float(s)])
    pos = t_lane.position(et.geo, lane, s_t, torch.tensor([float(lat)]))[0]
    heading = t_lane.heading_at(et.geo, lane, s_t)[0]
    return float(pos[0]), float(pos[1]), float(heading), g


def _lane_length(et, lane_index):
    return float(et.geo.length[et.net.global_lane_index(lane_index)])


def _scene(env_id, name):
    """A JAX EnvState batch built from the reset batch for the named scene."""
    ej, et, states, _ = _setup(env_id)
    v = {k: np.array(a) for k, a in _numpy_state(states)["vehicles"].items()}
    pos, heading, lane = v["pos"], v["heading"], v["lane"]
    tlane, speed = v["target_lane"], v["speed"]

    def put(b, slot, lane_index, s, lat=0.0, target=None, spd=None):
        x, y, h, g = _place(et, lane_index, s, lat)
        pos[b, slot] = (x, y)
        heading[b, slot] = h
        lane[b, slot] = g
        tlane[b, slot] = g if target is None else et.net.global_lane_index(target)
        if spd is not None:
            speed[b, slot] = spd

    if name == "reset":
        return states
    if name == "wrap":
        # the four NPCs around the +/-pi point of the ring, the middle of
        # arc wx -> we (-156 to -204 degrees), on both lanes and off centre
        for b in range(B):
            for k, slot in enumerate(range(1, 5)):
                lane_index = ("wx", "we", k % 2)
                mid = _lane_length(et, lane_index) / 2
                put(b, slot, lane_index, mid + (k - 1.5) * 1.0e-3 * (b + 1),
                    lat=0.3 * (b - 3.5) / 3.5, spd=8.0)
    elif name == "lane_end":
        # every vehicle 1.5 m from the end of its target lane: row 0 pops its
        # route head and follows the route, row 1 sits at the end of its
        # route, row 2 has none (free choice among successor edges), the
        # other rows add lateral offsets
        R = v["route_len"]
        for b in range(B):
            for slot in range(5):
                g = int(tlane[b, slot])
                lane_index = et.net.lane_index_from_global(g)
                s = _lane_length(et, lane_index) - 1.5
                put(b, slot, lane_index, s, lat=0.4 * (b - 4) if b > 2 else 0.0)
        v["route_ptr"][1] = R[1]
        R[2] = 0
    elif name == "mid_change":
        # slots 1 and 2 both change from ring lane 0 to lane 1 of se -> ex,
        # slot 2 ahead: slot 1 aborts; slot 3 changes lanes at the end of
        # ex -> ee, so follow_road moves its target to the next edge while it
        # is mid-change and the target-lane IDM query runs on that edge
        for b in range(B):
            put(b, 1, ("se", "ex", 0), 10.0, target=("se", "ex", 1), spd=8.0)
            put(b, 2, ("se", "ex", 0), 14.0 + 0.5 * b, target=("se", "ex", 1),
                spd=6.0)
            end = _lane_length(et, ("ex", "ee", 0)) - 1.0
            put(b, 3, ("ex", "ee", 0), end, target=("ex", "ee", 1), spd=8.0)
            v["timer"][b, 1:4] = 0.0
    elif name == "obstacle":
        # the ramp vehicle 7 m behind the end-of-ramp obstacle at 15 m/s;
        # slot 1 closing on the ego from behind at 40 m/s
        for b in range(B):
            ox, oy = pos[b, 5]
            pos[b, 4] = (ox - 7.0 - 0.5 * b, oy)
            heading[b, 4] = 0.0
            speed[b, 4] = 15.0
            g = et.net.global_lane_index(("b", "c", 2))
            lane[b, 4] = tlane[b, 4] = g
            pos[b, 1] = (pos[b, 0, 0] - 6.0, pos[b, 0, 1])
            heading[b, 1] = 0.0
            speed[b, 1] = 40.0
            lane[b, 1] = tlane[b, 1] = lane[b, 0]
    else:
        raise ValueError(name)
    return _with(states, **v)


def _assert_close(port, ref, where):
    for name in DISCRETE:
        np.testing.assert_array_equal(
            getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
            err_msg=f"{where}: {name}",
        )
    for name in CONTINUOUS:
        a = getattr(port, name).numpy().astype(np.float64)
        b = np.asarray(getattr(ref, name)).astype(np.float64)
        tol = STEP_ATOL.get(name, 1e-4 * max(1.0, float(np.abs(b).max())))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=f"{where}: {name}")


def _steps(env_id, scene):
    """Yield (step, port, JAX) vehicle states over STEPS policy steps, each
    step taken by both from the same JAX state.

    The roundabout ego never brakes (no SLOWER): from 8 m/s that action
    sets the target speed 0, and below ~0.5 m/s the steering law divides by
    the speed, so a 1-ulp difference between the two CPU libms grows ~4x a
    frame and passes 5e-4 m within a policy step.  That regime is held to
    JAX frame by frame in test_braking_to_a_stop_matches_jax_frame_by_frame."""
    ej, et, _, sim = _setup(env_id)
    sj = _scene(env_id, scene)
    rng = np.random.default_rng(9)
    n_actions = 4 if env_id == "roundabout-v0" else et.action_type.n
    for t in range(STEPS):
        acts = rng.integers(0, n_actions, B).astype(np.int32)
        veh_t = from_numpy_state(_numpy_state(sj)).vehicles
        veh_t = general_frames.simulate_general(
            et, veh_t, et._action_to_slots(torch.from_numpy(acts)),
            et.frames_per_step,
        )
        sj = sim(sj, jnp.asarray(acts))
        yield t, veh_t, sj.vehicles


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_lane_tables_match_jax(env_id):
    ej, et, _, _ = _setup(env_id)
    assert et.geo.all_straight is False
    for name in GEO_FIELDS:
        np.testing.assert_array_equal(
            getattr(et.geo, name).numpy(), _geo_table(ej.geo, name), err_msg=name
        )


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_lane_queries_match_jax(env_id):
    """local_coordinates, position, heading_at and closest_lane on seeded
    points of every lane, plus (roundabout) points straddling the +/-pi
    line of the ring, where atan2 changes sign."""
    ej, et, _, _ = _setup(env_id)
    rng = np.random.default_rng(3)
    L = et.geo.num_lanes
    n = 64
    lanes = rng.integers(0, L, n).astype(np.int32)
    length = et.geo.length.numpy()[lanes]
    s = (rng.uniform(-0.1, 1.1, n) * length).astype(np.float32)
    lat = rng.uniform(-6.0, 6.0, n).astype(np.float32)
    pos_j = np.asarray(j_lane.position(ej.geo, jnp.asarray(lanes), jnp.asarray(s),
                                       jnp.asarray(lat)))
    pos_t = t_lane.position(et.geo, torch.from_numpy(lanes), torch.from_numpy(s),
                            torch.from_numpy(lat)).numpy()
    np.testing.assert_allclose(pos_t, pos_j, rtol=0, atol=1e-4)
    h_j = np.asarray(j_lane.heading_at(ej.geo, jnp.asarray(lanes), jnp.asarray(s)))
    h_t = t_lane.heading_at(et.geo, torch.from_numpy(lanes), torch.from_numpy(s))
    np.testing.assert_allclose(h_t.numpy(), h_j, rtol=0, atol=1e-5)

    pts = pos_j.astype(np.float32)
    if env_id == "roundabout-v0":
        eps = np.array([0.0, 1e-6, -1e-6, 1e-3, -1e-3, 0.05], np.float32)
        wrap = np.stack([np.array([-r, y], np.float32) for r in (18.0, 20.0, 22.0, 24.0)
                         for y in eps])
        pts = np.concatenate([pts, wrap])
    m = len(pts)
    heading = rng.uniform(-np.pi, np.pi, m).astype(np.float32)
    q_lanes = np.arange(m).astype(np.int32) % L
    s_j, lat_j = j_lane.local_coordinates(ej.geo, jnp.asarray(q_lanes), jnp.asarray(pts))
    s_t, lat_t = t_lane.local_coordinates(et.geo, torch.from_numpy(q_lanes),
                                          torch.from_numpy(pts))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(lat_t.numpy(), np.asarray(lat_j), rtol=0, atol=1e-4)
    # the projection table of every point on every lane, and the closest lane
    tab_j = j_lane.projection_table(ej.geo, jnp.asarray(pts))
    tab_t = t_lane.projection_table(et.geo, torch.from_numpy(pts))
    for a, b in zip(tab_t, tab_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(
        t_lane.closest_lane(et.geo, torch.from_numpy(pts), torch.from_numpy(heading)).numpy(),
        np.asarray(j_lane.closest_lane(ej.geo, jnp.asarray(pts), jnp.asarray(heading))),
    )


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_network_queries_match_jax(env_id):
    """The host-side queries of the scenario resets: lanes per edge, global
    lane indices both ways, node ids and BFS paths between every pair of
    nodes, exactly."""
    ej, et, _, _ = _setup(env_id)
    nj, nt = ej.net, et.net
    assert list(nt.edges) == list(nj.edges)
    nodes = sorted({n for edge in nt.edges for n in edge})
    for f, t in nt.edges:
        assert len(nt.lanes_on_edge(f, t)) == len(nj.lanes_on_edge(f, t))
        for i in range(len(nt.lanes_on_edge(f, t))):
            g = nt.global_lane_index((f, t, i))
            assert g == nj.global_lane_index((f, t, i))
            assert nt.lane_index_from_global(g) == nj.lane_index_from_global(g) == (f, t, i)
    for a in nodes:
        assert nt.node_id(a) == nj.node_id(a)
        for b in nodes:
            assert nt.bfs_shortest_path(a, b) == nj.bfs_shortest_path(a, b), (a, b)


def test_roundabout_route_arrays_match_jax():
    """All 4 x 3 NPC routes and the ego route, exactly."""
    ej, et, _, _ = _setup("roundabout-v0")
    rb, rn, rid, rlen = ej._npc_routes
    npc = et._npc_routes.numpy()
    np.testing.assert_array_equal(npc[:, :, 0], rb)
    np.testing.assert_array_equal(npc[:, :, 1], rn)
    np.testing.assert_array_equal(npc[:, :, 2], rid)
    np.testing.assert_array_equal(et._npc_route_len.numpy(), rlen)
    erb, ern, erid, erlen = ej._ego_route
    np.testing.assert_array_equal(et._ego_route.numpy(), np.stack([erb, ern, erid]))
    assert et._ego_route_len == int(erlen)
    assert rlen.max() == et.route_slots  # the longest route fills every slot


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_follow_road_at_lane_ends_matches_jax(env_id):
    """follow_road / next_lane on the lane-end scene: route pop and follow,
    route end, no route (the free choice among successor edges), and onto
    edges with other lane counts (closest lane)."""
    ej, et, _, _ = _setup(env_id)
    sj = _scene(env_id, "lane_end")
    veh_j = sj.vehicles

    def one(v):
        table_s, _ = j_lane.projection_table(ej.geo, v.pos)
        return j_controller.follow_road(ej.geo, v, ej.max_edge_lanes, table_s)

    out_j = jax.jit(jax.vmap(one))(veh_j)
    veh_t = from_numpy_state(_numpy_state(sj)).vehicles
    table_s, _ = t_lane.projection_table(et.geo, veh_t.pos)
    out_t = t_controller.follow_road(et.geo, veh_t, et.max_edge_lanes, table_s)
    np.testing.assert_array_equal(out_t.target_lane.numpy(), np.asarray(out_j.target_lane))
    np.testing.assert_array_equal(out_t.route_ptr.numpy(), np.asarray(out_j.route_ptr))
    moved = out_t.target_lane != veh_t.target_lane
    assert bool(moved.any())  # lanes ended and were followed
    if env_id == "roundabout-v0":
        assert bool((out_t.route_ptr != veh_t.route_ptr).any())  # routes popped


@pytest.mark.parametrize(
    "env_id,scene", [(e, s) for e in ENV_IDS for s in SCENES[e]]
)
def test_general_frames_match_jax(env_id, scene):
    crashed_any = False
    for t, veh_t, veh_j in _steps(env_id, scene):
        _assert_close(veh_t, veh_j, f"{env_id} {scene} step {t}")
        crashed_any |= bool(veh_t.crashed.any())
    if scene == "obstacle":
        assert crashed_any  # the obstacle was hit


def test_braking_to_a_stop_matches_jax_frame_by_frame():
    """The roundabout ego brakes to its target speed 0 over two policy
    steps: each frame is taken by both from the same JAX state (the frame
    and its projection table), so the steering law's 1 / speed
    amplification of rounding cannot compound."""
    ej, et, states, _ = _setup("roundabout-v0")
    frame_j = jax.jit(jax.vmap(ej._frame, in_axes=(0, 0, 0, None)))
    acts = np.full(B, 4, np.int32)  # SLOWER: target speed 8 -> 0
    sa_j = jax.vmap(ej._action_to_slots)(jnp.asarray(acts))
    sa_t = et._action_to_slots(torch.from_numpy(acts))
    veh_j = states.vehicles
    for f in range(2 * et.frames_per_step):
        first = f % et.frames_per_step == 0
        tab_j = jax.vmap(lambda v: j_lane.projection_table(ej.geo, v.pos))(veh_j)
        veh_t = from_numpy_state(_numpy_state(states.replace(vehicles=veh_j))).vehicles
        tab_t = t_lane.projection_table(et.geo, veh_t.pos)
        veh_t, _ = general_frames.frame_general_plain(
            veh_t, et._general, tab_t, sa_t if first else None
        )
        veh_j, _ = frame_j(veh_j, tab_j, sa_j, first)
        _assert_close(veh_t, veh_j, f"frame {f}")
    assert float(veh_t.speed[:, 0].max()) < 0.5  # the ego creeps


def test_kernel_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    _, et, states, _ = _setup("roundabout-v0")
    veh = from_numpy_state(_numpy_state(states)).vehicles
    sa = et._action_to_slots(torch.full((B,), 3, dtype=torch.int32))
    before = general_frames.frames_general_kernel.launches
    out_k = general_frames.frames_general_kernel(veh, et._general, sa, 2)
    out_p = general_frames.frames_general_plain(veh, et._general, sa, 2)
    assert general_frames.frames_general_kernel.launches == before
    for name, _, _ in general_frames.OUT_FIELDS:
        assert torch.equal(getattr(out_k, name), getattr(out_p, name)), name


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_kernel_lane_tables_hold_the_geometry(env_id):
    """The CUDA kernel's lane tables: one row per lane, columns in the order
    the kernel reads them, successor slots padded with -1 to the fixed
    layout's (the layout of these networks), then the priority."""
    _, et, _, _ = _setup(env_id)
    geo = et.geo
    lf, li = general_frames.lane_tables(geo, "cpu")
    L = geo.num_lanes
    F = general_frames.FIXED_SUCC
    assert lf.shape == (L, general_frames.LANE_F_WORDS) and lf.dtype == torch.float32
    assert li.shape == (L, general_frames.lane_i_words(F, False)) == (L, 16)
    assert li.dtype == torch.int32
    cols = dict(zip(general_frames._LANE_F, lf.T))
    assert torch.equal(cols["sx"], geo.start[:, 0]) and torch.equal(cols["ny"], geo.direction_lateral[:, 1])
    assert torch.equal(cols["cy"], geo.center[:, 1]) and torch.equal(cols["speed_limit"], geo.speed_limit)
    icols = dict(zip(general_frames._LANE_I, li.T))
    assert torch.equal(icols["edge_base"], geo.edge_base) and torch.equal(icols["to_node"], geo.to_node)
    n = len(general_frames._LANE_I)
    S = geo.succ_edge_base.shape[1]
    assert torch.equal(li[:, n:n + S], geo.succ_edge_base)
    assert (li[:, n + S:n + F] == -1).all()
    assert torch.equal(li[:, n + F:n + F + S], geo.succ_edge_n)
    assert torch.equal(li[:, general_frames.LANE_I_PRIORITY], geo.priority.to(torch.int32))


def report():
    """Print the largest |port - JAX| of each continuous field over every
    env, scene and step of test_general_frames_match_jax."""
    worst = {n: 0.0 for n in CONTINUOUS}
    for env_id in ENV_IDS:
        for scene in SCENES[env_id]:
            for _, veh_t, veh_j in _steps(env_id, scene):
                for n in CONTINUOUS:
                    err = np.abs(getattr(veh_t, n).numpy().astype(np.float64)
                                 - np.asarray(getattr(veh_j, n), np.float64)).max()
                    worst[n] = max(worst[n], float(err))
    for n, err in worst.items():
        print(f"max |port - JAX XLA| {n}: {err:.3e}")


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_general.py (JAX on the CPU)
    jax.config.update("jax_platforms", "cpu")
    report()
