"""The time-to-collision grid, two-way-v0 and u-turn-v0 in the port against
the JAX package, on the CPU.

The grid (``observations/ttc.py``) and the observation window are held to
the JAX package's on the same states.  Their cells are 0, 0.5 or 1 and
must be equal, except any cell that a time to collision within 1e-4 s of
a cell boundary (in the JAX state) reaches: floor and ceil there may move
by one cell under a one-ulp difference.  The tests count and print those
cells.

One ``step_autoreset_batched`` of the port from a JAX reset batch carried
across with the same actions: obs, reward, terminated, truncated, info
and the state of the rows that go on match the JAX step (the XLA general
frame on the CPU; ``step_batched``, whose kept rows are those of
``step_autoreset_batched``, so that the JAX reset is not compiled into the
step); the done rows equal the port's own ``_reset`` drawn from a clone
of the step's generator.  Tolerances: discrete fields exact, pos 2e-4 m,
other continuous state 1e-4 of its magnitude, obs and reward 1e-5.

Then ``connectivity_matrix`` against the JAX one on all five envs of the
slice, the resets' invariants and seeded two-sample tests of their draws,
the compact autoreset against the full one, the rollout and the vector
env.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy import stats

import highwayenv_tpu as hj
import highwayenv_tpu_torch as ht
from highwayenv_tpu.observations import ttc as j_ttc
from highwayenv_tpu.road import lane as j_lane
from highwayenv_tpu_torch.bridge import from_numpy_state
from highwayenv_tpu_torch.envs.base import EnvState
from highwayenv_tpu_torch.observations import ttc as t_ttc
from highwayenv_tpu_torch.ops import general_frames
from highwayenv_tpu_torch.parallel.rollout import rollout
from highwayenv_tpu_torch.road import lane as t_lane
from highwayenv_tpu_torch.vehicle.state import KIND_EGO, KIND_IDM, VehicleState

torch.set_num_threads(1)

B = 8
N_RESET = 256
TTC_IDS = ["two-way-v0", "u-turn-v0"]
SLICE_IDS = ["two-way-v0", "u-turn-v0", "exit-v0", "merge-generic-v0",
             "roundabout-generic-v0"]
STATE_DISCRETE = ("lane", "target_lane", "crashed", "hit", "impact_pending",
                  "speed_index", "kind", "route_ptr")
STATE_CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer",
                    "impact", "steering", "accel")
HEAD_ATOL = 1e-5
#: a time to collision this close to a cell boundary [s] may land either side
BOUNDARY = 1e-4
CASES = {
    "two-way-v0": ("crashed_ego", "step_limit"),
    "u-turn-v0": ("crashed_ego", "near_duration"),
}

_SETUP: dict = {}


def _numpy_state(states) -> dict:
    return {
        "vehicles": {
            f.name: np.asarray(getattr(states.vehicles, f.name))
            for f in dataclasses.fields(VehicleState)
        },
        "time": np.asarray(states.time),
        "steps": np.asarray(states.steps),
    }


def _setup(env_id):
    """JAX env, port env, N_RESET JAX resets and the jitted JAX step, built
    once per env so each compiles once per test process."""
    if env_id not in _SETUP:
        ej = hj.make(env_id)
        et = ht.make(env_id, device="cpu")
        _, states = jax.jit(jax.vmap(ej._reset))(
            jax.random.split(jax.random.PRNGKey(3), N_RESET)
        )
        _SETUP[env_id] = (ej, et, states, jax.jit(ej.step_batched))
    return _SETUP[env_id]


def _first(states, n=B):
    return jax.tree.map(lambda x: x[:n], states)


def _ending(states, et, case):
    """Rows 0, 2, 4 and 6 end this step: a crashed ego, the last step of
    two-way's 15-step limit, or one policy step left before u-turn's
    ``duration``."""
    ending = np.arange(B) % 2 == 0
    veh = states.vehicles
    if case == "crashed_ego":
        crashed = np.asarray(veh.crashed).copy()
        crashed[ending, 0] = True
        return states.replace(vehicles=veh.replace(crashed=jnp.asarray(crashed)))
    if case == "step_limit":
        steps = np.asarray(states.steps).copy()
        steps[ending] = (et.config["max_episode_steps"] - 1) * et.frames_per_step
        return states.replace(steps=jnp.asarray(steps))
    time = np.asarray(states.time).copy()
    time[ending] = et.config["duration"] - 1.0 / et.config["policy_frequency"]
    return states.replace(time=jnp.asarray(time))


def _close(a, b, atol, where):
    np.testing.assert_allclose(
        np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=0,
        atol=atol, err_msg=where,
    )


def _boundary_cells(ej, veh, ego=0):
    """(N, S, Lg, T) bool: the grid cells that a time to collision of the
    JAX state ``veh`` within BOUNDARY of a cell boundary reaches (the
    boundary's cell and both neighbours), in float64."""
    geo = ej.geo
    tq = 1.0 / ej.config["policy_frequency"]
    T = int(ej.observation_type.horizon / tq)
    Lg = ej.ttc_grid_lanes
    speeds = np.asarray(ej.action_type.target_speeds, np.float64)
    lane = np.asarray(veh.lane)
    N, V = lane.shape
    ego_lane = lane[:, ego]
    s_all = np.asarray(j_lane.local_coordinates(
        geo, jnp.asarray(ego_lane)[:, None], veh.pos)[0], np.float64)
    dist0 = s_all - s_all[:, ego : ego + 1]
    head = np.asarray(veh.heading, np.float64)
    proj = np.asarray(veh.speed, np.float64) * np.cos(head - head[:, ego : ego + 1])
    edge_n, lane_id = np.asarray(geo.edge_n), np.asarray(geo.lane_id)
    same = edge_n[lane] == edge_n[ego_lane][:, None]
    lane_mask = (lane_id[lane][..., None] == np.arange(Lg)) | ~same[..., None]
    conn = np.asarray(ej.connected3)[ego_lane[:, None], lane]
    valid = np.asarray(veh.is_vehicle) & (np.arange(V) != ego) & conn
    length = np.asarray(veh.length, np.float64)
    margin = length[:, ego : ego + 1] / 2 + length / 2
    rel = speeds[None, :, None] - proj[:, None, :]
    rel_nz = np.where(np.abs(rel) > 1e-2, rel, np.where(rel >= 0, 1e-2, -1e-2))
    out = np.zeros((N, len(speeds), Lg, T), bool)
    for m_sign in (0.0, -1.0, 1.0):
        ttc = (dist0 + m_sign * margin)[:, None, :] / rel_nz  # (N, S, V)
        k = np.round(ttc / tq)
        near = valid[:, None, :] & (ttc >= -BOUNDARY) & (np.abs(ttc - k * tq) < BOUNDARY)
        for n, s, v in zip(*np.nonzero(near)):
            lo, hi = int(max(k[n, s, v] - 1, 0)), int(min(k[n, s, v] + 1, T - 1))
            if lo <= hi:
                out[n, s, lane_mask[n, v], lo : hi + 1] = True
    return out


def _boundary_obs(ej, veh, ego=0):
    """The observation window's cells that ``_boundary_cells`` reaches."""
    cells = torch.from_numpy(_boundary_cells(ej, veh, ego)).float()
    S, Lg = cells.shape[1], cells.shape[2]
    geo = ej.geo
    lane_id = torch.from_numpy(np.asarray(geo.lane_id)[np.asarray(veh.lane)[:, ego]])
    pad = torch.zeros_like(cells)
    lanes3 = t_ttc._window(torch.cat([pad, cells, pad], dim=2), Lg + lane_id - 1, 2)
    speed_index = torch.from_numpy(np.array(veh.speed_index)[:, ego])
    edges = torch.cat([lanes3[:, :1].expand(-1, S, -1, -1), lanes3,
                       lanes3[:, -1:].expand(-1, S, -1, -1)], dim=1)
    return t_ttc._window(edges, S + speed_index - 1, 1).numpy() > 0


def _assert_cells(a, b, exempt, where):
    """Equal cells outside ``exempt``; prints how many were exempt."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape == exempt.shape, where
    np.testing.assert_array_equal(a[~exempt], b[~exempt], err_msg=where)
    print(f"{where}: {int(exempt.sum())} of {exempt.size} cells within "
          f"{BOUNDARY} s of a boundary; {int((a != b).sum())} differ")


@pytest.mark.parametrize("env_id", SLICE_IDS)
def test_connectivity_matrix_matches_jax(env_id):
    ej, et = hj.make(env_id), ht.make(env_id, device="cpu")
    for depth, same_lane in ((3, False), (1, True)):
        np.testing.assert_array_equal(
            et.net.connectivity_matrix(depth, same_lane),
            ej.net.connectivity_matrix(depth, same_lane),
        )
    if env_id in TTC_IDS:
        np.testing.assert_array_equal(et.connected3, ej.connected3)


@pytest.mark.parametrize("env_id", TTC_IDS)
def test_ttc_grid_and_window_match_jax(env_id):
    """The grid and the observation on N_RESET JAX reset scenes, and on the
    same scenes with the ego at every speed index and with its lane moved
    to the other lane of its edge."""
    ej, et, states, _ = _setup(env_id)
    veh_j = states.vehicles
    speeds = np.asarray(ej.action_type.target_speeds, np.float32)
    tq = 1.0 / ej.config["policy_frequency"]
    horizon = float(ej.observation_type.horizon)
    grid_j = jax.jit(jax.vmap(lambda v: j_ttc.compute_ttc_grid(
        ej.geo, v, 0, speeds, ej.connected3, ej.ttc_grid_lanes, tq, horizon)))(veh_j)
    veh_t = from_numpy_state(_numpy_state(states)).vehicles
    grid_t = t_ttc.compute_ttc_grid(
        et.geo, veh_t, 0, torch.from_numpy(speeds), torch.from_numpy(et.connected3),
        et.ttc_grid_lanes, tq, horizon)
    assert grid_t.shape == (N_RESET, len(speeds), 2, int(horizon / tq))
    assert set(np.unique(grid_t.numpy())) <= {0.0, 0.5, 1.0}
    assert (grid_t > 0).any()
    _assert_cells(grid_t, grid_j, _boundary_cells(ej, veh_j), f"{env_id} grid")

    observe_j = jax.jit(jax.vmap(lambda v: ej.observation_type.observe(ej.geo, v, 0)))
    lane = np.asarray(veh_j.lane).copy()
    base = np.asarray(ej.geo.edge_base)[lane[:, 0]]
    other = base + (1 - np.asarray(ej.geo.lane_id)[lane[:, 0]])
    for idx in range(len(speeds)):
        for ego_lane in (lane[:, 0], other):
            lane[:, 0] = ego_lane
            si = np.asarray(veh_j.speed_index).copy()
            si[:, 0] = idx
            vj = veh_j.replace(lane=jnp.asarray(lane), speed_index=jnp.asarray(si))
            obs_j = observe_j(vj)
            vt = veh_t.replace(lane=torch.from_numpy(lane.copy()),
                               speed_index=torch.from_numpy(si))
            obs_t = et.observation_type.observe(et.geo, vt, 0)
            assert obs_t.shape == (N_RESET,) + et.observation_type.shape
            _assert_cells(obs_t, obs_j, _boundary_obs(ej, vj),
                          f"{env_id} window speed {idx}")


@pytest.mark.parametrize("env_id,case", [(e, c) for e in CASES for c in CASES[e]])
def test_step_autoreset_batched_matches_jax(env_id, case):
    ej, et, states, jstep = _setup(env_id)
    sj = _ending(_first(states), et, case)
    st = from_numpy_state(_numpy_state(sj))
    acts = np.random.default_rng(11).integers(0, et.action_type.n, B).astype(np.int32)

    obs_j, st_j, rew_j, term_j, trunc_j, info_j = jstep(sj, jnp.asarray(acts))
    gen = et.generator(5)
    gen_clone = et.generator(0)
    gen_clone.set_state(gen.get_state())
    obs_t, st_t, rew_t, term_t, trunc_t, info_t = et.step_autoreset_batched(
        st, torch.from_numpy(acts), gen
    )

    done = (term_t | trunc_t).numpy()
    np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j))
    np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j))
    assert done[::2].all() and not done[1::2].any()
    _close(rew_t, rew_j, HEAD_ATOL, "reward")
    _close(info_t["speed"], info_j["speed"], 1e-4 * 40.0, "info speed")
    np.testing.assert_array_equal(info_t["crashed"].numpy(), np.asarray(info_j["crashed"]))
    assert set(info_t["rewards"]) == set(info_j["rewards"])
    for name, value in info_t["rewards"].items():
        _close(value, info_j["rewards"][name], HEAD_ATOL, f"info rewards {name}")

    keep = ~done
    _assert_cells(obs_t.numpy()[keep], np.asarray(obs_j)[keep],
                  _boundary_obs(ej, st_j.vehicles)[keep], f"{env_id} obs")
    np.testing.assert_array_equal(st_t.steps.numpy()[keep], np.asarray(st_j.steps)[keep])
    for name in STATE_DISCRETE:
        np.testing.assert_array_equal(
            getattr(st_t.vehicles, name).numpy()[keep],
            np.asarray(getattr(st_j.vehicles, name))[keep], err_msg=name,
        )
    for name in STATE_CONTINUOUS:
        b = np.asarray(getattr(st_j.vehicles, name))[keep]
        tol = 2e-4 if name == "pos" else 1e-4 * max(1.0, float(np.abs(b).max()))
        _close(getattr(st_t.vehicles, name).numpy()[keep], b, tol, name)

    # done rows: the port's own reset from the generator as it stood
    obs_r, st_r = et._reset(B, gen_clone)
    np.testing.assert_array_equal(obs_t.numpy()[done], obs_r.numpy()[done])
    for f in dataclasses.fields(VehicleState):
        np.testing.assert_array_equal(
            getattr(st_t.vehicles, f.name).numpy()[done],
            getattr(st_r.vehicles, f.name).numpy()[done], err_msg=f.name,
        )


def _resets(env_id, seed_t=1):
    ej, et, states, _ = _setup(env_id)
    _, st = et.reset(N_RESET, et.generator(seed_t))
    return ej, et, st.vehicles, from_numpy_state(_numpy_state(states)).vehicles


def _ks(name, a, b):
    p = stats.ks_2samp(np.ravel(a), np.ravel(b)).pvalue
    assert p > 1e-3, f"{name}: KS p-value {p}"


def _deterministic(vt, vj, slots, names):
    for slot in slots:
        for name in names:
            np.testing.assert_array_equal(
                getattr(vt, name)[:, slot].numpy(), getattr(vj, name)[:, slot].numpy(),
                err_msg=f"slot {slot} {name}",
            )


def test_two_way_reset_invariants_and_distribution_match_jax():
    ej, et, vt, vj = _resets("two-way-v0")
    np.testing.assert_array_equal(
        vt.kind.numpy(), np.broadcast_to([KIND_EGO] + [KIND_IDM] * 5, (N_RESET, 6)))
    # the ego on ("a", "b", 1) at s = 30, speed 30, and every slot's
    # lane / target lane / lane changes as in JAX
    _deterministic(vt, vj, (0,), ("pos", "heading", "speed", "target_speed",
                                  "speed_index", "lane", "target_lane"))
    for name in ("lane", "target_lane", "enable_lane_change", "heading"):
        np.testing.assert_array_equal(getattr(vt, name).numpy(),
                                      getattr(vj, name).numpy(), err_msg=name)
    ab1, ba0 = (et.net.global_lane_index(i) for i in (("a", "b", 1), ("b", "a", 0)))
    assert (vt.target_lane[:, 1:4] == ab1).all() and (vt.target_lane[:, 4:] == ba0).all()
    # stations: forward 70 + 40 i + N(0, 10) along x, oncoming 200 + 100 i
    # + N(0, 10) from x = 800 backwards; speeds N(24, 2) and N(20, 5)
    fwd_t = vt.pos[:, 1:4, 0].numpy() - np.array([70.0, 110.0, 150.0])
    fwd_j = vj.pos[:, 1:4, 0].numpy() - np.array([70.0, 110.0, 150.0])
    bwd_t = 800.0 - vt.pos[:, 4:, 0].numpy() - np.array([200.0, 300.0])
    bwd_j = 800.0 - vj.pos[:, 4:, 0].numpy() - np.array([200.0, 300.0])
    _ks("forward station jitter", fwd_t, fwd_j)
    _ks("oncoming station jitter", bwd_t, bwd_j)
    _ks("forward speed", vt.speed[:, 1:4].numpy(), vj.speed[:, 1:4].numpy())
    _ks("oncoming speed", vt.speed[:, 4:].numpy(), vj.speed[:, 4:].numpy())
    assert abs(float(fwd_t.std()) - 10.0) < 1.0 and abs(float(bwd_t.std()) - 10.0) < 1.0
    assert abs(float(vt.speed[:, 4:].mean()) - 20.0) < 0.6
    timer = torch.remainder((vt.pos[..., 0] + vt.pos[..., 1]) * np.pi, 1.0)
    torch.testing.assert_close(vt.timer, timer, rtol=0, atol=1e-6)


def test_u_turn_reset_invariants_and_distribution_match_jax():
    ej, et, vt, vj = _resets("u-turn-v0")
    np.testing.assert_array_equal(
        vt.kind.numpy(), np.broadcast_to([KIND_EGO] + [KIND_IDM] * 6, (N_RESET, 7)))
    # every slot's lane, route and (but slot 1's) delta as in JAX; the ego
    # at s = 0 on ("a", "b", 0), speed 16, heading 0
    for name in ("lane", "target_lane", "route_base", "route_n", "route_id",
                 "route_len"):
        np.testing.assert_array_equal(getattr(vt, name).numpy(),
                                      getattr(vj, name).numpy(), err_msg=name)
    _deterministic(vt, vj, (0,), ("pos", "heading", "speed", "target_speed",
                                  "speed_index"))
    assert (vt.speed_index[:, 0] == 1).all() and (vt.heading[:, 0] == 0).all()
    assert (vt.route_len == 3).all() or (vt.route_len <= 3).all()
    np.testing.assert_array_equal(vt.delta[:, [0, 2, 3, 4, 5, 6]].numpy(), 4.0)
    # blockers: station and speed jitter N(0, 2) each, delta of slot 1
    # U(3.5, 4.5); the heading of each is its lane's at its station
    lane = vt.lane[:, 1:]

    def jitter(veh):
        s, lat = t_lane.local_coordinates(et.geo, lane, veh.pos[:, 1:])
        assert float(lat.abs().max()) < 1e-3
        return (s - et._spawn_s[1:]).numpy()

    _ks("station jitter", jitter(vt), jitter(vj))
    _ks("speed jitter", (vt.speed - et._spawn_v)[:, 1:].numpy(),
        (vj.speed - et._spawn_v)[:, 1:].numpy())
    _ks("delta", vt.delta[:, 1].numpy(), vj.delta[:, 1].numpy())
    assert abs(float(jitter(vt).std()) - 2.0) < 0.2
    s_t, _ = t_lane.local_coordinates(et.geo, lane, vt.pos[:, 1:])
    torch.testing.assert_close(vt.heading[:, 1:], t_lane.heading_at(et.geo, lane, s_t),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("env_id", TTC_IDS)
def test_compact_autoreset_matches_full(env_id):
    """``reset_slots=P`` places only the done rows, P at a time (a second
    pass when more than P are done): the same states and observations as
    the full autoreset, the generator advanced alike."""
    et = ht.make(env_id, device="cpu")
    _, states = et.reset(6, et.generator(0))
    crashed = states.vehicles.crashed.clone()
    crashed[::2, 0] = True
    states = states.replace(vehicles=states.vehicles.replace(crashed=crashed))
    acts = torch.arange(6, dtype=torch.int32) % et.action_type.n
    g_full, g_compact = et.generator(7), et.generator(7)
    full = et.step_autoreset_batched(states, acts, g_full)
    compact = et.step_autoreset_batched(states, acts, g_compact, reset_slots=2)
    torch.testing.assert_close(compact[0], full[0], rtol=0, atol=0)
    for f in dataclasses.fields(VehicleState):
        torch.testing.assert_close(getattr(compact[1].vehicles, f.name),
                                   getattr(full[1].vehicles, f.name), rtol=0, atol=0)
    assert torch.equal(g_full.get_state(), g_compact.get_state())


@pytest.mark.parametrize("env_id", TTC_IDS)
def test_rollout_and_vector_env_on_the_cpu(env_id):
    et = ht.make(env_id, device="cpu")
    gen = et.generator(0)
    _, states = et.reset(4, gen)
    before = general_frames.frames_general_kernel.launches
    states, metrics = rollout(et, states, 3, gen)
    assert general_frames.frames_general_kernel.launches == before
    for name, value in metrics.items():
        assert value.shape == () and bool(torch.isfinite(value)), name
    assert isinstance(states, EnvState)
    # the vector env: the (3, 3, T) Box, final_obs on the same step
    envs = ht.make_vec(env_id, 4, device="cpu", final_obs=True)
    obs, _ = envs.reset(seed=0)
    assert obs.shape == (4,) + et.observation_type.shape
    assert envs.single_observation_space.shape == et.observation_type.shape
    for _ in range(3):
        obs, reward, term, trunc, info = envs.step(np.zeros(4, np.int64))
        assert envs.observation_space.contains(np.asarray(obs, np.float32))
        assert np.asarray(info["final_obs"]).shape == obs.shape
    envs.close()
