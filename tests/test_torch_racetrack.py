"""racetrack-v0, racetrack-large-v0 and racetrack-oval-v0 in the port against
the JAX package, on the CPU.

The racetrack egos take a lateral-only ContinuousAction, so every step runs
the general frame's raw-control branch (K4's ``raw_controls``; on CPU
tensors its plain version ``frames_general_plain``).  One
``step_autoreset_batched`` from a JAX reset batch carried across with the
same float actions: obs, reward, terminated, truncated, info and the state
of the rows that go on match the JAX step (the XLA general frame on the
CPU); the done rows equal the port's own ``_reset`` drawn from a clone of
the step's generator.  Tolerances as in test_torch_general_envs.py:
discrete fields exact, pos 2e-4 m, other continuous state 1e-4 of its
magnitude, obs and reward 1e-5.

Then the lane functions on the clockwise arcs (e -> f and i -> a) and the
+/-pi line, the closed loop (an ego near the end of i -> a follows the road
back onto a -> b), the resets' invariants and seeded two-sample tests of
their draws, the oval's roadblocks, and the gate's refusals.  racetrack-v0
under a DiscreteAction (int actions on the same raw-control branch) is held
to the JAX step in the same way.
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
from highwayenv_tpu.road import lane as j_lane
from highwayenv_tpu_torch.bridge import from_numpy_state
from highwayenv_tpu_torch.envs.base import map_fields
from highwayenv_tpu_torch.envs.racetrack import RacetrackEnv
from highwayenv_tpu_torch.ops import general_frames
from highwayenv_tpu_torch.parallel.rollout import random_actions, rollout
from highwayenv_tpu_torch.road import lane as t_lane
from highwayenv_tpu_torch.vehicle.state import (
    KIND_EGO,
    KIND_IDM,
    KIND_OBSTACLE,
    KIND_PAD,
    VehicleState,
)

torch.set_num_threads(1)

B = 8
N_RESET = 256
ENV_IDS = ["racetrack-v0", "racetrack-large-v0", "racetrack-oval-v0"]
STATE_DISCRETE = ("lane", "target_lane", "crashed", "hit", "impact_pending",
                  "speed_index", "kind", "route_ptr")
STATE_CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer",
                    "impact", "steering", "accel")
HEAD_ATOL = 1e-5
CASES = ("crashed_ego", "near_duration", "off_road")
#: racetrack-v0 under a DiscreteAction on both axes: 3 x 3 grid points
DISCRETE_CONFIG = {"action": {"type": "DiscreteAction"}}

_SETUP: dict = {}


def _setup(env_id, config=None):
    """JAX env, port env, a JAX reset batch and the jitted JAX step, built
    once per env and config so the JAX step compiles once per test process."""
    key = (env_id, repr(config))
    if key not in _SETUP:
        ej = hj.make(env_id, config)
        et = ht.make(env_id, config, device="cpu")
        _, states = jax.jit(jax.vmap(ej._reset))(
            jax.random.split(jax.random.PRNGKey(3), B)
        )
        _SETUP[key] = (ej, et, states, jax.jit(ej.step_autoreset_batched))
    return _SETUP[key]


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
    return states.replace(vehicles=states.vehicles.replace(
        **{k: jnp.asarray(v) for k, v in fields.items()}
    ))


def _ending(states, et, case):
    """Rows 0, 2, 4 and 6 end this step: a crashed ego, one policy step
    left before ``duration``, or the ego 15 m to the left of its lane on
    a -> b (10 m beyond the road's edge: ``terminate_off_road``)."""
    ending = np.arange(B) % 2 == 0
    veh = states.vehicles
    if case == "crashed_ego":
        crashed = np.asarray(veh.crashed).copy()
        crashed[ending, 0] = True
        return _with(states, crashed=crashed)
    if case == "off_road":
        pos = np.asarray(veh.pos).copy()
        lane = np.asarray(veh.lane)[:, 0]
        n = et.geo.direction_lateral.numpy()[lane]  # the ego's lanes are straights
        pos[ending, 0] += 15.0 * n[ending]
        return _with(states, pos=pos)
    time = np.asarray(states.time).copy()
    time[ending] = et.config["duration"] - 1.0 / et.config["policy_frequency"]
    return states.replace(time=jnp.asarray(time))


def _close(a, b, atol, where):
    np.testing.assert_allclose(
        np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=0,
        atol=atol, err_msg=where,
    )


def _assert_state(vt, vj, rows, where=""):
    for name in STATE_DISCRETE:
        np.testing.assert_array_equal(
            getattr(vt, name).numpy()[rows], np.asarray(getattr(vj, name))[rows],
            err_msg=f"{where}{name}",
        )
    for name in STATE_CONTINUOUS:
        b = np.asarray(getattr(vj, name))[rows]
        tol = 2e-4 if name == "pos" else 1e-4 * max(1.0, float(np.abs(b).max()))
        _close(getattr(vt, name).numpy()[rows], b, tol, f"{where}{name}")


def _actions(seed=11):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (B, 1)).astype(np.float32)


def _step_matches_jax(env_id, case, acts, config=None):
    """One step_autoreset_batched of the port against the JAX step from the
    same batch and actions; returns the port's states and the rows that go
    on."""
    ej, et, states, jstep = _setup(env_id, config)
    sj = _ending(states, et, case)
    st = from_numpy_state(_numpy_state(sj))

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
    _close(info_t["action"], info_j["action"], 0.0, "info action")
    assert set(info_t["rewards"]) == set(info_j["rewards"])
    for name, value in info_t["rewards"].items():
        _close(value, info_j["rewards"][name], HEAD_ATOL, f"info rewards {name}")

    keep = ~done
    _close(obs_t.numpy()[keep], np.asarray(obs_j)[keep], HEAD_ATOL, "obs")
    np.testing.assert_array_equal(st_t.steps.numpy()[keep], np.asarray(st_j.steps)[keep])
    _assert_state(st_t.vehicles, st_j.vehicles, keep)

    # done rows: the port's own reset from the generator as it stood
    obs_r, st_r = et._reset(B, gen_clone)
    np.testing.assert_array_equal(obs_t.numpy()[done], obs_r.numpy()[done])
    for f in dataclasses.fields(VehicleState):
        np.testing.assert_array_equal(
            getattr(st_t.vehicles, f.name).numpy()[done],
            getattr(st_r.vehicles, f.name).numpy()[done], err_msg=f.name,
        )
    return st_t, keep


@pytest.mark.parametrize("env_id,case", [(e, c) for e in ENV_IDS for c in CASES])
def test_step_autoreset_batched_matches_jax(env_id, case):
    acts = _actions()
    st_t, keep = _step_matches_jax(env_id, case, acts)
    # the ego kept the stored lateral command: steering = lmap(a, pi / 4)
    steer = np.clip(acts[:, 0], -1, 1) * np.float32(np.pi / 4)
    _close(st_t.vehicles.steering[:, 0].numpy()[keep], steer[keep], 1e-6, "ego steering")
    assert not st_t.vehicles.accel[:, 0].numpy()[keep].any()


def test_raw_frames_take_stored_controls_and_no_slot_actions():
    """The general frames under raw controls read the controls stored on
    the egos (``store_raw_controls``) and refuse slot actions, as meta-action
    frames refuse their absence: the same on CPU tensors as on the card."""
    et = ht.make("racetrack-v0", DISCRETE_CONFIG, device="cpu")
    _, st = et.reset(B, et.generator(1))
    sa = et._action_to_slots(torch.arange(B, dtype=torch.int32) % 9)
    veh, none, raw = general_frames.store_raw_controls(et, st.vehicles, sa)
    assert raw and none is None
    spec, frames = et._general, et.frames_per_step
    out = general_frames.frames_general_kernel(veh, spec, None, frames, raw=True)
    ref = general_frames.simulate_general_reference(et, st.vehicles, sa, frames)
    for f in dataclasses.fields(VehicleState):
        assert torch.equal(getattr(out, f.name), getattr(ref, f.name)), f.name
    with pytest.raises(ValueError, match="slot_actions go with meta-actions"):
        general_frames.frames_general_kernel(veh, spec, sa, frames, raw=True)
    with pytest.raises(ValueError, match="slot_actions go with meta-actions"):
        general_frames.frames_general_plain(veh, spec, None, frames)


@pytest.mark.parametrize("case", CASES)
def test_discrete_action_step_matches_jax(case):
    """racetrack-v0 under a DiscreteAction: (B,) int32 actions, each a point
    of the row-major (acceleration, steering) grid, stored on the egos
    before the frames, which then keep them (the raw-control branch)."""
    acts = np.random.default_rng(12).integers(0, 9, B).astype(np.int32)
    assert len(set(acts.tolist())) > 4
    st_t, keep = _step_matches_jax("racetrack-v0", case, acts, DISCRETE_CONFIG)
    grid = np.linspace(-1.0, 1.0, 3).astype(np.float32)
    veh = st_t.vehicles
    _close(veh.accel[:, 0].numpy()[keep], 5.0 * grid[acts // 3][keep], 1e-5, "ego accel")
    _close(veh.steering[:, 0].numpy()[keep], np.float32(np.pi / 4) * grid[acts % 3][keep],
           1e-6, "ego steering")


def test_clockwise_lane_functions_match_jax():
    """local_coordinates, position, heading_at, the projection table and
    closest_lane on the racetrack's clockwise arcs e -> f (0 to 136 / 137
    degrees) and i -> a (240 to 270 / 238 to 268 degrees), at points along
    them and across the -pi / pi line of their circles, and on the g -> h
    arc that starts at 315 degrees."""
    ej, et, _, _ = _setup("racetrack-v0")
    np.testing.assert_array_equal(et.geo.cw.numpy(), np.asarray(ej.geo.cw))
    cw_lanes = [et.net.global_lane_index(i) for i in
                (("e", "f", 0), ("e", "f", 1), ("i", "a", 0), ("i", "a", 1))]
    assert (et.geo.cw.numpy()[cw_lanes] == 1).all()
    rng = np.random.default_rng(4)
    lanes = np.repeat(np.array(cw_lanes + [et.net.global_lane_index(("g", "h", 0))],
                               np.int32), 24)
    length = et.geo.length.numpy()[lanes]
    s = (rng.uniform(-0.1, 1.1, lanes.size) * length).astype(np.float32)
    lat = rng.uniform(-4.0, 4.0, lanes.size).astype(np.float32)
    pos_j = np.asarray(j_lane.position(ej.geo, jnp.asarray(lanes), jnp.asarray(s),
                                       jnp.asarray(lat)))
    pos_t = t_lane.position(et.geo, torch.from_numpy(lanes), torch.from_numpy(s),
                            torch.from_numpy(lat)).numpy()
    np.testing.assert_allclose(pos_t, pos_j, rtol=0, atol=1e-4)
    h_j = np.asarray(j_lane.heading_at(ej.geo, jnp.asarray(lanes), jnp.asarray(s)))
    h_t = t_lane.heading_at(et.geo, torch.from_numpy(lanes), torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(h_t, h_j, rtol=0, atol=1e-5)

    # the -pi / pi line (west of each centre), where atan2 changes sign
    eps = np.array([0.0, 1e-6, -1e-6, 1e-3, -1e-3, 0.05], np.float32)
    wrap = [np.array([c[0] - r, c[1] + y], np.float32)
            for c, r in (((70.0, -30.0), 17.5), ((43.2, 23.4), 21.0), ((18.1, -18.1), 27.5))
            for y in eps]
    pts = np.concatenate([pos_j.astype(np.float32), np.stack(wrap)])
    q = np.resize(np.array(cw_lanes, np.int32), len(pts))
    s_j, lat_j = j_lane.local_coordinates(ej.geo, jnp.asarray(q), jnp.asarray(pts))
    s_t, lat_t = t_lane.local_coordinates(et.geo, torch.from_numpy(q), torch.from_numpy(pts))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(lat_t.numpy(), np.asarray(lat_j), rtol=0, atol=1e-4)
    for a, b in zip(t_lane.projection_table(et.geo, torch.from_numpy(pts)),
                    j_lane.projection_table(ej.geo, jnp.asarray(pts))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4)
    heading = rng.uniform(-np.pi, np.pi, len(pts)).astype(np.float32)
    np.testing.assert_array_equal(
        t_lane.closest_lane(et.geo, torch.from_numpy(pts), torch.from_numpy(heading)).numpy(),
        np.asarray(j_lane.closest_lane(ej.geo, jnp.asarray(pts), jnp.asarray(heading))),
    )


def test_closed_loop_follows_the_road_back_to_the_start():
    """An ego 0.5 to 1.2 m from the end of i -> a (the last, clockwise arc)
    and its NPC as near the end of h -> i: one step (2 m at 10 m/s) of the
    port and of JAX, then the ego on a -> b and the NPC on i -> a.  The
    lateral command is 0, so the ego steers straight and the loop closes
    through follow_road's successor edge."""
    ej, et, states, jstep = _setup("racetrack-v0")
    v = {k: np.array(a) for k, a in _numpy_state(states)["vehicles"].items()}
    for b in range(B):
        for slot, edge in ((0, ("i", "a")), (1, ("h", "i"))):
            index = edge + (b % 2,)
            g = et.net.global_lane_index(index)
            s = float(et.geo.length[g]) - 0.5 - 0.1 * b
            lane = torch.tensor([g], dtype=torch.int32)
            st = torch.tensor([s])
            v["pos"][b, slot] = t_lane.position(et.geo, lane, st, torch.zeros(1))[0].numpy()
            v["heading"][b, slot] = float(t_lane.heading_at(et.geo, lane, st)[0])
            v["lane"][b, slot] = v["target_lane"][b, slot] = g
    sj = _with(states, **v)
    acts = np.zeros((B, 1), np.float32)
    obs_j, st_j, rew_j, term_j, trunc_j, _ = jstep(sj, jnp.asarray(acts))
    obs_t, st_t, rew_t, term_t, trunc_t, _ = et.step_autoreset_batched(
        from_numpy_state(_numpy_state(sj)), torch.from_numpy(acts), et.generator(0)
    )
    np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j))
    keep = ~(term_t | trunc_t).numpy()
    assert keep.all()
    _assert_state(st_t.vehicles, st_j.vehicles, keep)
    _close(obs_t.numpy(), np.asarray(obs_j), HEAD_ATOL, "obs")
    _close(rew_t, rew_j, HEAD_ATOL, "reward")
    ab = {et.net.global_lane_index(("a", "b", i)) for i in (0, 1)}
    ia = {et.net.global_lane_index(("i", "a", i)) for i in (0, 1)}
    assert set(st_t.vehicles.lane[:, 0].tolist()) <= ab
    assert set(st_t.vehicles.target_lane[:, 0].tolist()) <= ab
    assert set(st_t.vehicles.lane[:, 1].tolist()) <= ia


def _resets(env_id, config=None, seed_t=1, seed_j=2):
    ej = hj.make(env_id, config)
    et = ht.make(env_id, config, device="cpu")
    _, st = et.reset(N_RESET, et.generator(seed_t))
    _, sj = jax.jit(jax.vmap(ej._reset))(jax.random.split(jax.random.PRNGKey(seed_j), N_RESET))
    return et, st.vehicles, from_numpy_state(_numpy_state(sj)).vehicles


def _ks(name, a, b):
    p = stats.ks_2samp(np.ravel(a), np.ravel(b)).pvalue
    assert p > 1e-3, f"{name}: KS p-value {p}"


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_reset_invariants_and_distribution_match_jax(env_id):
    et, vt, vj = _resets(env_id)
    assert vt.kind.shape == vj.kind.shape == (N_RESET, 2)
    for v in (vt, vj):
        np.testing.assert_array_equal(v.kind.numpy(), [[KIND_EGO, KIND_IDM]] * N_RESET)
        assert (v.target_lane == v.lane).all() and (v.route_len == 0).all()
        assert (v.speed_index == 0).all() and (v.delta == 4.0).all()
    ab = et.net.global_lane_index(("a", "b", 0))
    bc = et.net.global_lane_index(("b", "c", 0))
    n_ab = len(et.net.lanes_on_edge("a", "b"))

    def draws(v):
        """ego lane id, ego s, NPC s, NPC speed (each (N,))."""
        s, lat = t_lane.local_coordinates(et.geo, v.lane, v.pos)
        assert float(lat.abs().max()) < 1e-3
        return (v.lane[:, 0] - ab).numpy(), s[:, 0].numpy(), s[:, 1].numpy(), \
            v.speed[:, 1].numpy()

    lt, st_e, st_n, sp_t = draws(vt)
    lj, sj_e, sj_n, sp_j = draws(vj)
    # the NPC on the same lane id of b -> c, the ego at its speed limit 10
    np.testing.assert_array_equal((vt.lane[:, 1] - bc).numpy(), lt)
    assert (vt.speed[:, 0] == 10.0).all() and (vt.target_speed == vt.speed).all()
    bc_len = float(et.geo.length[bc])
    assert st_e.min() >= 20.0 and st_e.max() <= 50.0
    assert st_n.min() >= -1e-3 and st_n.max() <= bc_len + 1e-3
    assert sp_t.min() >= 6.0 and sp_t.max() <= 9.0
    _ks("ego s", st_e, sj_e)
    _ks("NPC s", st_n, sj_n)
    _ks("NPC speed", sp_t, sp_j)
    counts = np.stack([np.bincount(x, minlength=n_ab) for x in (lt, lj)])
    assert counts.shape[1] == n_ab and stats.chi2_contingency(counts).pvalue > 1e-3
    # positions and headings on the lanes, from the same lane functions
    h = t_lane.heading_at(et.geo, vt.lane, t_lane.local_coordinates(et.geo, vt.lane,
                                                                     vt.pos)[0])
    torch.testing.assert_close(vt.heading, h, rtol=0, atol=1e-5)
    timer = torch.remainder((vt.pos[..., 0] + vt.pos[..., 1]) * np.pi, 1.0)
    torch.testing.assert_close(vt.timer, timer, rtol=0, atol=1e-6)


def test_extra_npcs_and_oval_roadblocks_match_jax():
    """other_vehicles = 4 on racetrack-v0: up to three extra NPCs on random
    lanes, dropped within 20 m of an earlier vehicle; and the oval's eight
    roadblocks with block_lane, in the last slots, exactly as JAX's."""
    et, vt, vj = _resets("racetrack-v0", {"other_vehicles": 4})
    assert vt.kind.shape == (N_RESET, 5)
    for v in (vt, vj):
        kind = v.kind.numpy()
        assert (kind[:, 0] == KIND_EGO).all() and (kind[:, 1] == KIND_IDM).all()
        assert np.isin(kind[:, 2:], (KIND_IDM, KIND_PAD)).all()
        live = kind != KIND_PAD
        d = np.linalg.norm(v.pos.numpy()[:, :, None] - v.pos.numpy()[:, None], axis=-1)
        for i in range(2, 5):
            assert not (live[:, i, None] & live[:, :i] & (d[:, i, :i] < 20.0)).any()
    n_t = (vt.kind[:, 2:] == KIND_IDM).sum(1).numpy()
    n_j = (vj.kind[:, 2:] == KIND_IDM).sum(1).numpy()
    counts = np.stack([np.bincount(x, minlength=4) for x in (n_t, n_j)])
    assert stats.chi2_contingency(counts[:, counts.sum(0) > 0]).pvalue > 1e-3

    et, vt, vj = _resets("racetrack-oval-v0", {"block_lane": True})
    assert et.num_slots == 10 and et.geo.num_lanes == 24
    for name in ("pos", "kind", "length", "width", "heading", "speed"):
        np.testing.assert_array_equal(getattr(vt, name)[:, 2:].numpy(),
                                      getattr(vj, name)[:, 2:].numpy(), err_msg=name)
    assert (vt.kind[:, 2:] == KIND_OBSTACLE).all()


def test_gate_refusals_name_their_reason():
    for env_id in ENV_IDS:
        env = ht.make(env_id, device="cpu")
        assert env._straight is None and env._general is not None
        assert env.action_type.stores_raw_controls
        assert env.action_space == hj.make(env_id).action_space

    class RegulatedRacetrack(RacetrackEnv):
        regulated = True

    # raw controls on a regulated road take K5's raw-control branch
    regulated = RegulatedRacetrack(device="cpu")
    assert regulated._general is not None and regulated._general.period is not None
    # a dynamical action: the dynamical instantiations, under the
    # connected-lane search too (the connected dynamical ones)
    dynamical = {"action": {"type": "ContinuousAction", "dynamical": True}}
    assert ht.make("racetrack-v0", dynamical, device="cpu")._general.dynamical
    both = ht.make("racetrack-v1", dynamical, device="cpu")._general
    assert both.dynamical and both.connected
    # an oval of 5 lanes an edge has 40 lanes, within the lane tables' 64;
    # 2048 NPCs and the ego are 2049 slots: beyond the cluster kernels' 16
    # blocks of 128, the global layout's; 8192 NPCs and the ego are past its
    # 8192 slots
    assert ht.make("racetrack-oval-v0", {"no_lanes": 5}, device="cpu").geo.num_lanes == 40
    assert ht.make("racetrack-oval-v0", {"no_lanes": 4}, device="cpu").geo.num_lanes == 32
    crowded = ht.make("racetrack-v0", {"other_vehicles": 2048}, device="cpu")
    assert general_frames.frames_kernel_for(crowded._general, False, crowded.num_slots).glob
    with pytest.raises(NotImplementedError, match="8193 slots > 8192"):
        ht.make("racetrack-v0", {"other_vehicles": 8192}, device="cpu")
    # the -v1 ids: the same envs with the connected-lane neighbour search
    for env_id in ("racetrack-v1", "racetrack-large-v1", "racetrack-oval-v1"):
        env = ht.make(env_id, device="cpu")
        assert env._general.connected and env.action_type.stores_raw_controls


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_rollout_on_the_cpu_is_finite_and_launches_no_kernel(env_id):
    et = ht.make(env_id, device="cpu")
    gen = et.generator(0)
    _, states = et.reset(4, gen)
    before = general_frames.frames_general_kernel.launches
    states, metrics = rollout(et, states, 3, gen)
    assert general_frames.frames_general_kernel.launches == before
    for name, value in metrics.items():
        assert value.shape == () and bool(torch.isfinite(value)), name
    assert bool(torch.isfinite(states.vehicles.pos).all())


def _same(a, b, where, ulps=4):
    """Exact for integers and booleans; floats within ``ulps`` at the
    magnitude (the CPU's vectorized libm may round a row placed among P
    rows differently than among B)."""
    a, b = a.numpy(), b.numpy()
    if not np.issubdtype(b.dtype, np.floating):
        np.testing.assert_array_equal(a, b, err_msg=where)
        return
    scale = np.spacing(np.float32(max(float(np.abs(b).max(initial=0.0)), 1e-30)))
    np.testing.assert_allclose(a, b, rtol=0, atol=ulps * scale, err_msg=where)


@pytest.mark.parametrize("slots", [4, 16])
def test_compact_autoreset_and_final_obs_match_the_full_step(slots):
    """The compact autoreset and the final_obs order on the (B, F, W, H)
    occupancy grid: the same obs, states, rewards and flags as the full
    autoreset, the generators advanced alike; every other ego crashed."""
    et = ht.make("racetrack-v0", device="cpu")
    _, st = et.reset(16, et.generator(0))
    crashed = st.vehicles.crashed.clone()
    crashed[::2, 0] = True
    full = compact = st.replace(vehicles=st.vehicles.replace(crashed=crashed))
    g_full, g_compact = et.generator(5), et.generator(5)
    for t in range(3):
        acts = torch.empty(16, 1).uniform_(-1, 1, generator=g_full)
        torch.empty(16, 1).uniform_(-1, 1, generator=g_compact)
        out_f = et.step_autoreset_batched(full, acts, g_full)
        out_c = et._autoreset_rest(*et._autoreset_first(compact, acts, g_compact, slots,
                                                        final_obs=True))
        assert out_c[0].shape == (16, 2, 12, 12)
        done = out_f[3] | out_f[4]
        if t == 0:
            assert int(done.sum()) == 8
        final = out_c[5]["final_obs"]
        assert not done.any() or not torch.equal(final[done], out_c[0][done])
        for name, a, b in zip(("obs", "reward", "terminated", "truncated"),
                              (out_c[0],) + out_c[2:5], (out_f[0],) + out_f[2:5]):
            _same(a, b, f"P={slots} step {t} {name}")
        map_fields(lambda a, b: _same(a, b, f"P={slots} step {t} state"), out_c[1], out_f[1])
        full, compact = out_f[1], out_c[1]
    assert torch.equal(g_full.get_state(), g_compact.get_state())


def test_vector_env_and_rollouts_take_continuous_actions():
    """The Gymnasium vector env casts Box samples (and float64 arrays) to
    float32; the rollout draws U(-1, 1) actions, also with fresh_pool."""
    envs = ht.make_vec("racetrack-v0", num_envs=4, device="cpu")
    obs, _ = envs.reset(seed=0)
    assert obs.shape == (4, 2, 12, 12) and obs.dtype == np.float32
    assert envs.single_action_space == hj.make("racetrack-v0").action_space
    for acts in (envs.action_space.sample(), np.full((4, 1), 0.25)):
        obs, r, term, trunc, info = envs.step(acts)
        assert np.isfinite(obs).all() and np.isfinite(r).all()
        assert info["action"].dtype == np.float32
    envs.close()
    et = ht.make("racetrack-v0", device="cpu")
    gen = et.generator(0)
    acts = random_actions(et, 256, gen)
    assert acts.dtype == torch.float32 and acts.shape == (256, 1)
    assert -1.0 <= float(acts.min()) < -0.9 and 0.9 < float(acts.max()) < 1.0
    _, st = et.reset(4, gen)
    st, metrics = rollout(et, st, 2, gen, fresh_pool=2)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
