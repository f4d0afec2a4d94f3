"""exit-v0 and the exit observation in the port against the JAX package, on
the CPU.

One ``step_autoreset_batched`` of the port from a JAX reset batch carried
across with the same actions: obs, reward, terminated, truncated, info
(``is_success`` too) and the state of the rows that go on match the JAX
step (the XLA general frame on the CPU; ``step_batched``, whose kept rows
are those of ``step_autoreset_batched``, so that the JAX reset is not
compiled into the step); the done rows equal the port's own ``_reset``
drawn from a clone of the step's generator.  Tolerances: discrete fields
exact, pos 2e-4 m, other continuous state 1e-4 of its magnitude, obs and
reward 1e-5.

Then the exit observation on the 7-lane section (the ego's ``x`` is its
station on the approach lane, the range frozen at the 6 lanes of the
reset edge), success and the goal reward, the reset's invariants and
seeded two-sample tests of its draws, the compact autoreset and the
rollout.
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
from highwayenv_tpu_torch.bridge import from_numpy_state
from highwayenv_tpu_torch.observations.exit_obs import ExitObservation
from highwayenv_tpu_torch.ops import general_frames
from highwayenv_tpu_torch.parallel.rollout import rollout
from highwayenv_tpu_torch.road import lane as t_lane
from highwayenv_tpu_torch.utils.math import lmap
from highwayenv_tpu_torch.vehicle.state import KIND_EGO, KIND_IDM, MAX_SPEED, VehicleState

torch.set_num_threads(1)

ENV_ID = "exit-v0"
B = 8
N_RESET = 256
STATE_DISCRETE = ("lane", "target_lane", "crashed", "hit", "impact_pending",
                  "speed_index", "kind", "route_ptr")
STATE_CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer",
                    "impact", "steering", "accel")
HEAD_ATOL = 1e-5
CASES = ("crashed_ego", "near_duration")

_SETUP: dict = {}


def _numpy_state(states) -> dict:
    return {
        "vehicles": {
            f.name: np.array(getattr(states.vehicles, f.name))
            for f in dataclasses.fields(VehicleState)
        },
        "time": np.array(states.time),
        "steps": np.array(states.steps),
    }


def _setup():
    """JAX env, port env, N_RESET JAX resets and the jitted JAX step, built
    once so each compiles once per test process."""
    if not _SETUP:
        ej = hj.make(ENV_ID)
        et = ht.make(ENV_ID, device="cpu")
        _, states = jax.jit(jax.vmap(ej._reset))(
            jax.random.split(jax.random.PRNGKey(3), N_RESET)
        )
        _SETUP.update(ej=ej, et=et, states=states, step=jax.jit(ej.step_batched))
    return _SETUP["ej"], _SETUP["et"], _SETUP["states"], _SETUP["step"]


def _with(states, **fields):
    return states.replace(vehicles=states.vehicles.replace(
        **{k: jnp.asarray(v) for k, v in fields.items()}))


def _ending(states, et, case):
    """Rows 0, 2, 4 and 6 end this step: a crashed ego, or one policy step
    left before ``duration``."""
    ending = np.arange(B) % 2 == 0
    if case == "crashed_ego":
        crashed = np.array(states.vehicles.crashed)
        crashed[ending, 0] = True
        return _with(states, crashed=crashed)
    time = np.array(states.time)
    time[ending] = et.config["duration"] - 1.0 / et.config["policy_frequency"]
    return states.replace(time=jnp.asarray(time))


def _close(a, b, atol, where):
    np.testing.assert_allclose(
        np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=0,
        atol=atol, err_msg=where,
    )


def _on_the_exit_section(states, et, rows):
    """``states`` with the ego of ``rows`` moved onto the approach lane
    ("1", "2", 6) 30 m into the section, target lane and route pointer
    kept consistent."""
    veh = states.vehicles
    pos, lane, tgt = (np.array(veh.pos), np.array(veh.lane), np.array(veh.target_lane))
    approach = et.goal_lane_approach
    p = et.net.get_lane(("1", "2", 6)).position(30.0, 0.0)
    pos[rows, 0] = np.asarray(p, np.float32)
    lane[rows, 0] = approach
    tgt[rows, 0] = approach
    return _with(states, pos=pos, lane=lane, target_lane=tgt)


@pytest.mark.parametrize("case", CASES)
def test_step_autoreset_batched_matches_jax(case):
    ej, et, states, jstep = _setup()
    sj = _ending(jax.tree.map(lambda x: x[:B], states), et, case)
    # rows 1 and 3 start with the ego on the 7-lane section's approach lane
    sj = _on_the_exit_section(sj, et, [1, 3])
    st = from_numpy_state(_numpy_state(sj))
    acts = np.random.default_rng(11).integers(0, et.action_type.n, B).astype(np.int32)
    acts[[1, 3]] = 1  # IDLE: those egos keep the approach lane as their target

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
    for name in ("crashed", "is_success"):
        np.testing.assert_array_equal(info_t[name].numpy(), np.asarray(info_j[name]),
                                      err_msg=name)
    assert info_t["is_success"][[1, 3]].all()
    assert set(info_t["rewards"]) == set(info_j["rewards"])
    for name, value in info_t["rewards"].items():
        _close(value, info_j["rewards"][name], HEAD_ATOL, f"info rewards {name}")

    keep = ~done
    _close(obs_t.numpy()[keep], np.asarray(obs_j)[keep], HEAD_ATOL, "obs")
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

    obs_r, st_r = et._reset(B, gen_clone)
    np.testing.assert_array_equal(obs_t.numpy()[done], obs_r.numpy()[done])
    for f in dataclasses.fields(VehicleState):
        np.testing.assert_array_equal(
            getattr(st_t.vehicles, f.name).numpy()[done],
            getattr(st_r.vehicles, f.name).numpy()[done], err_msg=f.name,
        )


def test_exit_observation_on_the_exit_section():
    """The ego's ``x`` is its station on the approach lane ("1", "2", 6),
    its ``y`` is normalized over the 6 lanes of the reset edge even on the
    7-lane section, and the other rows subtract the ego's world position."""
    ej, et, states, _ = _setup()
    rows = np.arange(0, N_RESET, 2)
    sj = _on_the_exit_section(states, et, rows)
    obs_j = jax.jit(jax.vmap(lambda v: ej.observation_type.observe(ej.geo, v, 0)))(
        sj.vehicles)
    veh = from_numpy_state(_numpy_state(sj)).vehicles
    obs_t = et.observation_type.observe(et.geo, veh, 0)
    assert isinstance(et.observation_type, ExitObservation)
    assert obs_t.shape == (N_RESET, 15, 7) and et.observation_type.reset_edge_lanes == 6
    _close(obs_t, obs_j, HEAD_ATOL, "exit obs")

    lane = torch.full((N_RESET,), et.exit_obs_lane, dtype=torch.int32)
    s, _ = t_lane.local_coordinates(et.geo, lane, veh.pos[:, 0])
    x = lmap(s, (-5.0 * MAX_SPEED, 5.0 * MAX_SPEED), (-1.0, 1.0))
    torch.testing.assert_close(obs_t[:, 0, 1], x, rtol=0, atol=1e-6)
    on_section = torch.from_numpy(np.isin(np.arange(N_RESET), rows))
    assert (veh.lane[on_section, 0] == et.goal_lane_approach).all()
    assert (et.geo.edge_n[veh.lane[on_section, 0].long()] == 7).all()
    y = lmap(veh.pos[:, 0, 1], (-24.0, 24.0), (-1.0, 1.0))  # 4 m x 6 lanes
    torch.testing.assert_close(obs_t[:, 0, 2], y, rtol=0, atol=1e-6)
    # another row's x is relative to the ego's world x, not its station
    seen = obs_t[:, 1, 0] > 0
    dx = lmap(obs_t[seen, 1, 1], (-1.0, 1.0), (-5.0 * MAX_SPEED, 5.0 * MAX_SPEED))
    assert bool(seen.any())
    assert float((dx + veh.pos[seen, 0, 0]).abs().max()) < 1e3


def test_success_and_goal_reward():
    """Success on a target lane of the approach lane or the ramp; the goal
    reward lifts the normalized reward by 1 and clips it to [0, 1]."""
    _, et, states, _ = _setup()
    st = from_numpy_state(_numpy_state(jax.tree.map(lambda x: x[:4], states)))
    tgt = st.vehicles.target_lane.clone()
    tgt[1, 0] = et.goal_lane_approach
    tgt[2, 0] = et.goal_lane_exit
    st = st.replace(vehicles=st.vehicles.replace(target_lane=tgt))
    assert et._is_success(st).tolist() == [False, True, True, False]
    reward = et._reward(st, torch.zeros(4, dtype=torch.int32))
    assert (reward[[1, 2]] == 1.0).all() and (reward[[0, 3]] < 1.0).all()
    assert et._info(st, None)["is_success"].tolist() == [False, True, True, False]


def test_reset_invariants_and_distribution_match_jax():
    ej, et, states, _ = _setup()
    _, st = et.reset(N_RESET, et.generator(1))
    vt, vj = st.vehicles, from_numpy_state(_numpy_state(states)).vehicles
    V = et.num_slots
    assert V == 21 and et.geo.num_lanes == 20 and et.max_edge_lanes == 7
    np.testing.assert_array_equal(
        vt.kind.numpy(), np.broadcast_to([KIND_EGO] + [KIND_IDM] * 20, (N_RESET, V)))
    for name in ("speed", "target_speed", "speed_index", "heading"):
        np.testing.assert_array_equal(getattr(vt, name)[:, 0].numpy(),
                                      getattr(vj, name)[:, 0].numpy(), err_msg=name)
    assert not vt.enable_lane_change[:, 1:].any() and vt.enable_lane_change[:, 0].all()
    assert (vt.route_len[:, 0] == 0).all() and (vt.route_len[:, 1:] == 3).all()
    np.testing.assert_array_equal(vt.route_base.numpy(), vj.route_base.numpy())

    # NPC lane ids p(i) proportional to i (the route's first explicit id),
    # speeds at their lane's limit 26 - 3.4 i
    ids_t, ids_j = vt.route_id[:, 1:, 0].numpy(), vj.route_id[:, 1:, 0].numpy()
    assert ids_t.min() >= 1 and ids_t.max() <= 5
    counts = np.stack([np.bincount(x.ravel(), minlength=6) for x in (ids_t, ids_j)])
    assert stats.chi2_contingency(counts[:, 1:]).pvalue > 1e-3
    assert stats.chisquare(counts[0, 1:], counts[0].sum() * np.arange(1, 6) / 15).pvalue > 1e-3
    np.testing.assert_allclose(vt.speed[:, 1:].numpy(), 26 - 3.4 * ids_t, rtol=1e-6)
    # the spawn chain: each gap is offset x U(0.9, 1.1), the ego's 4x
    x_t, x_j = vt.pos[..., 0].numpy(), vj.pos[..., 0].numpy()
    assert (np.diff(x_t, axis=1) > 0).all()

    def gap_factor(x, speed):
        offset = (1.0 / 1.5) * (12.0 + speed) * np.exp(-5.0 / 40.0 * 6)
        return np.diff(x, axis=1) / offset[:, 1:]

    f_t = gap_factor(x_t, vt.speed.numpy())
    f_j = gap_factor(x_j, vj.speed.numpy())
    assert f_t.min() > 0.9 - 1e-4 and f_t.max() < 1.1 + 1e-4
    _ks = stats.ks_2samp(f_t.ravel(), f_j.ravel()).pvalue
    assert _ks > 1e-3, _ks
    _ks = stats.ks_2samp(x_t[:, 0], x_j[:, 0]).pvalue
    assert _ks > 1e-3, _ks
    # lanes: the closest lane of the spawn (a spawn past x = 400 would land
    # on ("1", "2")), each NPC on its drawn lane id
    np.testing.assert_array_equal(
        vt.lane.numpy(), t_lane.closest_lane(et.geo, vt.pos, vt.heading).numpy())
    np.testing.assert_array_equal(et.geo.lane_id[vt.lane[:, 1:].long()].numpy(), ids_t)


def test_compact_autoreset_and_rollout():
    et = ht.make(ENV_ID, device="cpu")
    _, states = et.reset(6, et.generator(0))
    crashed = states.vehicles.crashed.clone()
    crashed[::2, 0] = True
    states = states.replace(vehicles=states.vehicles.replace(crashed=crashed))
    acts = torch.arange(6, dtype=torch.int32) % et.action_type.n
    g_full, g_compact = et.generator(7), et.generator(7)
    full = et.step_autoreset_batched(states, acts, g_full)
    compact = et.step_autoreset_batched(states, acts, g_compact, reset_slots=2)
    torch.testing.assert_close(compact[0], full[0], rtol=0, atol=0)
    torch.testing.assert_close(compact[5]["is_success"], full[5]["is_success"])
    for f in dataclasses.fields(VehicleState):
        torch.testing.assert_close(getattr(compact[1].vehicles, f.name),
                                   getattr(full[1].vehicles, f.name), rtol=0, atol=0)
    assert torch.equal(g_full.get_state(), g_compact.get_state())

    gen = et.generator(1)
    _, states = et.reset(4, gen)
    before = general_frames.frames_general_kernel.launches
    states, metrics = rollout(et, states, 3, gen)
    assert general_frames.frames_general_kernel.launches == before
    for name, value in metrics.items():
        assert value.shape == () and bool(torch.isfinite(value)), name
    envs = ht.make_vec(ENV_ID, 3, device="cpu", final_obs=True)
    obs, _ = envs.reset(seed=0)
    assert obs.shape == (3, 15, 7) and envs.single_observation_space.shape == (15, 7)
    obs, _, _, _, info = envs.step(np.ones(3, np.int64))
    assert info["is_success"].shape == (3,) and info["final_obs"].shape == (3, 15, 7)
    envs.close()
