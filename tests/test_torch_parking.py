"""parking-v0, parking-ActionRepeat-v0 and parking-parked-v0 in the port
against the JAX package, on the CPU.

The parking egos take a ContinuousAction on both axes, so every step runs
the general frame's raw-control branch (K4's ``raw_controls``; on CPU
tensors its plain version ``frames_general_plain``) on 2 x 14 spot lanes,
14 lanes an edge.  The observation is the KinematicsGoal dict.

- The placement fed the JAX package's own draws (the ego heading and the
  spot permutation of each reset key) equals the JAX reset: discrete fields
  exactly, floats within 4 ulp at the field's magnitude.
- The goal observation, ``compute_reward``, the reward, ``is_success``,
  terminated and truncated equal the JAX heads within 1e-5.
- Three policy steps of U(-1, 1) actions from a JAX reset batch, with egos
  set to hit a wall, the goal landmark, a parked car, and to run off the
  end of a spot lane (follow_road over the 14 lanes of the next edge),
  match the JAX steps (the XLA general frame): discrete fields exact, pos
  within 2e-4 m, other continuous state within 1e-4 of its magnitude, obs
  and reward within 1e-5.  One autoreset step holds the done rows to the
  port's own reset.
- The dict observation through the full and the compact autoreset, the
  ``final_obs`` order, the ``compact_reset`` and ``fresh_pool`` rollouts
  and the Gymnasium vector env.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from gymnasium import spaces
from gymnasium.vector.utils import batch_space

import highwayenv_tpu as hj
import highwayenv_tpu_torch as ht
from highwayenv_tpu_torch.bridge import from_numpy_state
from highwayenv_tpu_torch.envs.base import map_fields
from highwayenv_tpu_torch.parallel.rollout import obs_sum, rollout
from highwayenv_tpu_torch.vector_env import GymVectorEnv
from highwayenv_tpu_torch.vehicle.state import (
    KIND_EGO,
    KIND_LANDMARK,
    KIND_OBSTACLE,
    KIND_PLAIN,
    VehicleState,
)

torch.set_num_threads(1)

B = 8
ENV_IDS = ["parking-v0", "parking-ActionRepeat-v0", "parking-parked-v0"]
STATE_DISCRETE = ("lane", "target_lane", "crashed", "hit", "impact_pending",
                  "speed_index", "kind", "route_ptr")
STATE_CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer",
                    "impact", "steering", "accel")
HEAD_ATOL = 1e-5
OBS_KEYS = ("observation", "achieved_goal", "desired_goal")

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


def _jax_draws(keys):
    """The draws of the JAX reset of each key: the ego heading (1,) and the
    spot permutation (28,) (``BaseEnv._reset``, then
    ``ParkingEnv._reset_vehicles``)."""
    def one(key):
        kv, _ = jax.random.split(key)
        k_head, k_perm = jax.random.split(kv)
        return (2 * jnp.pi * jax.random.uniform(k_head, (1,)),
                jax.random.permutation(k_perm, 28))

    heading, perm = jax.vmap(one)(keys)
    return {"heading": torch.from_numpy(np.array(heading)),
            "perm": torch.from_numpy(np.array(perm)).long()}


def _setup(env_id):
    """JAX env, port env, the reset keys, a JAX reset batch and the jitted
    JAX step, built once per env so the step compiles once per process."""
    if env_id not in _SETUP:
        ej = hj.make(env_id)
        et = ht.make(env_id, device="cpu")
        keys = jax.random.split(jax.random.PRNGKey(3), B)
        obs, states = jax.vmap(ej._reset)(keys)
        _SETUP[env_id] = (ej, et, keys, obs, states, jax.jit(ej.step_batched))
    return _SETUP[env_id]


def _with(states, **fields):
    return states.replace(vehicles=states.vehicles.replace(
        **{k: jnp.asarray(v) for k, v in fields.items()}))


def _close(a, b, atol, where):
    np.testing.assert_allclose(
        np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=0,
        atol=atol, err_msg=where,
    )


def _ulps(a, b, where, ulps=4):
    """Exact for integers and booleans; floats within ``ulps`` at the
    field's magnitude."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, where
    if not np.issubdtype(b.dtype, np.floating):
        np.testing.assert_array_equal(a, b, err_msg=where)
        return
    scale = np.spacing(np.float32(max(float(np.abs(b).max(initial=0.0)), 1e-30)))
    np.testing.assert_allclose(a, b, rtol=0, atol=ulps * scale, err_msg=where)


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


def _assert_obs(ot, oj, rows, where=""):
    assert set(ot) == set(oj) == set(OBS_KEYS)
    for k in OBS_KEYS:
        assert ot[k].shape == (B, 6) and ot[k].dtype == torch.float32
        _close(ot[k].numpy()[rows], np.asarray(oj[k])[rows], HEAD_ATOL, f"{where}obs {k}")


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_placement_fed_jax_draws_matches_jax(env_id):
    ej, et, keys, obs_j, sj, _ = _setup(env_id)
    vt = et._place_vehicles(_jax_draws(keys))
    vj = sj.vehicles
    for f in dataclasses.fields(VehicleState):
        _ulps(getattr(vt, f.name).numpy(), np.asarray(getattr(vj, f.name)), f.name)
    st = et._place_state(_jax_draws(keys))
    _assert_obs(et._observe(st), obs_j, slice(None), "reset ")

    # the layout: egos | parked | goals | walls, the goal off the ego's spot
    n_parked = et.config["vehicles_count"]
    V = et.num_slots
    assert V == 2 + n_parked + 4 and et.max_edge_lanes == 14 and et.geo.num_lanes == 28
    kind = vt.kind[0].tolist()
    assert kind == ([KIND_EGO] + [KIND_PLAIN] * n_parked + [KIND_LANDMARK]
                    + [KIND_OBSTACLE] * 4)
    spots = torch.cat([vt.lane[:, 1:1 + n_parked], vt.lane[:, 1 + n_parked:2 + n_parked]],
                      dim=1)
    assert all(len(set(row)) == n_parked + 1 for row in spots.tolist())
    assert not (spots == vt.lane[:, :1]).any()
    assert not vt.crashed.any() and (vt.speed == 0).all()
    # the port's own draws: a permutation of the 28 spots, headings in [0, 2 pi)
    draws = et._reset_draws(64, et.generator(0))
    assert torch.equal(draws["perm"].sort(dim=1).values,
                       torch.arange(28).expand(64, 28))
    assert 0.0 <= float(draws["heading"].min()) and float(draws["heading"].max()) < 2 * np.pi


def _scenes(et, sj):
    """Rows set up to meet what a parking step meets: row 1's ego 3.5 m
    below the north wall heading for it at 6 m/s; row 3's 4 m behind its
    goal landmark, heading for it at 4 m/s; row 5's 2 m from the end of
    its spot lane ("a", "b", 3), its target, heading out of it at 3 m/s
    (follow_road takes a lane of the 14 of the next edge); on
    parking-parked-v0, row 7's 5.5 m behind its first parked car at 4 m/s."""
    v = {k: np.array(a) for k, a in _numpy_state(sj)["vehicles"].items()}
    goal = et.goal_slot_of(0)

    def put(row, pos, heading, speed, lane=None):
        v["pos"][row, 0] = pos
        v["heading"][row, 0] = heading
        v["speed"][row, 0] = speed
        if lane is not None:
            v["lane"][row, 0] = v["target_lane"][row, 0] = lane

    def behind(row, slot, gap, speed):
        h = float(v["heading"][row, slot])
        u = np.array([np.cos(h), np.sin(h)], np.float32)
        put(row, v["pos"][row, slot] - gap * u, h, speed)

    put(1, (0.0, 17.5), np.pi / 2, 6.0)
    behind(3, goal, 4.0, 4.0)
    end = et.net.global_lane_index(("a", "b", 3))
    put(5, et.net.get_lane(("a", "b", 3)).position(6.0, 0.0), np.pi / 2, 3.0, end)
    if et.config["vehicles_count"]:
        behind(7, 1, 5.5, 4.0)
    return _with(sj, **v), end


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_three_policy_steps_match_jax(env_id):
    ej, et, _, _, sj, jstep = _setup(env_id)
    sj, end = _scenes(et, sj)
    st = from_numpy_state(_numpy_state(sj))
    rng = np.random.default_rng(11)
    gen = et.generator(0)
    for t in range(3):
        acts = rng.uniform(-1.0, 1.0, (B, 2)).astype(np.float32)
        obs_j, sj, rew_j, term_j, trunc_j, info_j = jstep(sj, jnp.asarray(acts))
        obs_t, st, rew_t, term_t, trunc_t, info_t = et.step_batched(
            st, torch.from_numpy(acts), gen)
        where = f"{env_id} step {t}: "
        _assert_state(st.vehicles, sj.vehicles, slice(None), where)
        _assert_obs(obs_t, obs_j, slice(None), where)
        _close(rew_t, rew_j, HEAD_ATOL, where + "reward")
        for name, a, b in (("terminated", term_t, term_j), ("truncated", trunc_t, trunc_j),
                           ("is_success", info_t["is_success"], info_j["is_success"]),
                           ("crashed", info_t["crashed"], info_j["crashed"])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=where + name)
        assert set(info_t) == set(info_j)
        np.testing.assert_array_equal(st.steps.numpy(), np.asarray(sj.steps))
    veh = st.vehicles
    assert bool(veh.crashed[1, 0]), "row 1's ego did not hit the wall"
    # the landmark, not solid, is hit; nothing crashes
    goal = et.goal_slot_of(0)
    assert bool(veh.hit[3, goal]) and not bool(veh.crashed[3].any()), "row 3 and its goal"
    assert et.geo.edge_base[int(veh.target_lane[5, 0])] != et.geo.edge_base[end]
    if et.config["vehicles_count"]:
        assert bool(veh.crashed[7, 0]) and bool(veh.crashed[7, 1])


def test_goal_heads_match_jax():
    """The goal observation's rows (objects at zero velocity), the batched
    ``compute_reward``, the reward, ``is_success``, terminated and truncated
    against the JAX heads: rows 0 and 1 with the ego on its goal (success),
    row 2's ego crashed, row 4 at its last policy step; and the reward read
    from PARKING_OBS's features under another observation."""
    ej, et, _, _, sj, _ = _setup("parking-parked-v0")
    v = {k: np.array(a) for k, a in _numpy_state(sj)["vehicles"].items()}
    goal = et.goal_slot_of(0)
    v["pos"][:2, 0] = v["pos"][:2, goal]
    v["heading"][:2, 0] = v["heading"][:2, goal]
    v["speed"][:, goal] = 3.0  # a landmark reports no velocity
    v["crashed"][2, 0] = True
    v["speed"][:, 0] = np.linspace(0.0, 2.0, B)
    time = np.array(sj.time)
    time[4] = et.config["duration"]
    sj = _with(sj, **v).replace(time=jnp.asarray(time))
    st = from_numpy_state(_numpy_state(sj))
    act_j = jnp.zeros((B, 2), jnp.float32)

    heads_j = jax.vmap(lambda s, a: (ej._observe(s), ej._reward(s, a), ej._success(s),
                                     ej._is_terminated(s), ej._is_truncated(s)))(sj, act_j)
    act_t = torch.zeros(B, 2)
    obs_t = et._observe(st)
    _assert_obs(obs_t, heads_j[0], slice(None))
    assert obs_t["desired_goal"][:, 2:4].abs().max() == 0.0
    _close(et._reward(st, act_t), heads_j[1], HEAD_ATOL, "reward")
    for name, a, b in (("success", et._success(st), heads_j[2]),
                       ("terminated", et._is_terminated(st), heads_j[3]),
                       ("truncated", et._is_truncated(st), heads_j[4])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert et._success(st)[:2].all() and et._is_terminated(st)[2]
    assert et._is_truncated(st).tolist() == [i == 4 for i in range(B)]
    info = et._info(st, act_t)
    assert "rewards" not in info and torch.equal(info["is_success"], et._success(st))

    rng = np.random.default_rng(5)
    achieved, desired = (rng.normal(size=(3, 5, 6)).astype(np.float32) for _ in range(2))
    _close(et.compute_reward(achieved, desired), ej.compute_reward(achieved, desired),
           HEAD_ATOL, "compute_reward")
    _close(et.compute_reward(torch.from_numpy(achieved), torch.from_numpy(desired), p=1.0),
           ej.compute_reward(achieved, desired, p=1.0), HEAD_ATOL, "compute_reward p=1")

    config = {"observation": {"type": "Kinematics"}}
    et_k, ej_k = ht.make("parking-parked-v0", config, device="cpu"), hj.make(
        "parking-parked-v0", config)
    assert et_k.observation_space == ej_k.observation_space
    rew_j = jax.vmap(ej_k._reward)(sj, act_j)
    _close(et_k._reward(st, act_t), rew_j, HEAD_ATOL, "reward under Kinematics")


@pytest.mark.parametrize("case", ["crashed_ego", "near_duration"])
def test_step_autoreset_batched_matches_jax(case):
    """Rows 0, 2, 4 and 6 end this step (a crashed ego, or one policy step
    left before ``duration``); the rows that go on match the JAX step, the
    done rows equal the port's own reset from a clone of the generator."""
    ej, et, _, _, sj, jstep = _setup("parking-v0")
    ending = np.arange(B) % 2 == 0
    if case == "crashed_ego":
        crashed = np.array(sj.vehicles.crashed)
        crashed[ending, 0] = True
        sj = _with(sj, crashed=crashed)
    else:
        time = np.array(sj.time)
        time[ending] = et.config["duration"] - 1.0 / et.config["policy_frequency"]
        sj = sj.replace(time=jnp.asarray(time))
    st = from_numpy_state(_numpy_state(sj))
    acts = np.random.default_rng(12).uniform(-1.0, 1.0, (B, 2)).astype(np.float32)
    obs_j, st_j, rew_j, term_j, trunc_j, info_j = jstep(sj, jnp.asarray(acts))
    gen, gen_clone = et.generator(5), et.generator(0)
    gen_clone.set_state(gen.get_state())
    obs_t, st_t, rew_t, term_t, trunc_t, info_t = et.step_autoreset_batched(
        st, torch.from_numpy(acts), gen)

    done = (term_t | trunc_t).numpy()
    np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j))
    np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j))
    np.testing.assert_array_equal(info_t["is_success"].numpy(), np.asarray(info_j["is_success"]))
    assert done[::2].all() and not done[1::2].any()
    _close(rew_t, rew_j, HEAD_ATOL, "reward")
    keep = ~done
    _assert_obs(obs_t, obs_j, keep)
    _assert_state(st_t.vehicles, st_j.vehicles, keep)

    obs_r, st_r = et._reset(B, gen_clone)
    for k in OBS_KEYS:
        np.testing.assert_array_equal(obs_t[k].numpy()[done], obs_r[k].numpy()[done])
    for f in dataclasses.fields(VehicleState):
        np.testing.assert_array_equal(getattr(st_t.vehicles, f.name).numpy()[done],
                                      getattr(st_r.vehicles, f.name).numpy()[done],
                                      err_msg=f.name)


def _same(a, b, where):
    """Outputs of two autoreset steps: a dict observation key by key, a
    state field by field, a tensor; each within 4 ulp at its magnitude
    (the CPU's vectorized libm may round a row placed among P rows
    differently than among B)."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where} {k}")
    elif dataclasses.is_dataclass(a):
        map_fields(lambda x, y: _ulps(x.numpy(), y.numpy(), where), a, b)
    else:
        _ulps(a.numpy(), b.numpy(), where)


@pytest.mark.parametrize("slots", [4, 16])
def test_dict_observation_full_and_compact_autoreset_agree(slots):
    """The compact autoreset (``reset_slots``) with ``final_obs`` against
    the full autoreset on parking-v0 with every other ego crashed: the dict
    observations, states, rewards, flags and ``is_success`` agree, the
    generators advance alike."""
    et = ht.make("parking-v0", device="cpu")
    n = 16
    _, st = et.reset(n, et.generator(0))
    crashed = st.vehicles.crashed.clone()
    crashed[::2, 0] = True
    full = compact = st.replace(vehicles=st.vehicles.replace(crashed=crashed))
    g_full, g_compact = et.generator(5), et.generator(5)
    for t in range(3):
        acts = torch.empty(n, 2).uniform_(-1, 1, generator=g_full)
        torch.empty(n, 2).uniform_(-1, 1, generator=g_compact)
        out_f = et.step_autoreset_batched(full, acts, g_full)
        out_c = et._autoreset_rest(*et._autoreset_first(compact, acts, g_compact, slots,
                                                        final_obs=True))
        done = out_f[3] | out_f[4]
        if t == 0:
            assert int(done.sum()) == n // 2
        final = out_c[5]["final_obs"]
        assert set(final) == set(OBS_KEYS)
        assert not done.any() or not torch.equal(final["observation"][done],
                                                 out_c[0]["observation"][done])
        for name, a, b in (("obs", out_c[0], out_f[0]), ("state", out_c[1], out_f[1]),
                           ("reward", out_c[2], out_f[2]), ("terminated", out_c[3], out_f[3]),
                           ("truncated", out_c[4], out_f[4]),
                           ("is_success", out_c[5]["is_success"], out_f[5]["is_success"])):
            _same(a, b, f"P={slots} step {t} {name}")
        full, compact = out_f[1], out_c[1]
    assert torch.equal(g_full.get_state(), g_compact.get_state())


def test_dict_observation_through_the_rollouts():
    """``rollout`` with the compact autoreset equals the default one; the
    fresh-pool rollout (other scenes) runs; the checksum sums every field
    of the dict observation.  parking-v0 with ``duration`` 1 (5 policy
    steps), so episodes end by truncation."""
    et = ht.make("parking-v0", {"duration": 1}, device="cpu")
    _, st = et.reset(8, et.generator(0))
    out = {}
    for name, kw in (("default", {}), ("compact", {"compact_reset": 3}),
                     ("fresh_pool", {"fresh_pool": 3})):
        out[name] = rollout(et, map_fields(torch.clone, st), 7, et.generator(1), **kw)
    for name in ("default", "compact"):
        assert float(out[name][1]["done_rate"]) > 0
    _same(out["compact"][0], out["default"][0], "compact rollout state")
    _same(out["compact"][1], out["default"][1], "compact rollout metrics")
    fp = out["fresh_pool"][1]
    assert all(bool(torch.isfinite(v)) for v in fp.values()) and float(fp["done_rate"]) > 0
    obs, _ = et.reset(4, et.generator(2))
    assert torch.equal(obs_sum(obs), torch.stack([obs[k].sum() for k in obs]).sum())


def test_gymnasium_vector_env_takes_the_dict_space():
    envs = GymVectorEnv("parking-v0", 3, device="cpu", final_obs=True)
    single = hj.make("parking-v0").observation_space
    assert isinstance(envs.single_observation_space, spaces.Dict)
    assert envs.single_observation_space == single
    assert envs.observation_space == batch_space(single, 3)
    obs, _ = envs.reset(seed=0)
    assert set(obs) == set(OBS_KEYS)
    assert all(obs[k].shape == (3, 6) and obs[k].dtype == np.float32 for k in obs)
    assert envs.observation_space.contains(obs)
    obs, r, term, trunc, info = envs.step(envs.action_space.sample())
    assert envs.observation_space.contains(obs) and np.isfinite(r).all()
    assert info["is_success"].shape == (3,) and set(info["final_obs"]) == set(OBS_KEYS)
    assert info["final_obs"]["desired_goal"].shape == (3, 6)
    envs.close()
