"""intersection-v1 against the JAX package, on the CPU.

The port's ``ContinuousIntersectionEnv`` (a dynamical ContinuousAction ego
on the tire-slip model, steering within +-pi/3, on K5's raw branch with the
dynamical override) against ``highwayenv_tpu/envs/intersection.py``'s:
three policy steps of ``step_batched`` from a port reset batch, each from
the JAX state of the step before, no spawns (``spawn_probability`` 0: the
JAX package draws them from its own keys): the observation (5 vehicles,
``presence x y vx vy long_off lat_off ang_off``) and the reward within
1e-5, the flags and the discrete state exactly, pos within 2e-4 m, the
other continuous state within 1e-4 of its magnitude (the ego's lateral
speed and yaw rate included).  Then an autoreset step with every other ego
crashed (the head against the JAX package's, the compact autoreset against
the full one within 4 ulp), and the new Kinematics features against the JAX package's
``observations/kinematics.py`` on scenes with every row off its lane's
centre and heading.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import highwayenv_tpu as hj
import highwayenv_tpu_torch as ht
from highwayenv_tpu.envs.base import EnvState as JaxEnvState
from highwayenv_tpu.observations.kinematics import KinematicsObservation as JaxKinematics
from highwayenv_tpu.vehicle.state import VehicleState as JaxVehicleState
from highwayenv_tpu_torch.bridge import from_numpy_state, to_numpy_state
from highwayenv_tpu_torch.observations.kinematics import KinematicsObservation
from highwayenv_tpu_torch.parallel.rollout import random_actions
from highwayenv_tpu_torch.vehicle.state import KIND_EGO, VehicleState

torch.set_num_threads(1)

ENV_ID = "intersection-v1"
B = 4
CONFIG = {"spawn_probability": 0.0}
DISCRETE = ("lane", "target_lane", "route_ptr", "crashed", "hit", "impact_pending",
            "speed_index", "kind", "is_yielding", "yield_timer")
CONTINUOUS = ("pos", "heading", "speed", "lateral_speed", "yaw_rate", "target_speed",
              "timer", "steering", "accel")
HEAD_ATOL = 1e-5
POS_ATOL = 2e-4
REL_TOL = 1e-4
FEATURES = ["presence", "x", "y", "vx", "vy", "long_off", "lat_off", "ang_off"]


def _jax_state(states, seed: int) -> JaxEnvState:
    d = to_numpy_state(states)
    return JaxEnvState(
        vehicles=JaxVehicleState(**{k: jnp.asarray(v) for k, v in d["vehicles"].items()}),
        time=jnp.asarray(d["time"]), steps=jnp.asarray(d["steps"]),
        key=jax.random.split(jax.random.PRNGKey(seed), d["time"].shape[0]),
    )


def _port_state(sj):
    return from_numpy_state({
        "vehicles": {f.name: np.asarray(getattr(sj.vehicles, f.name))
                     for f in dataclasses.fields(VehicleState)},
        "time": np.asarray(sj.time), "steps": np.asarray(sj.steps),
    })


@functools.cache
def _jax_step():
    """The JAX package's jitted ``step_batched``, compiled once a process."""
    return jax.jit(hj.make(ENV_ID, CONFIG).step_batched)


def _close(a, b, atol, where):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=atol, err_msg=where)


def _same(a, b, where):
    """Exact for integers and booleans, within 4 ulp at the magnitude for
    floats: the CPU's vectorized libm may round a row warmed up among P
    rows differently from the same row among B (chip_smoke.py holds the
    compact autoreset bit-exact on the card)."""
    a, b = a.numpy(), b.numpy()
    if not np.issubdtype(b.dtype, np.floating):
        np.testing.assert_array_equal(a, b, err_msg=where)
        return
    scale = np.spacing(np.float32(max(float(np.abs(b).max(initial=0.0)), 1e-30)))
    np.testing.assert_allclose(a, b, rtol=0, atol=4 * scale, err_msg=where)


def _check_state(vt, vj, where: str) -> None:
    for name in DISCRETE:
        np.testing.assert_array_equal(getattr(vt, name).numpy(), np.asarray(getattr(vj, name)),
                                      err_msg=f"{where} {name}")
    for name in CONTINUOUS:
        b = np.asarray(getattr(vj, name))
        tol = POS_ATOL if name == "pos" else REL_TOL * max(1.0, float(np.abs(b).max()))
        _close(getattr(vt, name).numpy(), b, tol, f"{where} {name}")


def test_registered_on_k5_with_the_dynamical_flag():
    et = ht.make(ENV_ID, device="cpu")
    assert et.regulated and et._general.dynamical and not et._general.connected
    assert et.action_type.stores_raw_controls and et.action_type.dynamical
    assert et.action_shape == (2,) and et.ego_slots == (24,)
    # the warm-up runs on the first 16 slots, none of them the ego's
    assert et._warmup_slots == 16 < et.ego_slots[0]
    assert et.observation_type.features == tuple(FEATURES)
    assert et.observation_space == hj.make(ENV_ID).observation_space


def test_steps_match_jax():
    et = ht.make(ENV_ID, CONFIG, device="cpu")
    step_j = _jax_step()
    gen = et.generator(6)
    _, st = et.reset(B, gen)
    sj = _jax_state(st, 6)
    for step in range(3):
        acts = random_actions(et, B, gen)
        assert acts.shape == (B, 2) and acts.dtype == torch.float32
        obs_j, sj, rew_j, term_j, trunc_j, info_j = step_j(sj, jnp.asarray(acts.numpy()))
        obs_t, st_t, rew_t, term_t, trunc_t, info_t = et.step_batched(
            st, acts, et.generator(100 + step))
        where = f"step {step}"
        assert obs_t.shape == (B, 5, 8)
        _close(obs_t, obs_j, HEAD_ATOL, f"{where} obs")
        _close(rew_t, rew_j, HEAD_ATOL, f"{where} reward")
        np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j))
        np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j))
        for name, value in info_t["rewards"].items():
            _close(value, info_j["rewards"][name], HEAD_ATOL, f"{where} {name}")
        _check_state(st_t.vehicles, sj.vehicles, where)
        ego = st_t.vehicles.kind == KIND_EGO
        assert bool((st_t.vehicles.yaw_rate[ego] != 0).all())
        st = _port_state(sj)


@pytest.mark.parametrize("slots", [1, 2])
def test_autoreset_step_with_crashed_egos(slots):
    """Every other ego crashed: the head of the autoreset step (reward and
    flags) as the JAX package's step (``step_batched``: the autoreset draws
    its scenes from the JAX package's own keys), the done rows replaced by
    fresh scenes, and the compact autoreset equal to the full one (``_same``)."""
    et = ht.make(ENV_ID, CONFIG, device="cpu")
    _, st = et.reset(B, et.generator(2))
    crashed = st.vehicles.crashed.clone()
    crashed[::2, 24] = True
    st = st.replace(vehicles=st.vehicles.replace(crashed=crashed))
    acts = random_actions(et, B, et.generator(3))
    full = et.step_autoreset_batched(st, acts, et.generator(9))
    compact = et.step_autoreset_batched(st, acts, et.generator(9), reset_slots=slots)
    out_j = _jax_step()(_jax_state(st, 2), jnp.asarray(acts.numpy()))
    _close(full[2], out_j[2], HEAD_ATOL, "reward")
    np.testing.assert_array_equal(full[3].numpy(), np.asarray(out_j[3]))
    np.testing.assert_array_equal(full[4].numpy(), np.asarray(out_j[4]))
    done = full[3] | full[4]
    assert bool(done[::2].all())
    # the done rows start their episode: the frame counter after the warm-up
    assert full[1].steps[done].tolist() == [et._initial_steps] * int(done.sum())
    assert full[1].steps[~done].tolist() == [et._initial_steps + 15] * int((~done).sum())
    _same(compact[0], full[0], "obs")
    for f in dataclasses.fields(VehicleState):
        _same(getattr(compact[1].vehicles, f.name), getattr(full[1].vehicles, f.name), f.name)
    for name, a, b in zip(("reward", "terminated", "truncated"), compact[2:5], full[2:5]):
        _same(a, b, name)


@pytest.mark.parametrize("absolute,ranges", [(True, True), (False, False)],
                         ids=["absolute-ranged", "relative-normalized"])
def test_lane_offset_features_match_jax(absolute, ranges):
    et = ht.make(ENV_ID, device="cpu")
    _, st = et.reset(B, et.generator(4))
    rng = np.random.default_rng(4)
    veh = st.vehicles
    # every row off its lane's centre line and heading, past the lane's ends too
    veh = veh.replace(
        pos=veh.pos + torch.from_numpy(rng.normal(0.0, 3.0, veh.pos.shape).astype(np.float32)),
        heading=veh.heading + torch.from_numpy(
            rng.uniform(-4.0, 4.0, veh.heading.shape).astype(np.float32)),
    )
    kw = dict(features=FEATURES, vehicles_count=5, absolute=absolute,
              features_range=({"x": [-100, 100], "y": [-100, 100], "vx": [-20, 20],
                               "vy": [-20, 20]} if ranges else None))
    obs_t = KinematicsObservation(**kw).observe(et.geo, veh, 24)
    ej = hj.make(ENV_ID)
    vj = _jax_state(st.replace(vehicles=veh), 0).vehicles
    obs_j = jax.vmap(lambda v: JaxKinematics(**kw).observe(ej.geo, v, 24))(vj)
    assert obs_t.shape == (B, 5, 8)
    _close(obs_t, obs_j, HEAD_ATOL, "obs")
    # the offsets are those of each row's own lane
    assert float(obs_t[..., 6].abs().max()) > 1.0 and float(obs_t[..., 7].abs().max()) > 1.0
