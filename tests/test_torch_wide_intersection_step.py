"""One autoreset step of intersection-v0 with duration 30 (V=42) against the JAX package.

The scene of ``test_torch_wide_intersection.py`` (one jitted JAX reset
batch, ``spawn_probability`` 0, the NPCs moved up by 27 slots so that they
span the first two 32-slot words), with rows ending this step (a crashed
ego, or one policy step before ``duration``): one
``step_autoreset_batched`` from the same state and actions against the
JAX package's.  Obs, reward, terminated, truncated and info within 1e-5;
the rows that go on: the discrete fields (``lane``, ``target_lane``,
``route_ptr``, ``crashed``, ``hit``, ``impact_pending``, ``kind``,
``is_yielding``, ``yield_timer``) equal, pos, speed, heading and target
speed within 5e-4, the other continuous state within 1e-4 of its
magnitude; the done rows equal to the port's own reset from a clone of the
step's generator after the population hook's draws (one spawn attempt an
env), as in ``test_torch_intersection.py``.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import highwayenv_tpu as hj
import highwayenv_tpu_torch as ht
from highwayenv_tpu_torch.bridge import from_numpy_state
from highwayenv_tpu_torch.vehicle.state import VehicleState

torch.set_num_threads(1)

B = 4
SHIFT = 27  # NPC slot k moves to slot k + SHIFT
CONFIG = {"duration": 30, "spawn_probability": 0.0}
DISCRETE = ("lane", "target_lane", "route_ptr", "crashed", "hit", "impact_pending",
            "speed_index", "kind", "is_yielding", "yield_timer")
CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer", "impact", "steering",
              "accel")
STEP_ATOL = {"pos": 5e-4, "speed": 5e-4, "heading": 5e-4, "target_speed": 5e-4}
HEAD_ATOL = 1e-5

_SETUP: dict = {}


def _setup():
    """JAX env, port env, one jitted JAX reset batch with its NPCs moved up
    by SHIFT slots and the jitted JAX autoreset step, once per test
    process."""
    if not _SETUP:
        ej = hj.make("intersection-v0", CONFIG)
        et = ht.make("intersection-v0", CONFIG, device="cpu")
        _, states = jax.jit(jax.vmap(ej._reset))(
            jax.random.split(jax.random.PRNGKey(11), B))
        n = ej._n_npc
        order = np.concatenate([(np.arange(n) - SHIFT) % n, np.arange(n, ej.num_slots)])
        states = states.replace(vehicles=jax.tree.map(lambda x: x[:, order], states.vehicles))
        _SETUP.update(ej=ej, et=et, states=states, step=jax.jit(ej.step_autoreset_batched))
    return _SETUP


def _numpy_state(states) -> dict:
    return {"vehicles": {f.name: np.array(getattr(states.vehicles, f.name))
                         for f in dataclasses.fields(VehicleState)},
            "time": np.array(states.time), "steps": np.array(states.steps)}


def _close(a, b, atol, where):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=atol, err_msg=where)


def _assert_vehicles(port, ref, where, rows=slice(None)):
    for name in DISCRETE:
        np.testing.assert_array_equal(getattr(port, name).numpy()[rows],
                                      np.asarray(getattr(ref, name))[rows],
                                      err_msg=f"{where}: {name}")
    for name in CONTINUOUS:
        b = np.asarray(getattr(ref, name))[rows]
        tol = STEP_ATOL.get(name, 1e-4 * max(1.0, float(np.abs(b).max())))
        _close(getattr(port, name).numpy()[rows], b, tol, f"{where}: {name}")


def _ending(states, et, case):
    """Rows 0 and 2 end this step: a crashed ego, or one policy step left
    before ``duration``."""
    ending = np.arange(B) % 2 == 0
    if case == "crashed_ego":
        crashed = np.array(states.vehicles.crashed)
        crashed[ending, 41] = True
        return states.replace(vehicles=states.vehicles.replace(crashed=jnp.asarray(crashed)))
    time = np.array(states.time)
    time[ending] = et.config["duration"] - 1.0 / et.config["policy_frequency"]
    return states.replace(time=jnp.asarray(time))


@pytest.mark.parametrize("case", ["crashed_ego", "near_duration"])
def test_wide_step_autoreset_batched_matches_jax(case):
    s = _setup()
    et = s["et"]
    assert et.num_slots == 42
    sj = _ending(s["states"], et, case)
    st = from_numpy_state(_numpy_state(sj))
    acts = np.random.default_rng(12).integers(0, et.action_type.n, B).astype(np.int32)

    obs_j, st_j, rew_j, term_j, trunc_j, info_j = s["step"](sj, jnp.asarray(acts))
    gen = et.generator(5)
    gen_clone = et.generator(0)
    gen_clone.set_state(gen.get_state())
    obs_t, st_t, rew_t, term_t, trunc_t, info_t = et.step_autoreset_batched(
        st, torch.from_numpy(acts), gen)

    done = (term_t | trunc_t).numpy()
    np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j))
    np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j))
    assert done[::2].all() and not done[1::2].any()
    _close(rew_t, rew_j, HEAD_ATOL, "reward")
    _close(info_t["speed"], info_j["speed"], HEAD_ATOL, "info speed")
    np.testing.assert_array_equal(info_t["crashed"].numpy(), np.asarray(info_j["crashed"]))
    assert set(info_t["rewards"]) == set(info_j["rewards"])
    for name, value in info_t["rewards"].items():
        _close(value, info_j["rewards"][name], HEAD_ATOL, f"info rewards {name}")
    keep = ~done
    _close(obs_t.numpy()[keep], np.asarray(obs_j)[keep], HEAD_ATOL, "obs")
    np.testing.assert_array_equal(st_t.steps.numpy()[keep], np.asarray(st_j.steps)[keep])
    _assert_vehicles(st_t.vehicles, st_j.vehicles, case, keep)

    # done rows: the port's own reset from the generator after the hook's
    # draws (one spawn attempt per env)
    et.spawn_draws((B,), gen_clone)
    obs_r, st_r = et._reset(B, gen_clone)
    np.testing.assert_array_equal(obs_t.numpy()[done], obs_r.numpy()[done])
    for f in dataclasses.fields(VehicleState):
        np.testing.assert_array_equal(getattr(st_t.vehicles, f.name).numpy()[done],
                                      getattr(st_r.vehicles, f.name).numpy()[done],
                                      err_msg=f.name)
