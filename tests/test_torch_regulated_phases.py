"""The regulated step at every tick phase, against the JAX package's frames one by one, on the CPU.

On a regulated road (the intersection ids) a frame is a right-of-way tick
when ``(steps + i + 1) % 7 == 0``, ``steps`` the env's frame counter at the
policy step's start and ``i`` the frame within the step (HighwayEnv's
``RegulatedRoad.step`` counts every frame and enforces on every seventh).
The JAX package's traced schedule, ``BaseEnv._simulate_regulated_frames``
(``highwayenv_tpu/envs/base.py:496``), runs its masked prologue under
``j < i0`` without ``j < frames``: a step of fewer frames than the period
runs up to ``i0`` frames there.  So the oracle here is the JAX package's
``BaseEnv._frame`` (``:294``) applied frame by frame, put in the JAX env's
place of that schedule on the test's instance: ``first`` on frame 0 and
``enforce`` on the frames where ``(steps + i + 1) % 7 == 0``, nothing else
(``_run_frames_static``, the warm-up's schedule, passes ``first=False`` on
every frame and is not the oracle either).

Held here: intersection-v0 at ``policy_frequency`` 15 (one frame a step,
V=207: the cluster K5 on the card) and at 3 (five frames a step, V=51: the
wide K5), ``spawn_probability`` 0 (the JAX package draws spawns from its
own keys), from a port reset batch of 7 rows whose frame counters sit at
the 7 tick phases, 3 policy steps of ``step_batched``, each from the JAX
state of the step before (so every row visits three phases, and at
``policy_frequency`` 3 a step holds 0 or 1 ticks by its phase): discrete
fields (the yielding state and its timer among them) exactly, pos within
2e-4 m, the other continuous state within 1e-4 of its magnitude, obs and
reward within 1e-5.
"""

import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import highwayenv_tpu as hj
import highwayenv_tpu_torch as ht
from highwayenv_tpu.envs.base import EnvState as JaxEnvState
from highwayenv_tpu.road import lane as jax_lane
from highwayenv_tpu.vehicle.state import VehicleState as JaxVehicleState
from highwayenv_tpu_torch.bridge import from_numpy_state, to_numpy_state
from highwayenv_tpu_torch.ops import general_frames
from highwayenv_tpu_torch.parallel.rollout import random_actions
from highwayenv_tpu_torch.vehicle.state import VehicleState

torch.set_num_threads(1)

PERIOD = 7
B = PERIOD  # one row a tick phase
STEPS = 3
DISCRETE = ("lane", "target_lane", "route_ptr", "crashed", "hit", "impact_pending",
            "speed_index", "kind", "is_yielding", "yield_timer")
CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer", "impact", "steering",
              "accel")
POS_ATOL = 2e-4
REL_TOL = 1e-4
HEAD_ATOL = 1e-5

#: (policy frequency, slots, frames a step)
RATES = [(15, 207, 1), (3, 51, 5)]


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


def _frames_one_by_one(self, veh, slot_actions, steps0, frames):
    """The regulated frames of a policy step as HighwayEnv runs them: the
    JAX package's ``_frame`` on each, ``first`` on frame 0, ``enforce`` on
    the frames whose counter completes a period."""
    period = self._regulation_period

    def body(carry, i):
        v, tables = carry
        enforce = (steps0 + i + 1) % period == 0
        return self._frame(v, tables, slot_actions, i == 0, enforce=enforce), None

    carry = (veh, jax_lane.projection_table(self.geo, veh.pos))
    (veh, _), _ = jax.lax.scan(body, carry, jnp.arange(frames))
    return veh


def _close(a, b, atol, where):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=atol, err_msg=where)


@pytest.mark.parametrize("frequency,V,frames", RATES, ids=[f"pf{r[0]}" for r in RATES])
def test_regulated_step_matches_the_frames_at_every_tick_phase(frequency, V, frames):
    config = {"policy_frequency": frequency, "spawn_probability": 0.0}
    ej, et = hj.make("intersection-v0", config), ht.make("intersection-v0", config,
                                                         device="cpu")
    assert ej.num_slots == et.num_slots == V and et.frames_per_step == frames
    assert et._general.period == ej._regulation_period == PERIOD
    ej._simulate_regulated_frames = types.MethodType(_frames_one_by_one, ej)
    step_j = jax.jit(ej.step_batched)
    gen = et.generator(11)
    _, st = et.reset(B, gen)
    # row b's counter at phase b
    st = st.replace(steps=st.steps - st.steps % PERIOD + torch.arange(B, dtype=torch.int32))
    sj = _jax_state(st, 11)
    ticks = 0
    for step in range(STEPS):
        phase = st.steps % PERIOD
        assert sorted(phase.tolist()) == list(range(PERIOD))
        # the rows whose step holds a tick: frame 6 - p under the step's frames
        ticks += sum(PERIOD - 1 - p < frames for p in phase.tolist())
        acts = random_actions(et, B, gen)
        obs_j, sj, rew_j, term_j, trunc_j, _ = step_j(sj, jnp.asarray(acts.numpy()))
        obs_t, st_t, rew_t, term_t, trunc_t, _ = et.step_batched(
            st, acts, et.generator(100 + step))
        where = f"policy_frequency {frequency} step {step}"
        np.testing.assert_array_equal(st_t.steps.numpy(), np.asarray(sj.steps), err_msg=where)
        np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j), err_msg=where)
        np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j), err_msg=where)
        _close(rew_t, rew_j, HEAD_ATOL, f"{where} reward")
        _close(obs_t, obs_j, HEAD_ATOL, f"{where} obs")
        vt, vj = st_t.vehicles, sj.vehicles
        for name in DISCRETE:
            np.testing.assert_array_equal(getattr(vt, name).numpy(),
                                          np.asarray(getattr(vj, name)),
                                          err_msg=f"{where} {name}")
        for name in CONTINUOUS:
            b = np.asarray(getattr(vj, name))
            tol = POS_ATOL if name == "pos" else REL_TOL * max(1.0, float(np.abs(b).max()))
            _close(getattr(vt, name).numpy(), b, tol, f"{where} {name}")
        st = _port_state(sj)  # the next step from the JAX state
    # a step of F frames ticks at F of the 7 phases, and leaves the others
    assert ticks == STEPS * frames


def test_the_port_ticks_on_the_frames_whose_counter_completes_a_period():
    """The port's plain frames tick at ``(steps0 + i + 1) % period == 0``:
    a one-frame step of a row at phase 6 runs the right-of-way pass (which
    releases the expired yielders), at any other phase it does not."""
    env = ht.make("intersection-v0", {"policy_frequency": 15}, device="cpu")
    _, st = env.reset(B, env.generator(2))
    spec = env._general
    veh = st.vehicles
    # every vehicle yielding with an expired timer: a tick releases it
    veh = veh.replace(is_yielding=veh.is_vehicle.clone(),
                      yield_timer=torch.full_like(veh.yield_timer, 5))
    steps0 = torch.arange(B, dtype=torch.int32)
    sa = env._action_to_slots(random_actions(env, B, env.generator(3)))
    out = general_frames.frames_general_plain(veh, spec, sa, 1, steps0)
    released = ~out.is_yielding & veh.is_yielding
    ticked = released.any(dim=1)
    assert ticked.tolist() == [p == PERIOD - 1 for p in range(B)]
