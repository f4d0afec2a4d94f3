"""The reference's decision order (``sequential_decisions``) against the JAX package, on the CPU.

With ``config["sequential_decisions"]`` the NPCs decide vehicle after
vehicle in slot order, as the reference's ``road.act()`` does (PARITY.md
#1): the ego's action first, then slot by slot its ``follow_road`` and its
lane-change decision, each reading the target lanes the slots before it
wrote in the same frame (``vehicle/behavior.py::idm_act_sequential``).  The
mode runs the plain general frames on any road, straight ones too, and
launches no kernel.

  - three policy steps of ``step_batched`` from a port reset batch of 4
    against the JAX package's ``step_batched`` (its XLA ``_frame`` branch)
    at highway-v0 (12 vehicles), u-turn-v0 and (in
    test_torch_sequential_intersection.py) intersection-v0 (no spawns,
    which the JAX package draws from its own key), each step from the JAX
    state of the step before: discrete fields exact, pos within 2e-4 m,
    other state within 1e-4 of its magnitude, reward within 1e-5;
  - a built two-lane scene, one frame a step, in which slot 1 changes lanes
    in front of slot 2, already changing into the same lane: both packages'
    sequential modes abort slot 2's change, and the port's default mode,
    which decides on the frame-start targets, does not;
  - ``make`` applies no kernel limit to the mode (highway-v0 at V=51).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import highwayenv_tpu as hj
import highwayenv_tpu_torch as ht
from highwayenv_tpu.envs.base import EnvState as JaxEnvState
from highwayenv_tpu.vehicle.state import VehicleState as JaxVehicleState
from highwayenv_tpu_torch.bridge import from_numpy_state, to_numpy_state
from highwayenv_tpu_torch.ops import general_frames, straight_frames, straight_sorted
from highwayenv_tpu_torch.parallel.rollout import random_actions
from highwayenv_tpu_torch.vehicle.state import KIND_EGO, KIND_IDM, KIND_PAD

torch.set_num_threads(1)

SEQ = {"sequential_decisions": True}
B = 4
CONFIGS = {
    "highway-v0": {**SEQ, "vehicles_count": 12},
    "u-turn-v0": SEQ,
    "intersection-v0": {**SEQ, "spawn_probability": 0.0},
}
DISCRETE = ("lane", "target_lane", "route_ptr", "crashed", "hit", "impact_pending",
            "speed_index", "kind", "is_yielding", "yield_timer")
CONTINUOUS = ("heading", "speed", "target_speed", "timer", "impact", "steering", "accel")
POS_ATOL = 2e-4
HEAD_ATOL = 1e-5
KERNELS = (straight_frames.frames_kernel, straight_sorted.sort_kernel,
           straight_sorted.frames_sorted_kernel, straight_sorted.unsort_kernel,
           general_frames.frames_general_kernel, general_frames.frames_regulated_kernel)


def _jax_state(states, seed: int = 0):
    d = to_numpy_state(states)
    return JaxEnvState(
        vehicles=JaxVehicleState(**{k: jnp.asarray(v) for k, v in d["vehicles"].items()}),
        time=jnp.asarray(d["time"]), steps=jnp.asarray(d["steps"]),
        key=jax.random.split(jax.random.PRNGKey(seed), d["time"].shape[0]),
    )


def _port_state(sj):
    return from_numpy_state({
        "vehicles": {k: np.asarray(v) for k, v in vars(sj.vehicles).items()},
        "time": np.asarray(sj.time), "steps": np.asarray(sj.steps),
    })


def _close(a, b, atol, where):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=atol, err_msg=where)


def held_to_jax(env_id):
    """Three steps of the port's sequential mode against the JAX package's."""
    cfg = CONFIGS[env_id]
    ej, et = hj.make(env_id, cfg), ht.make(env_id, cfg, device="cpu")
    assert et._straight is None and et._general.sequential
    step_j = jax.jit(ej.step_batched)
    gen = et.generator(7)
    _, st = et.reset(B, gen)
    sj = _jax_state(st, 7)
    launches = [k.launches for k in KERNELS]
    for step in range(3):
        acts = random_actions(et, B, gen)
        _, sj, rew_j, term_j, trunc_j, _ = step_j(sj, jnp.asarray(acts.numpy()))
        _, st_t, rew_t, term_t, trunc_t, _ = et.step_batched(st, acts, et.generator(100))
        where = f"{env_id} step {step}"
        np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j), err_msg=where)
        np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j), err_msg=where)
        _close(rew_t, rew_j, HEAD_ATOL, f"{where} reward")
        vt, vj = st_t.vehicles, sj.vehicles
        for name in DISCRETE:
            np.testing.assert_array_equal(getattr(vt, name).numpy(),
                                          np.asarray(getattr(vj, name)),
                                          err_msg=f"{where} {name}")
        _close(vt.pos.numpy(), np.asarray(vj.pos), POS_ATOL, f"{where} pos")
        for name in CONTINUOUS:
            b = np.asarray(getattr(vj, name))
            _close(getattr(vt, name).numpy(), b, 1e-4 * max(1.0, float(np.abs(b).max())),
                   f"{where} {name}")
        st = _port_state(sj)
    assert [k.launches for k in KERNELS] == launches  # no kernel in this mode


@pytest.mark.parametrize("env_id", ["highway-v0", "u-turn-v0"])
def test_sequential_steps_match_jax(env_id):
    """intersection-v0's case is in test_torch_sequential_intersection.py
    (its JAX step compiles for about a minute on the CPU)."""
    held_to_jax(env_id)


def _conflict_scene(env):
    """One env on two lanes: the ego far behind; slot 1 at x=130 on lane 0
    behind the slow slot 3 at x=145, its lane-change timer due, lane 1 free;
    slot 2 at x=110 on lane 0, already changing into lane 1, 20 m behind
    slot 1."""
    _, st = env.reset(1, env.generator(0))
    veh = st.vehicles
    V = veh.kind.shape[1]
    kind = torch.full((1, V), KIND_PAD, dtype=torch.int32)
    kind[0, 0], kind[0, 1:4] = KIND_EGO, KIND_IDM
    pos = torch.zeros((1, V, 2))
    pos[0, :4, 0] = torch.tensor([0.0, 130.0, 110.0, 145.0])
    pos[0, 4:, 0] = torch.arange(V - 4) * 10.0 - 1000.0
    speed = torch.tensor([[20.0, 25.0, 25.0, 10.0] + [0.0] * (V - 4)])
    lane = torch.zeros((1, V), dtype=torch.int32)
    target = lane.clone()
    target[0, 2] = 1
    veh = veh.replace(
        kind=kind, pos=pos, heading=torch.zeros((1, V)), speed=speed,
        target_speed=speed.clone(), lane=lane, target_lane=target,
        timer=torch.tensor([[0.0, 2.0, 0.0, 0.0] + [0.0] * (V - 4)]),
        crashed=torch.zeros((1, V), dtype=torch.bool),
    )
    return st.replace(vehicles=veh)


def test_same_frame_conflict_aborts_the_later_slot():
    base = {"lanes_count": 2, "vehicles_count": 3, "simulation_frequency": 15,
            "policy_frequency": 15}
    targets = {}
    for label, cfg in (("sequential", {**base, **SEQ}), ("parallel", base)):
        et = ht.make("highway-v0", cfg, device="cpu")
        ej = hj.make("highway-v0", cfg)
        assert et.frames_per_step == 1
        st = _conflict_scene(et)
        act = torch.ones(1, dtype=torch.int32)  # IDLE
        _, st_t, *_ = et.step_batched(st, act, et.generator(0))
        _, sj, *_ = jax.jit(ej.step_batched)(_jax_state(st), jnp.asarray(act.numpy()))
        targets[label] = (st_t.vehicles.target_lane[0, 1:3].tolist(),
                          np.asarray(sj.vehicles.target_lane)[0, 1:3].tolist())
    # slot 1 moves into lane 1 in every mode
    assert targets["sequential"] == ([1, 0], [1, 0])  # slot 2 aborted, both packages
    # the default mode decides on the frame-start targets: no conflict seen
    assert targets["parallel"] == ([1, 1], [1, 1])


def test_sequential_make_has_no_kernel_limits():
    env = ht.make("highway-v0", SEQ, device="cpu")
    assert env.num_slots == 51 and env._general.sequential and env._straight is None
    gen = env.generator(0)
    _, st = env.reset(1, gen)
    obs, st, reward, *_ = env.step_batched(st, random_actions(env, 1, gen), gen)
    assert bool(torch.isfinite(st.vehicles.pos).all()) and bool(torch.isfinite(reward).all())
