"""Scenes over the narrow general kernels' limits on the CPU: the gate, the wide routing.

The narrow K4 / K5 hold an env in one warp (at most 32 slots); the wide
ones (``csrc/general_frames_wide.cu``) hold one in a block of 128 threads,
and the lane tables hold 64 lanes.  ``make`` now accepts scenes users reach
with ordinary settings, which it refused before: exit-v0 at highway-v0's
density (V=51), racetrack-v0 with 40 NPCs (V=41), racetrack-oval-v0 with 5
or 6 lanes (L=40, 48), intersection-v0 at longer durations or twice the
policy frequency (V=33 to 43; ``test_torch_wide_intersection.py`` steps
it).  On the CPU every instantiation runs ``frames_general_plain``, which
takes any V; here

  - exit-v0 with 50 vehicles and racetrack-oval-v0 with 6 lanes take 3
    ``step_batched`` steps from a port reset batch against the JAX
    package's (its XLA frames: the JAX kernels' gate stops at 32 slots and
    32 lanes), each step from the JAX state of the step before: discrete
    fields equal, pos, speed and heading within 5e-4, the other state
    within 1e-4 of its magnitude, obs and reward within 1e-5;
  - every scene of that list is made, its launch tables and parameter block
    built as a launch builds them, and the instantiation it routes to
    (``frames_kernel_for``) asserted: the wide twin over 32 slots, the
    narrow one at and under 32; a CPU rollout launches no kernel.
"""

import dataclasses

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
from highwayenv_tpu_torch.ops import general_frames
from highwayenv_tpu_torch.parallel.rollout import random_actions, rollout
from highwayenv_tpu_torch.vehicle.state import VehicleState

torch.set_num_threads(1)

B = 8
STEPS = 3
DISCRETE = ("lane", "target_lane", "route_ptr", "crashed", "hit", "impact_pending",
            "speed_index", "kind")
CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer", "impact", "steering",
              "accel")
STEP_ATOL = {"pos": 5e-4, "speed": 5e-4, "heading": 5e-4}
HEAD_ATOL = 1e-5
DYNAMICAL = {"action": {"type": "ContinuousAction", "dynamical": True}}

#: (env id, config, V, L, the wrapper the scene routes to)
SCENES = [
    ("intersection-v0", {"duration": 21}, 33, 20, "frames_regulated_wide_kernel"),
    ("intersection-v0", {"duration": 30}, 42, 20, "frames_regulated_wide_kernel"),
    ("intersection-v0", {"policy_frequency": 2}, 38, 20, "frames_regulated_wide_kernel"),
    ("intersection-multi-agent-v0", {"duration": 30}, 43, 20,
     "frames_regulated_wide_kernel"),
    ("intersection-v1", {"duration": 30}, 42, 20, "frames_regulated_dynamical_wide_kernel"),
    ("intersection-v2", {"duration": 30}, 42, 20, "frames_regulated_connected_wide_kernel"),
    ("exit-v0", {"vehicles_count": 50}, 51, 20, "frames_general_wide_kernel"),
    ("exit-v1", {"vehicles_count": 50}, 51, 20, "frames_general_connected_wide_kernel"),
    ("racetrack-v0", {"other_vehicles": 40}, 41, 18, "frames_general_wide_kernel"),
    ("racetrack-v0", {"other_vehicles": 40, **DYNAMICAL}, 41, 18,
     "frames_general_dynamical_wide_kernel"),
    ("racetrack-oval-v0", {"no_lanes": 5}, 2, 40, "frames_general_kernel"),
    ("racetrack-oval-v0", {"no_lanes": 6}, 2, 48, "frames_general_kernel"),
    ("intersection-v0", {"duration": 20}, 32, 20, "frames_regulated_kernel"),
    ("intersection-v0", {"duration": 116}, 128, 20, "frames_regulated_wide_kernel"),
]
SCENE_IDS = [f"{e}-{'-'.join(f'{k}{v}' for k, v in c.items() if k != 'action')}"
             + ("-dynamical" if "action" in c else "") for e, c, *_ in SCENES]
STEP_SCENES = [("exit-v0", {"vehicles_count": 50}), ("racetrack-oval-v0", {"no_lanes": 6})]


def _jax_state(states, seed: int):
    """A port EnvState as the JAX package's, with per-env keys."""
    d = to_numpy_state(states)
    n = d["time"].shape[0]
    return JaxEnvState(
        vehicles=JaxVehicleState(**{k: jnp.asarray(v) for k, v in d["vehicles"].items()}),
        time=jnp.asarray(d["time"]), steps=jnp.asarray(d["steps"]),
        key=jax.random.split(jax.random.PRNGKey(seed), n),
    )


def _port_state(states):
    return from_numpy_state({
        "vehicles": {f.name: np.asarray(getattr(states.vehicles, f.name))
                     for f in dataclasses.fields(VehicleState)},
        "time": np.asarray(states.time), "steps": np.asarray(states.steps),
    })


def _close(a, b, atol, where):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=atol, err_msg=where)


@pytest.mark.parametrize("env_id,config", STEP_SCENES, ids=[e for e, _ in STEP_SCENES])
def test_steps_over_the_narrow_limits_match_jax(env_id, config):
    ej, et = hj.make(env_id, config), ht.make(env_id, config, device="cpu")
    assert ej.num_slots == et.num_slots and ej.geo.num_lanes == et.geo.num_lanes
    assert et.num_slots > general_frames.NARROW_SLOTS or et.geo.num_lanes > 32
    step_j = jax.jit(ej.step_batched)
    gen = et.generator(5)
    _, st = et.reset(B, gen)
    sj = _jax_state(st, 5)
    for step in range(STEPS):
        acts = random_actions(et, B, gen)
        obs_j, sj, rew_j, term_j, trunc_j, _ = step_j(sj, jnp.asarray(acts.numpy()))
        obs_t, st_t, rew_t, term_t, trunc_t, _ = et.step_batched(
            st, acts, et.generator(100 + step))
        where = f"{env_id} step {step}"
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
            tol = STEP_ATOL.get(name, 1e-4 * max(1.0, float(np.abs(b).max())))
            _close(getattr(vt, name).numpy(), b, tol, f"{where} {name}")
        st = _port_state(sj)  # the next step from the JAX state
    # exit-v0's scene fills more than the narrow kernels' 32 slots
    live = (st.vehicles.kind != 0).sum(dim=1)
    assert et.num_slots <= 32 or int(live.min()) > 32, live


def _launch_tables(env):
    """What a launch of env's frame kernel builds from the env: the lane
    tables, the candidate tables (connected) and the parameter block."""
    _, st = env.reset(2, env.generator(0))
    veh = st.vehicles
    assert veh.route_base.shape[-1] == env.route_slots
    lanes_f, lanes_i = general_frames.lane_tables(env.geo, env.device)
    assert lanes_f.shape[0] == lanes_i.shape[0] == env.geo.num_lanes
    if env._general.connected:
        general_frames.conn_tables(env.geo, env.device)
    return veh, general_frames.kernel_params(
        env._general, env.num_slots, env.route_slots, env.frames_per_step,
        raw=env.action_type.stores_raw_controls, linear=env.linear_rows)


@pytest.mark.parametrize("env_id,config,V,L,wrapper", SCENES, ids=SCENE_IDS)
def test_scene_makes_and_routes_to_its_instantiation(env_id, config, V, L, wrapper):
    env = ht.make(env_id, config, device="cpu")
    assert (env.num_slots, env.geo.num_lanes) == (V, L)
    veh, params = _launch_tables(env)
    assert (params.V, params.L, params.M) == (V, L, env.max_edge_lanes)
    kernel = general_frames.frames_kernel_for(env._general, env.regulated, V)
    assert kernel is getattr(general_frames, wrapper)
    wide = V > general_frames.NARROW_SLOTS
    assert kernel.wide == wide and kernel.entry == getattr(general_frames, wrapper).entry
    assert kernel.source == ("general_frames_wide" if wide else "general_frames")
    assert kernel.max_slots >= V
    if env.regulated:
        # the reset's warm-up keeps 16 slots: the narrow K5 of the same law
        W = env._warmup_slots
        assert W == 16
        warm = general_frames.frames_kernel_for(env._general, True, W)
        assert not warm.wide and warm.entry == kernel.entry


def test_wide_wrappers_run_the_plain_frames_on_the_cpu():
    """Every wide wrapper runs ``frames_general_plain`` on CPU tensors and
    counts no launch; the narrow wrappers too, at any V (only a CUDA launch
    is bounded by the library's slots)."""
    env = ht.make("exit-v0", {"vehicles_count": 50}, device="cpu")
    gen = env.generator(1)
    _, st = env.reset(4, gen)
    sa = env._action_to_slots(random_actions(env, 4, gen))
    want = general_frames.frames_general_plain(st.vehicles, env._general, sa,
                                               env.frames_per_step)
    for kernel in (general_frames.frames_general_wide_kernel,
                   general_frames.frames_general_kernel):
        before = kernel.launches
        got = kernel(st.vehicles, env._general, sa, env.frames_per_step)
        assert kernel.launches == before
        for f in dataclasses.fields(VehicleState):
            assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name
    wides = [getattr(general_frames, n) for n in dir(general_frames)
             if n.endswith("_wide_kernel")]
    assert len(wides) == 8 and all(k.wide and k.max_slots == general_frames.WIDE_SLOTS == 128
                                   for k in wides)
    assert len({k.entry for k in wides}) == 8
    before = [k.launches for k in wides]
    _, metrics = rollout(env, st, 2, gen)
    assert [k.launches for k in wides] == before
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
