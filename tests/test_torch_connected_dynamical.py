"""A dynamical ContinuousAction under the connected-lane search, on the CPU.

The -v1 / -v2 ids search their neighbours on the connected lanes; with
``{"action": {"type": "ContinuousAction", "dynamical": True}}`` their egos
also integrate by the tire-slip model (vehicle/dynamics.py): racetrack-v1
with a bicycle-model ego, intersection-v2, exit-v1 and roundabout-v1.  On
the card the frames run the kernels' connected dynamical instantiations
(``frames_general_connected_dynamical_kernel``,
``frames_regulated_connected_dynamical_kernel`` and their wide and cluster
twins); on the CPU their wrappers run ``frames_general_plain`` with both
flags, which is held here to the JAX package (its XLA frames: the JAX
kernels' gate takes neither flag):

  - intersection-v2, racetrack-v1 and exit-v1 at their default sizes take 3
    ``step_batched`` steps from a port reset batch (``spawn_probability`` 0
    at the intersection: the JAX package draws spawns from its own keys)
    against the JAX package's, each step from the JAX state of the step
    before: discrete fields exactly, pos within 2e-4 m, the other
    continuous state within 1e-4 of its magnitude (the egos' lateral speed
    and yaw rate among it), obs and reward within 1e-5;
  - every scene this slice opens is made and routed (``frames_kernel_for``)
    to its wrapper: the narrow, wide and cluster connected dynamical
    instantiations, and the scenes of 1025 to 2048 slots on clusters of 9
    to 16 blocks; a CPU rollout through the new wrappers launches nothing;
  - the cluster wrappers' occupancy question refuses what no cluster launch
    can be before it reaches the card.
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
from highwayenv_tpu.vehicle.state import VehicleState as JaxVehicleState
from highwayenv_tpu_torch.bridge import from_numpy_state, to_numpy_state
from highwayenv_tpu_torch.ops import general_frames
from highwayenv_tpu_torch.parallel.rollout import random_actions, rollout
from highwayenv_tpu_torch.vehicle.state import KIND_EGO, VehicleState

torch.set_num_threads(1)

B = 4
STEPS = 3
DYNAMICAL = {"action": {"type": "ContinuousAction", "dynamical": True}}
DISCRETE = ("lane", "target_lane", "route_ptr", "crashed", "hit", "impact_pending",
            "speed_index", "kind", "is_yielding", "yield_timer")
CONTINUOUS = ("pos", "heading", "speed", "lateral_speed", "yaw_rate", "target_speed",
              "timer", "impact", "steering", "accel")
POS_ATOL = 2e-4
REL_TOL = 1e-4
HEAD_ATOL = 1e-5

#: (env id, extra config) of the steps held to the JAX package
STEP_IDS = [("intersection-v2", {"spawn_probability": 0.0}), ("racetrack-v1", {}),
            ("exit-v1", {})]

#: (env id, config, V, the wrapper the scene routes to, the blocks of its cluster)
SCENES = [
    ("racetrack-v1", DYNAMICAL, 2, "frames_general_connected_dynamical_kernel", 0),
    ("roundabout-v1", DYNAMICAL, 5, "frames_general_connected_dynamical_kernel", 0),
    ("exit-v1", DYNAMICAL, 21, "frames_general_connected_dynamical_kernel", 0),
    ("intersection-v2", DYNAMICAL, 25, "frames_regulated_connected_dynamical_kernel", 0),
    ("intersection-v2", {"duration": 30, **DYNAMICAL}, 42,
     "frames_regulated_connected_dynamical_wide_kernel", 0),
    ("exit-v1", {"vehicles_count": 50, **DYNAMICAL}, 51,
     "frames_general_connected_dynamical_wide_kernel", 0),
    ("intersection-v2", {"policy_frequency": 15, **DYNAMICAL}, 207,
     "frames_regulated_connected_dynamical_cluster_kernel", 2),
    ("exit-v1", {"vehicles_count": 150, **DYNAMICAL}, 151,
     "frames_general_connected_dynamical_cluster_kernel", 2),
    ("intersection-v0", {"policy_frequency": 15, "duration": 80}, 1212,
     "frames_regulated_cluster_kernel", 10),
    ("exit-v0", {"vehicles_count": 2047}, 2048, "frames_general_cluster_kernel", 16),
    ("intersection-v2", {"policy_frequency": 15, "duration": 80, **DYNAMICAL}, 1212,
     "frames_regulated_connected_dynamical_cluster_kernel", 10),
]
SCENE_IDS = [f"{e}-V{v}" + ("-dynamical" if "action" in c else "") for e, c, v, *_ in SCENES]


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


def _close(a, b, atol, where):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=atol, err_msg=where)


@functools.cache
def _jax_step(env_id: str):
    """The JAX package's jitted ``step_batched`` of ``env_id`` under the
    dynamical action, compiled once a process."""
    extra = dict(STEP_IDS)[env_id]
    return jax.jit(hj.make(env_id, {**DYNAMICAL, **extra}).step_batched)


@pytest.mark.parametrize("env_id,extra", STEP_IDS, ids=[e for e, _ in STEP_IDS])
def test_connected_dynamical_steps_match_jax(env_id, extra):
    et = ht.make(env_id, {**DYNAMICAL, **extra}, device="cpu")
    spec = et._general
    assert spec.connected and spec.dynamical and et.action_type.stores_raw_controls
    step_j = _jax_step(env_id)
    gen = et.generator(8)
    _, st = et.reset(B, gen)
    sj = _jax_state(st, 8)
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
            tol = POS_ATOL if name == "pos" else REL_TOL * max(1.0, float(np.abs(b).max()))
            _close(getattr(vt, name).numpy(), b, tol, f"{where} {name}")
        # the egos moved by the tire-slip model
        ego = vt.kind == KIND_EGO
        assert bool((vt.yaw_rate[ego] != 0).any()), where
        st = _port_state(sj)  # the next step from the JAX state


@pytest.mark.parametrize("env_id,config,V,wrapper,blocks", SCENES, ids=SCENE_IDS)
def test_scene_makes_and_routes_to_its_instantiation(env_id, config, V, wrapper, blocks):
    env = ht.make(env_id, config, device="cpu")
    assert env.num_slots == V
    spec = env._general
    kernel = general_frames.frames_kernel_for(spec, env.regulated, V)
    assert kernel is getattr(general_frames, wrapper)
    assert (kernel.connected, kernel.dynamical) == (spec.connected, spec.dynamical)
    want = ("general_frames" + "_regulated" * env.regulated + "_connected" * spec.connected
            + "_dynamical" * spec.dynamical)
    assert kernel.entry == want and kernel.max_slots >= V
    assert kernel.cluster == (blocks > 0) and -(-V // general_frames.WIDE_SLOTS) == max(blocks, 1)
    # the launch's parameter block builds: the scene is within every limit
    params = general_frames.kernel_params(spec, V, env.route_slots, env.frames_per_step,
                                          raw=env.action_type.stores_raw_controls,
                                          linear=env.linear_rows)
    assert params.V == V and params.L == env.geo.num_lanes
    if env.regulated:
        # the reset's 16-slot warm-up: the narrow K5 of the same law
        warm = general_frames.frames_kernel_for(spec, True, env._warmup_slots)
        assert not (warm.wide or warm.cluster) and warm.entry == kernel.entry


def test_connected_dynamical_wrappers_run_the_plain_frames_on_the_cpu():
    """The eight connected dynamical wrappers (narrow, wide, cluster and
    global): distinct entries, one a layout and road, each running
    ``frames_general_plain`` on CPU tensors without counting a launch, as a
    rollout through them does."""
    names = [n for n in dir(general_frames)
             if n.startswith("frames_") and "_connected_dynamical" in n and n.endswith("kernel")]
    kernels = [getattr(general_frames, n) for n in names]
    assert len(kernels) == 8
    assert len({(k.regulated, k.wide, k.cluster, k.glob) for k in kernels}) == 8
    assert all(k.connected and k.dynamical for k in kernels)
    env = ht.make("racetrack-v1", DYNAMICAL, device="cpu")
    gen = env.generator(1)
    _, st = env.reset(2, gen)
    veh, sa, raw = general_frames.store_raw_controls(
        env, st.vehicles, random_actions(env, 2, gen))
    kernel = general_frames.frames_general_connected_dynamical_kernel
    got = kernel(veh, env._general, sa, env.frames_per_step, raw=raw)
    want = general_frames.frames_general_plain(veh, env._general, sa, env.frames_per_step,
                                               raw=raw)
    for f in dataclasses.fields(VehicleState):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name
    before = [k.launches for k in kernels]
    _, metrics = rollout(env, st, 2, gen)
    assert [k.launches for k in kernels] == before == [0] * 8
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


@pytest.mark.parametrize("name,ranks,L,R,match", [
    ("frames_regulated_connected_dynamical_kernel", 10, 20, 3, "cluster library"),
    ("frames_general_connected_dynamical_wide_kernel", 16, 20, 3, "cluster library"),
    ("frames_general_cluster_kernel", 17, 20, 3, "17 cluster blocks outside 1 to 16"),
    ("frames_regulated_connected_dynamical_cluster_kernel", 10, 0, 16, "0 lanes < 1"),
], ids=["narrow", "wide", "ranks", "lanes"])
def test_cluster_fit_refuses_before_the_card(name, ranks, L, R, match):
    """``GeneralFramesKernel.cluster_fit`` (the occupancy question of
    ``tools/cluster_fit.py``) asks only a cluster wrapper, of 1 to 16 blocks
    at a scene of at least one lane and route slot (the lanes have no other
    bound since the tables are sized by the scene): anything else is refused
    before the library is built or the card asked."""
    kernel = getattr(general_frames, name)
    with pytest.raises(ValueError, match=match):
        kernel.cluster_fit(ranks, L, R)
