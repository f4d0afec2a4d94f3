"""The global layout of K4 / K5, on the CPU: which scenes take it, and their steps against JAX.

A general scene that no layout with shared memory holds (over
``MAX_SLOTS`` = 2048 slots, or a block over the H100's 227 KB of shared
memory, ``launch_smem``) takes the global twin of its instantiation
(``csrc/general_frames_global.cu``: the cluster design with an env's
arrays in a slab of global memory, up to ``GLOBAL_SLOTS`` = 8192 slots).
Here

  - ``frames_kernel_for`` routes exit-v0 with 100 lanes and 100 vehicles
    (L=302, V=101), exit-v0 with 2100 and 4095 vehicles (V=2101, 4096) and
    intersection-v0 / -v2 at policy_frequency 15 with duration 140
    (V=2112) to the global wrappers, and every registered id and the
    custom and sized rows of chip_smoke.py to the wrapper their slots
    picked before (the narrow, wide or cluster one);
  - the slot cap (``GLOBAL_SLOTS``), the threads a block
    (``global_threads``) and the slab's words an env (``global_words``)
    are named, and ``make`` refuses one slot past the cap;
  - on CPU tensors the global wrappers run ``frames_general_plain`` and
    count no launch;
  - ``step_batched`` of the port (its plain frames on the CPU, what the
    global kernels are held to bit for bit on the card by chip_smoke.py)
    against the JAX package's (its XLA frames) from a port reset batch:
    exit-v0 with 100 lanes and 100 vehicles (B=2, 2 steps, each from the
    JAX state of the step before) and exit-v0 with 2100 vehicles (B=1, 1
    step).  Tolerances those of ``tests/test_torch_general.py``: discrete
    fields and route arrays exact, pos, speed and heading 5e-4 absolute,
    the other continuous fields 1e-4 times their magnitude; obs and reward
    1e-5.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import highwayenv_tpu as hj
from highwayenv_tpu.envs.base import EnvState as JaxEnvState
from highwayenv_tpu.vehicle.state import VehicleState as JaxVehicleState
import highwayenv_tpu_torch as ht
from highwayenv_tpu_torch.bridge import from_numpy_state, to_numpy_state
from highwayenv_tpu_torch.ops import general_frames
from highwayenv_tpu_torch.parallel.rollout import random_actions, rollout
from highwayenv_tpu_torch.tools import custom_roads
from highwayenv_tpu_torch.vehicle.state import VehicleState

torch.set_num_threads(1)

DISCRETE = ("lane", "target_lane", "route_ptr", "crashed", "hit", "impact_pending",
            "speed_index", "kind", "route_len", "route_base", "route_n", "route_id")
CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer", "impact", "steering",
              "accel")
STEP_ATOL = {"pos": 5e-4, "speed": 5e-4, "heading": 5e-4}
CONNECTED = {"neighbour_vehicles_connected_lanes": True}
DYNAMICAL = {"action": {"type": "ContinuousAction", "dynamical": True}}
SPEEDS_17 = {"action": {"type": "DiscreteMetaAction", "longitudinal": True, "lateral": False,
                        "target_speeds": list(np.linspace(0.0, 9.0, 17))}}

#: the scenes that no layout of shared memory holds: (env id, config, V, L,
#: the wrapper)
GLOBAL_SCENES = [
    ("exit-v0", {"lanes_count": 100, "vehicles_count": 100}, 101, 302,
     "frames_general_global_kernel"),
    ("exit-v0", {"vehicles_count": 2100}, 2101, 20, "frames_general_global_kernel"),
    ("exit-v0", {"vehicles_count": 4095}, 4096, 20, "frames_general_global_kernel"),
    ("intersection-v0", {"policy_frequency": 15, "duration": 140}, 2112, 20,
     "frames_regulated_global_kernel"),
    ("intersection-v2", {"policy_frequency": 15, "duration": 140}, 2112, 20,
     "frames_regulated_connected_global_kernel"),
]

#: scenes that fit a layout of shared memory (chip_smoke.py's wide,
#: cluster, large, custom and sized rows): (env id or custom_roads class
#: name, config)
FITTING = [
    ("intersection-v0", {"duration": 30}),
    ("intersection-v0", {"duration": 116}),
    ("racetrack-oval-v0", {"no_lanes": 6}),
    ("racetrack-oval-v0", {"no_lanes": 9}),
    ("intersection-v1", {"policy_frequency": 15}),
    ("exit-v1", {"vehicles_count": 150}),
    ("racetrack-v0", {"other_vehicles": 150, **DYNAMICAL}),
    ("intersection-v0", {"duration": 60, "policy_frequency": 15}),
    ("intersection-v0", {"policy_frequency": 15, "duration": 80}),
    ("exit-v0", {"vehicles_count": 2047}),
    ("intersection-v2", {"policy_frequency": 15, "duration": 80, **DYNAMICAL}),
    ("PolyJunctionMerge", {}),
    ("FivePredecessorMerge", CONNECTED),
    ("CrowdedMerge", CONNECTED),
    ("intersection-v0", {"policy_frequency": 15, **SPEEDS_17}),
    ("PolyExit", {"vehicles_count": 50}),
    ("PolyExit", {"vehicles_count": 150, **CONNECTED, **DYNAMICAL}),
]


def _make(name, config):
    cls = getattr(custom_roads, name, None)
    return ht.make(name, config, device="cpu") if cls is None else cls(config, device="cpu")


def _slots_layout(env):
    """The wrapper the slots alone picked before the global layout: narrow
    up to 32 slots, wide up to 128, cluster past them."""
    V = env.num_slots
    layout = ("_cluster" if V > general_frames.WIDE_SLOTS
              else "_wide" if V > general_frames.NARROW_SLOTS else "")
    spec = env._general
    law = "_connected" * spec.connected + "_dynamical" * spec.dynamical
    road = "regulated" if env.regulated else "general"
    return getattr(general_frames, f"frames_{road}{law}{layout}_kernel")


@pytest.mark.parametrize("env_id,config,V,L,wrapper", GLOBAL_SCENES,
                         ids=["exit-302-lanes", "exit-2101-slots", "exit-4096-slots",
                              "intersection-2112-slots", "intersection-v2-2112-slots"])
def test_scene_past_shared_memory_routes_to_global(env_id, config, V, L, wrapper):
    env = ht.make(env_id, config, device="cpu")
    spec = env._general
    assert (env.num_slots, env.geo.num_lanes) == (V, L)
    assert spec.route_slots == env.route_slots
    kernel = general_frames.frames_kernel_for(spec, env.regulated, V)
    assert kernel is getattr(general_frames, wrapper)
    assert kernel.glob and kernel.source == "general_frames_global"
    assert general_frames.scene_layout(spec, env.regulated, V) == "global"
    # the kSized tables at the scene's own columns, whatever the scene
    raw = env.action_type.stores_raw_controls
    S, K, sized = general_frames.scene_tables(spec, env.route_slots, raw, True)
    assert sized and S == env.geo.succ_edge_base.shape[1]
    params = general_frames.kernel_params(spec, V, env.route_slots, env.frames_per_step,
                                          raw=raw, sized=True)
    assert (params.V, params.L, params.S, params.K) == (V, L, S, K)
    order = general_frames.lane_order(spec.geo, "cpu")
    assert sorted(order.tolist()) == list(range(L))
    if env.regulated:
        # the reset's warm-up keeps its 16 slots: the narrow K5 of the same law
        warm = general_frames.frames_kernel_for(spec, True, env._warmup_slots)
        assert not (warm.wide or warm.cluster or warm.glob) and warm.entry == kernel.entry


def test_fitting_scenes_keep_their_wrapper():
    """Every registered id at its defaults and every scene that a layout of
    shared memory holds keeps the wrapper its slots picked before."""
    seen = 0
    for env_id in ht.registered_ids():
        env = ht.make(env_id, device="cpu")
        if env._general is None:
            continue
        kernel = general_frames.frames_kernel_for(env._general, env.regulated, env.num_slots)
        assert kernel is _slots_layout(env), env_id
        seen += 1
    for name, config in FITTING:
        env = _make(name, config)
        kernel = general_frames.frames_kernel_for(env._general, env.regulated, env.num_slots)
        assert kernel is _slots_layout(env) and not kernel.glob, (name, config)
    assert seen == 29


def test_global_slots_threads_and_words_are_named():
    cap = general_frames.GLOBAL_SLOTS
    assert cap == 8192 == 16 * general_frames.GLOBAL_THREADS
    assert [general_frames.global_threads(V) for V in (1, 2048, 2049, 4096, 4097, 8192)] == [
        128, 128, 256, 256, 512, 512]
    # a chunk of 128 slots an env's 128 threads: EnvSmem's words at V = 128
    chunk = general_frames._words_env(20, 128, 3, True, 4)
    assert general_frames.global_words(20, 2112, 3, True) == 18 * chunk
    assert general_frames.global_words(20, 101, 3, True) == chunk
    assert general_frames.global_words(20, 8192, 3, True) == 64 * chunk
    # the slab of exit-v0 with 100 lanes: about 333 KB an env
    assert general_frames.global_words(302, 101, 3, False) * 4 == 332576
    # only the slots past the cap and a grid of one speed are limits
    assert general_frames.kernel_limits(cap, 302, 16, 9, 3, 19, True, True) == []
    assert general_frames.kernel_limits(cap + 1, 20, 3, 2, 3) == [f"{cap + 1} slots > {cap}"]
    assert general_frames.layout_for(cap, 20, 3, 2, 3) == "global"
    ht.make("exit-v0", {"vehicles_count": cap - 1}, device="cpu")
    with pytest.raises(NotImplementedError, match=f"{cap + 1} slots > {cap}.*not ported"):
        ht.make("exit-v0", {"vehicles_count": cap}, device="cpu")


def test_global_wrappers_run_the_plain_frames_on_the_cpu():
    """Every global wrapper runs ``frames_general_plain`` on CPU tensors and
    counts no launch; cluster_fit and global_words ask a global or cluster
    wrapper only, at blocks of 128, 256 or 512 threads."""
    env = ht.make("exit-v0", {"lanes_count": 100, "vehicles_count": 100}, device="cpu")
    gen = env.generator(1)
    _, st = env.reset(1, gen)
    sa = env._action_to_slots(random_actions(env, 1, gen))
    kernel = general_frames.frames_general_global_kernel
    want = general_frames.frames_general_plain(st.vehicles, env._general, sa, 1)
    got = kernel(st.vehicles, env._general, sa, 1)
    assert kernel.launches == 0
    for f in dataclasses.fields(VehicleState):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name
    globs = [getattr(general_frames, n) for n in dir(general_frames)
             if n.endswith("_global_kernel")]
    assert len(globs) == 8 and len({k.entry for k in globs}) == 8
    assert all(k.glob and not (k.wide or k.cluster) and k.source == "general_frames_global"
               and k.max_slots == general_frames.GLOBAL_SLOTS for k in globs)
    with pytest.raises(ValueError, match="blocks of 1024 threads"):
        kernel.cluster_fit(16, 20, 3, threads=1024)
    with pytest.raises(ValueError, match="blocks of 256 threads"):
        general_frames.frames_general_cluster_kernel.cluster_fit(16, 20, 3, threads=256)
    with pytest.raises(ValueError, match="global library"):
        general_frames.frames_general_cluster_kernel.global_words(20, 2048, 3)
    with pytest.raises(ValueError, match="one of them"):
        general_frames.GeneralFramesKernel(cluster=True, glob=True)
    before = [k.launches for k in globs]
    _, metrics = rollout(env, st, 1, gen)
    assert [k.launches for k in globs] == before
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


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


@pytest.mark.parametrize("config,batch,steps", [
    ({"lanes_count": 100, "vehicles_count": 100}, 2, 2),
    ({"vehicles_count": 2100}, 1, 1),
], ids=["302-lanes", "2101-slots"])
def test_global_scene_steps_as_jax(config, batch, steps):
    et, ej = ht.make("exit-v0", config, device="cpu"), hj.make("exit-v0", config)
    assert ej.num_slots == et.num_slots
    assert general_frames.frames_kernel_for(et._general, et.regulated, et.num_slots).glob
    step_j = jax.jit(ej.step_batched)
    gen = et.generator(7)
    _, st = et.reset(batch, gen)
    sj = _jax_state(st, 7)
    for step in range(steps):
        acts = random_actions(et, batch, gen)
        obs_j, sj, rew_j, term_j, trunc_j, _ = step_j(sj, jnp.asarray(acts.numpy()))
        obs_t, st_t, rew_t, term_t, trunc_t, _ = et.step_batched(
            st, acts, et.generator(100 + step))
        where = f"exit-v0 {config} step {step}"
        np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j), err_msg=where)
        np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j), err_msg=where)
        _close(rew_t, rew_j, 1e-5, f"{where} reward")
        _close(obs_t, obs_j, 1e-5, f"{where} obs")
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
