"""Scenes of the kSized libraries in every layout and law, on the CPU.

A scene outside the frame kernels' fixed layout (poly lanes, more than 4
successor edges a lane, more than 9 candidate lanes a lane, more than 16
route slots or more than 16 target speeds) runs the ``kSized``
instantiation of its entry, in the ``_sized`` twin of the library its
slots pick (narrow, wide or cluster).  Ordinary settings reach each of
them: intersection-v0 with 17 target speeds (V=25 narrow, at duration 30
V=42 wide, at policy_frequency 15 V=207 cluster; intersection-v2 the same
under the connected-lane search) and exit-v0 with a poly edge past its end
carrying NPCs (``custom_roads.PolyExit``: 50 vehicles wide, 150 cluster,
its poly lanes' NPCs in both ranks).  Here

  - each such scene is made, routed to its instantiation
    (``frames_kernel_for``) and to the kSized tables (``scene_tables``),
    and its launch's tables and parameter block built as a launch builds
    them;
  - intersection-v0 with 17 target speeds (a regulated scene over the old
    caps) takes 3 ``step_batched`` policy steps from a port reset batch
    (B = 4) against the JAX package's (its XLA frames), each step from the
    JAX state of the step before: discrete fields exactly, pos within
    2e-4 m, the other continuous state within 1e-4 of its magnitude, obs
    and reward within 1e-5.  It spawns nothing (``spawn_probability`` 0):
    the two packages draw their spawns from different generators;
  - PolyExit's reset puts NPCs on the poly lanes in both ranks of a
    cluster, and they stay there over a CPU rollout.  It is not stepped
    against the JAX package: its poly NPCs collide near x = 1040 m, where
    the JAX XLA frame's collision test on absolute corners
    (``highwayenv_tpu/utils/math.py`` ``rects_intersecting``) and the
    port's on relative coordinates (``rects_intersecting_xy_folded``, as
    the JAX package's own kernels) round apart by up to 0.14 m in the
    translation (8e-6 m at x = 35 m), a difference of the JAX package's
    paths recorded in ROADMAP.md.
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
from highwayenv_tpu_torch.road.lane import POLY
from highwayenv_tpu_torch.tools import custom_roads
from highwayenv_tpu_torch.vehicle.state import VehicleState

torch.set_num_threads(1)

B = 4
STEPS = 3
DISCRETE = ("lane", "target_lane", "route_ptr", "crashed", "hit", "impact_pending",
            "speed_index", "kind", "is_yielding", "yield_timer")
CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer", "impact", "steering",
              "accel")
CONNECTED = {"neighbour_vehicles_connected_lanes": True}
#: intersection-v0's action with 17 target speeds (its own 3 are 0, 4.5, 9)
SPEEDS_17 = {"action": {"type": "DiscreteMetaAction", "longitudinal": True, "lateral": False,
                        "target_speeds": list(np.linspace(0.0, 9.0, 17))}}

#: (port env (an id or a custom_roads class), config, V, the wrapper)
SCENES = [
    ("intersection-v0", SPEEDS_17, 25, "frames_regulated_kernel"),
    ("intersection-v0", {"duration": 30, **SPEEDS_17}, 42, "frames_regulated_wide_kernel"),
    ("intersection-v0", {"policy_frequency": 15, **SPEEDS_17}, 207,
     "frames_regulated_cluster_kernel"),
    ("intersection-v0", {**CONNECTED, **SPEEDS_17}, 25, "frames_regulated_connected_kernel"),
    ("intersection-v0", {"duration": 30, **CONNECTED, **SPEEDS_17}, 42,
     "frames_regulated_connected_wide_kernel"),
    ("intersection-v0", {"policy_frequency": 15, **CONNECTED, **SPEEDS_17}, 207,
     "frames_regulated_connected_cluster_kernel"),
    (custom_roads.PolyExit, {"vehicles_count": 50}, 51, "frames_general_wide_kernel"),
    (custom_roads.PolyExit, {"vehicles_count": 150}, 151, "frames_general_cluster_kernel"),
    (custom_roads.PolyExit, {"vehicles_count": 50, **CONNECTED}, 51,
     "frames_general_connected_wide_kernel"),
    (custom_roads.PolyExit, {"vehicles_count": 150, **CONNECTED}, 151,
     "frames_general_connected_cluster_kernel"),
]
SCENE_IDS = [w.replace("frames_", "").replace("_kernel", "") + f"-V{V}" for _, _, V, w in SCENES]


def _make(env, config):
    return env(config, device="cpu") if isinstance(env, type) else ht.make(env, config,
                                                                            device="cpu")


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


@pytest.mark.parametrize("env,config,V,wrapper", SCENES, ids=SCENE_IDS)
def test_scene_routes_to_its_sized_instantiation(env, config, V, wrapper):
    et = _make(env, config)
    spec, raw = et._general, et.action_type.stores_raw_controls
    assert et.num_slots == V
    kernel = general_frames.frames_kernel_for(spec, et.regulated, V)
    assert kernel is getattr(general_frames, wrapper)
    S, K, sized = general_frames.scene_tables(spec, et.route_slots, raw)
    assert sized and K == (spec.geo.conn_lanes.shape[1] if spec.connected else 0)
    params = general_frames.kernel_params(spec, V, et.route_slots, et.frames_per_step,
                                          raw=raw, linear=et.linear_rows)
    assert (params.V, params.S, params.K) == (V, S, K)
    lanes_f, lanes_i = general_frames.lane_tables(spec.geo, "cpu", S, sized)
    assert lanes_i.shape == (spec.geo.num_lanes, general_frames.lane_i_words(S, True))
    if isinstance(env, type):  # the poly edge and its bank
        assert int((spec.geo.kind == POLY).sum()) == 2 and spec.geo.poly is not None
        assert len(general_frames.poly_tables(spec.geo, "cpu")) == 5
    else:
        grid = general_frames.speed_table(spec, raw, "cpu")[0]
        assert params.n_speeds == 17 and grid.tolist() == list(
            np.asarray(SPEEDS_17["action"]["target_speeds"], np.float32))


def test_regulated_scene_over_the_old_caps_steps_as_jax():
    config = {"spawn_probability": 0.0, **SPEEDS_17}
    et, ej = ht.make("intersection-v0", config, device="cpu"), hj.make("intersection-v0", config)
    assert ej.num_slots == et.num_slots
    assert general_frames.scene_tables(et._general, et.route_slots, False)[2]
    step_j = jax.jit(ej.step_batched)
    gen = et.generator(5)
    _, st = et.reset(B, gen)
    sj = _jax_state(st, 5)
    for step in range(STEPS):
        acts = random_actions(et, B, gen)
        obs_j, sj, rew_j, term_j, trunc_j, _ = step_j(sj, jnp.asarray(acts.numpy()))
        obs_t, st_t, rew_t, term_t, trunc_t, _ = et.step_batched(
            st, acts, et.generator(100 + step))
        where = f"step {step}"
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
            tol = 2e-4 if name == "pos" else 1e-4 * max(1.0, float(np.abs(b).max()))
            _close(getattr(vt, name).numpy(), b, tol, f"{where} {name}")
        st = _port_state(sj)  # the next step from the JAX state
    # the egos' speed indices past the default grid's 3
    assert int(st.vehicles.speed_index.max()) > 2


def test_poly_exit_puts_poly_vehicles_in_both_ranks():
    env = custom_roads.PolyExit({"vehicles_count": 150}, device="cpu")
    gen = env.generator(0)
    _, st = env.reset(2, gen)
    first = custom_roads.POLY_CENTRE - custom_roads.POLY_NPCS // 2
    moved = st.vehicles.lane[:, first:first + custom_roads.POLY_NPCS]
    assert bool((env.geo.kind[moved.long()] == POLY).all())
    assert int(st.vehicles.route_len[:, first:first + custom_roads.POLY_NPCS].max()) == 0
    st, metrics = rollout(env, st, 2, gen)
    on_poly = env.geo.kind[st.vehicles.lane.long()] == POLY
    rank = general_frames.WIDE_SLOTS
    assert bool(on_poly[:, :rank].any(1).all()) and bool(on_poly[:, rank:].any(1).all())
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
