"""Roads built by hand, made and stepped against the JAX package on the CPU.

``make`` once refused these scenes at the frame kernels' fixed tables: poly
lanes, more than 4 successor edges a lane, more than 4 predecessor edges or
9 candidate lanes a lane under the connected-lane search, more than 16
route slots, more than 16 target speeds, more than 64 general lanes and
more than 16 straight lanes.  The kernels' tables are now sized by the
scene, and each scene is made and takes 3 ``step_batched`` policy steps
from a port reset batch (B = 4) against the JAX package's (its XLA frames:
its Pallas gate takes none of them), each step from the JAX state of the
step before: discrete fields exactly, pos within 2e-4 m, the other
continuous state within 1e-4 of its magnitude, obs and reward within 1e-5.
The scenes (``highwayenv_tpu_torch/tools/custom_roads.py``):

  - merge-v0 with a junction of 5 successor edges at its end: a poly edge of
    a fixed-width and a variable-width poly lane carrying two NPCs, three
    straight edges, and a chain of 17 short edges that an NPC follows on a
    route of 18 edges (18 route slots); one more NPC takes the junction
    with no route;
  - merge-v0 with 5 predecessor edges into a node (7 candidate lanes a
    lane) and with 10 (12), an NPC on the last of them, under the
    connected-lane search;
  - roundabout-v0 with 31 target speeds;
  - highway-v0 with 17 lanes (the straight kernels).

roundabout-v0 with 17 target speeds and racetrack-oval-v0 with 9 lanes an
edge (72 lanes) are ``test_torch_kernel_limits.py``'s probes.  The poly
junction is also made with ``sequential_decisions`` (plain frames, no
kernel) and stepped.  Each JAX step is jitted once per scene.

One difference of the JAX package's own paths is allowed for: its XLA
straight frame stores the ego's steering P-cascade unclipped
(``highwayenv_tpu/ops/straight_fast.py:438-440``), where its Pallas kernel
(``straight_pallas_bm.py:849-851``), its general frame
(``vehicle/controller.py:106``) and the reference clip it to
+-``MAX_STEERING_ANGLE``, as the port does on every path.  On the straight
road the JAX ego's stored steering is compared clipped; it moves nothing
else (a crashed ego integrates with no steering, and an uncrashed one
beyond the clip would show in pos).
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import highwayenv_tpu as hj
from highwayenv_tpu.envs.base import EnvState as JaxEnvState
from highwayenv_tpu.envs.merge import MergeEnv as JaxMergeEnv
from highwayenv_tpu.road import network as j_net
from highwayenv_tpu.vehicle.state import VehicleState as JaxVehicleState
import highwayenv_tpu_torch as ht
from highwayenv_tpu_torch.bridge import from_numpy_state, to_numpy_state
from highwayenv_tpu_torch.ops import general_frames, straight_frames
from highwayenv_tpu_torch.parallel.rollout import random_actions
from highwayenv_tpu_torch.road.lane import POLY
from highwayenv_tpu_torch.tools import custom_roads
from highwayenv_tpu_torch.vehicle.controller import MAX_STEERING_ANGLE as MAX_STEER
from highwayenv_tpu_torch.vehicle.state import VehicleState

torch.set_num_threads(1)

B = 4
STEPS = 3
DISCRETE = ("lane", "target_lane", "route_ptr", "crashed", "hit", "impact_pending",
            "speed_index", "kind")
CONTINUOUS = ("pos", "heading", "speed", "lateral_speed", "yaw_rate", "target_speed",
              "timer", "impact", "steering", "accel")
CONNECTED = {"neighbour_vehicles_connected_lanes": True}


def _meta(speeds):
    return {"action": {"type": "DiscreteMetaAction", "target_speeds": list(speeds)}}


class JaxPolyJunctionMerge(JaxMergeEnv):
    def _build_scene(self):
        super()._build_scene()
        custom_roads.poly_junction(self.net, j_net)
        self.geo = self.net.build()
        self.route_slots = custom_roads.CHAIN_ROUTE


def _jax_predecessors(n):
    class JaxMorePredecessors(JaxMergeEnv):
        def _build_scene(self):
            super()._build_scene()
            custom_roads.more_predecessors(self.net, j_net, n)
            self.geo = self.net.build()

    return JaxMorePredecessors


#: scene id: (port env (an id or a class), JAX env (an id or a class), config)
SCENES = {
    "poly-junction": (custom_roads.PolyJunctionMerge, JaxPolyJunctionMerge, {}),
    "five-predecessors-connected": (
        custom_roads.FivePredecessorMerge, _jax_predecessors(3), CONNECTED),
    "crowded-connected": (custom_roads.CrowdedMerge, _jax_predecessors(8), CONNECTED),
    "roundabout-speeds-31": ("roundabout-v0", "roundabout-v0", _meta(np.linspace(0, 30, 31))),
    "highway-17-lanes": ("highway-v0", "highway-v0", {"lanes_count": 17}),
}


def _make(env, config, pkg):
    """``pkg.make`` of a registered id, or an env class made with ``config``
    (the port's on the CPU)."""
    kw = {"device": "cpu"} if pkg is ht else {}
    return env(config, **kw) if isinstance(env, type) else pkg.make(env, config, **kw)


@functools.cache
def _jax_step(scene: str):
    """The JAX package's jitted ``step_batched`` of the scene, compiled
    once a process."""
    _, env, config = SCENES[scene]
    return jax.jit(_make(env, config, hj).step_batched)


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


def _check_scene(scene, et):
    """What makes the scene one the fixed tables refused."""
    geo = et.geo
    if scene == "poly-junction":
        assert geo.poly is not None and int((geo.kind == POLY).sum()) == 2
        assert geo.succ_edge_base.shape[1] == 5 and et.route_slots == custom_roads.CHAIN_ROUTE
    elif scene == "five-predecessors-connected":
        assert geo.pred_edge_base.shape[1] == 5 and et._general.connected
    elif scene == "crowded-connected":
        assert geo.pred_edge_base.shape[1] == 10 and geo.conn_lanes.shape[1] == 12
    elif scene.startswith("roundabout"):
        assert len(et.action_type.target_speeds) == int(scene.split("-")[-1])
    else:
        assert et._straight is not None and len(et._straight.offsets) == 17


@pytest.mark.parametrize("scene", list(SCENES))
def test_custom_road_steps_match_jax(scene):
    port_env, _, config = SCENES[scene]
    et = _make(port_env, config, ht)
    _check_scene(scene, et)
    if et._general is not None:  # the launch's tables build without a limit
        general_frames.kernel_params(
            et._general, et.num_slots, et.route_slots, et.frames_per_step,
            raw=et.action_type.stores_raw_controls, linear=et.linear_rows)
    step_j = _jax_step(scene)
    gen = et.generator(5)
    _, st = et.reset(B, gen)
    sj = _jax_state(st, 5)
    for step in range(STEPS):
        acts = random_actions(et, B, gen)
        obs_j, sj, rew_j, term_j, trunc_j, _ = step_j(sj, jnp.asarray(acts.numpy()))
        obs_t, st_t, rew_t, term_t, trunc_t, _ = et.step_batched(
            st, acts, et.generator(100 + step))
        where = f"{scene} step {step}"
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
            if name == "steering" and et._straight is not None:
                # the JAX XLA straight frame's unclipped ego P-cascade
                ego = np.asarray(vj.kind) == 1
                b = np.where(ego, np.clip(b, -MAX_STEER, MAX_STEER), b)
            tol = 2e-4 if name == "pos" else 1e-4 * max(1.0, float(np.abs(b).max()))
            _close(getattr(vt, name).numpy(), b, tol, f"{where} {name}")
        st = _port_state(sj)  # the next step from the JAX state
    if scene == "poly-junction":
        # the poly lanes carried vehicles, and the routed NPC went past the
        # junction into the chain
        lanes = st.vehicles.lane
        assert bool((et.geo.kind[lanes.long()] == POLY).any())
        assert int(st.vehicles.route_ptr[:, 3].min()) >= 2


def test_poly_junction_steps_with_sequential_decisions():
    env = custom_roads.PolyJunctionMerge({"sequential_decisions": True}, device="cpu")
    assert env._general.sequential
    gen = env.generator(0)
    _, st = env.reset(2, gen)
    for _ in range(2):
        _, st, reward, *_ = env.step_batched(st, random_actions(env, 2, gen), gen)
    assert bool(torch.isfinite(st.vehicles.pos).all()) and bool(torch.isfinite(reward).all())


def test_straight_lanes_past_16_fit_the_kernels():
    """The straight kernels' shared memory holds the scene's lane offsets:
    17 and 64 lanes at V = 51 are within the block's limit, 1024 slots at 17
    lanes too, and 1024 slots at 32 lanes are not: ``make`` takes that scene
    on the global layout, whose rows lie in global memory."""
    for V, L in ((51, 17), (51, 64), (1024, 17)):
        assert max(straight_frames.launch_smem(V, L)) <= straight_frames.SMEM_LIMIT
        assert straight_frames.kernel_limits(V, _road(L)) == []
        assert straight_frames.straight_layout_for(V, L) == "block"
    smem = max(straight_frames.launch_smem(1024, 32))
    assert smem > straight_frames.SMEM_LIMIT
    env = ht.make("highway-v0", {"lanes_count": 32, "vehicles_count": 1023}, device="cpu")
    assert straight_frames.kernel_limits(env.num_slots, env._straight) == []
    assert straight_frames.straight_layout_for(env.num_slots, 32) == "global"


def _road(lanes: int):
    return ht.make("highway-v0", {"lanes_count": lanes, "vehicles_count": 5},
                   device="cpu")._straight
