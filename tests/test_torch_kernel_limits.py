"""The kernels' limits are refused when an env is made, never at launch.

The CUDA frame kernels' tables are sized by the scene (lanes, lanes an
edge, route slots, successor and predecessor edges, candidate lanes a lane,
target speeds, straight lanes).  What limits remain (the slots of the
largest layout, 8192 on the straight and on the general path, whose global
layouts take the scenes past a block's slots or its 227 KB of shared
memory on an H100, and a grid of one target speed, which
``speed_to_index`` cannot take) are checked by ``make`` on every device,
which raises ``NotImplementedError`` naming the limit and "not ported".
So ``kernel_params``, ``lane_tables``, ``conn_tables`` and
``check_frame_shape`` never raise for an env that ``make`` returned:
checked here for every registered id.

Configs past the old fixed tables make, and one policy step of each from
a JAX reset batch matches the JAX step (the XLA general frame) on the CPU:
exit-v0 with 8 lanes (9 lanes on the exit section's edge), roundabout-v0
with 17 target speeds, merge-v0 with 10 and racetrack-oval-v0 with 9 lanes
(72 lanes, 9 an edge, raw controls).  Tolerances: discrete fields exact,
pos 2e-4 m, other continuous state 1e-4 of its magnitude, obs and reward
1e-5.  The configs the fixed tables refused before this (17 target speeds,
17 straight lanes, 72 general lanes, 5 predecessor edges under the
connected-lane search and a dynamical action, a route of 17 slots, 12
candidate lanes a lane) are made and stepped here on the port;
``test_torch_custom_roads.py`` holds the others to the JAX package.
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
from highwayenv_tpu_torch.ops import general_frames, straight_frames
from highwayenv_tpu_torch.parallel.rollout import random_actions
from highwayenv_tpu_torch.tools.custom_roads import CrowdedMerge, FivePredecessorMerge
from highwayenv_tpu_torch.vehicle.state import VehicleState

torch.set_num_threads(1)

B = 8
STATE_DISCRETE = ("lane", "target_lane", "crashed", "hit", "impact_pending",
                  "speed_index", "kind", "route_ptr")
STATE_CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer",
                    "impact", "steering", "accel")


def _meta(speeds):
    return {"action": {"type": "DiscreteMetaAction", "target_speeds": list(speeds)}}


def _make(env, config):
    """``ht.make`` of a registered id, or an env class made with ``config``."""
    return env(config, device="cpu") if isinstance(env, type) else ht.make(env, config,
                                                                            device="cpu")


#: (env id, config, lanes an edge, target speeds; None under raw controls)
PROBES = [
    ("exit-v0", {"lanes_count": 8}, 9, 3),
    ("roundabout-v0", _meta(np.linspace(0.0, 16.0, 17)), 2, 17),
    ("merge-v0", _meta(np.linspace(20.0, 30.0, 10)), 3, 10),
    ("racetrack-oval-v0", {"no_lanes": 9}, 9, None),
]


def _numpy_state(states) -> dict:
    return {
        "vehicles": {
            f.name: np.array(getattr(states.vehicles, f.name))
            for f in dataclasses.fields(VehicleState)
        },
        "time": np.array(states.time),
        "steps": np.array(states.steps),
    }


def _close(a, b, atol, where):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=atol, err_msg=where)


def _launch_tables(env):
    """What a launch of env's frame kernel builds from the env: the
    parameter block (and the lane tables), or the straight frame's shape
    check on a reset state.  Raises where a launch would."""
    _, st = env.reset(2, env.generator(0))
    veh = st.vehicles
    if env._general is None:
        straight_frames.check_frame_shape(veh, env._straight)
        return None
    assert veh.route_base.shape[-1] == env.route_slots
    general_frames.lane_tables(env.geo, env.device)
    if env._general.connected:
        lanes, _ = general_frames.conn_tables(env.geo, env.device)
        assert torch.equal(lanes[:, :env.geo.conn_lanes.shape[1]], env.geo.conn_lanes)
    return general_frames.kernel_params(
        env._general, env.num_slots, env.route_slots, env.frames_per_step,
        raw=env.action_type.stores_raw_controls, linear=env.linear_rows)


@pytest.mark.parametrize("env_id,config,edge_lanes,n_speeds", PROBES,
                         ids=[p[0] for p in PROBES])
def test_probe_configs_make_and_step_as_jax(env_id, config, edge_lanes, n_speeds):
    ej, et = hj.make(env_id, config), ht.make(env_id, config, device="cpu")
    params = _launch_tables(et)
    assert et.max_edge_lanes == edge_lanes and params.M == edge_lanes
    raw = n_speeds is None
    grid = general_frames.speed_table(et._general, raw, "cpu")
    if raw:  # raw controls: no speed grid
        assert et.action_type.stores_raw_controls and params.n_speeds == 0 and grid == ()
        assert params.L == et.geo.num_lanes == 72
    else:
        assert len(et.action_type.target_speeds) == n_speeds == params.n_speeds
        assert grid[0].tolist() == list(np.asarray(et.action_type.target_speeds, np.float32))

    _, sj = jax.vmap(ej._reset)(jax.random.split(jax.random.PRNGKey(3), B))
    st = from_numpy_state(_numpy_state(sj))
    if n_speeds is None:
        shape = (B,) + tuple(et.action_type.action_shape)
        acts = np.random.default_rng(3).uniform(-1.0, 1.0, shape).astype(np.float32)
    else:
        # FASTER and SLOWER walk the grid, the lane changes cross the edges
        acts = np.arange(B, dtype=np.int32) % et.action_type.n
    obs_j, st_j, rew_j, term_j, trunc_j, _ = jax.jit(ej.step_batched)(sj, jnp.asarray(acts))
    obs_t, st_t, rew_t, term_t, trunc_t, _ = et.step_batched(
        st, torch.from_numpy(acts), et.generator(0))
    np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j))
    np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j))
    _close(rew_t, rew_j, 1e-5, "reward")
    _close(obs_t, obs_j, 1e-5, "obs")
    vt, vj = st_t.vehicles, st_j.vehicles
    for name in STATE_DISCRETE:
        np.testing.assert_array_equal(getattr(vt, name).numpy(),
                                      np.asarray(getattr(vj, name)), err_msg=name)
    for name in STATE_CONTINUOUS:
        b = np.asarray(getattr(vj, name))
        tol = 2e-4 if name == "pos" else 1e-4 * max(1.0, float(np.abs(b).max()))
        _close(getattr(vt, name).numpy(), b, tol, name)


@pytest.mark.parametrize("env_id,config,what", [
    ("merge-v0", _meta([25.0]), "1 target speeds < 2"),
    ("highway-fast-v0", {"vehicles_count": 8192}, "8193 slots > 8192"),
    ("exit-v0", {"vehicles_count": 2048}, None),
    ("highway-v0", {"action": {"type": "ContinuousAction", "dynamical": True}},
     "a dynamical action on a straight road"),
    ("exit-v0", {"lanes_count": 100, "vehicles_count": 100}, None),
    ("exit-v0", {"vehicles_count": 8192}, "8193 slots > 8192"),
], ids=["speeds-1", "straight-slots", "general-slots", "straight-dynamical",
        "shared-memory", "global-slots"])
def test_over_limit_configs_are_refused_at_make(env_id, config, what):
    """What no kernel takes is refused at ``make``, naming the limit.  Past
    the cluster kernels' 2048 slots and past a block's shared memory (exit-v0
    with 100 lanes and 100 vehicles asked 315,840 bytes of the wide block)
    the global layout takes the scene: made, routed to its global wrapper."""
    if what is None:
        env = _make(env_id, config)
        assert general_frames.frames_kernel_for(env._general, env.regulated,
                                                env.num_slots).glob
        return
    with pytest.raises(NotImplementedError, match=f"{what}.*not ported"):
        _make(env_id, config)


def _steps(env, frames_only: bool = False):
    """Two policy steps of ``env`` (B = 2) on the CPU: ``step_batched``, or
    with ``frames_only`` the frames alone (``_simulate_batched``); the
    states after them."""
    gen = env.generator(0)
    _, st = env.reset(2, gen)
    for _ in range(2):
        acts = random_actions(env, 2, gen)
        if frames_only:
            st = env._simulate_batched(st, acts)
        else:
            _, st, reward, *_ = env.step_batched(st, acts, gen)
            assert bool(torch.isfinite(reward).all())
    assert bool(torch.isfinite(st.vehicles.pos).all())
    return st


#: the configs that the fixed tables once refused: (env, config, the
#: wrapper the scene routes to, None on the straight path); the dynamical
#: action on merge-v0 steps its frames alone (merge's reward compares the
#: action to 0 and 2, which a ContinuousAction's is not, as in the reference)
LIFTED = [
    ("roundabout-v0", _meta(np.linspace(0.0, 16.0, 17)), "frames_general_kernel"),
    ("highway-v0", {"lanes_count": 17}, None),
    ("racetrack-oval-v0", {"no_lanes": 9}, "frames_general_kernel"),
    (FivePredecessorMerge, {"neighbour_vehicles_connected_lanes": True, "action": {
        "type": "ContinuousAction", "dynamical": True}},
     "frames_general_connected_dynamical_kernel"),
]


@pytest.mark.parametrize("env_id,config,wrapper", LIFTED, ids=[
    "speeds-17", "straight-lanes", "general-lanes", "connected-dynamical"])
def test_lifted_limits_make_and_step(env_id, config, wrapper):
    env = _make(env_id, config)
    assert _launch_tables(env) is None or wrapper is not None
    if wrapper is None:
        assert len(env._straight.offsets) == 17
    else:
        kernel = general_frames.frames_kernel_for(env._general, env.regulated, env.num_slots)
        assert kernel is getattr(general_frames, wrapper)
    _steps(env, frames_only=isinstance(env_id, type))


@pytest.mark.parametrize("limits,what", [
    ((2049, 20, 3, 2, 3), None),
    ((25, 200, 3, 2, 3), None),
    ((25, 100, 3, 2, 3), None),
    ((25, 20, 40, 2, 3), None),
    ((25, 20, 3, 8, 3), None),
    ((25, 20, 3, 2, 40), None),
    ((25, 20, 3, 2, 1), "1 target speeds < 2 (speed_to_index divides by the grid's span)"),
    ((128, 300, 3, 3, 3), "shared memory"),
    ((8193, 20, 3, 2, 3), "8193 slots > 8192"),
], ids=["slots", "lanes", "edge-lanes", "route", "successors", "speeds", "one-speed",
        "shared-memory", "global-slots"])
def test_each_general_limit_is_named(limits, what):
    """The slots past the global layout's 8192 and a grid of one speed are
    named; lanes (and so lanes an edge, which an edge's lanes bound), route
    slots, successor edges and target speeds well past the old fixed tables
    (64, 16, 4, 16) are no limit, nor are the cluster kernels' 2048 slots
    or a block's shared memory, past which the scene takes the global
    layout (``layout_for``)."""
    V, L, R, S, n = limits
    if what == "shared memory":  # V = 128: one block an env, the fixed layout's S = 4
        assert general_frames.launch_tables(S, None, False) == (4, 0, False)
        smem = general_frames.launch_smem(V, L, R, 4, 0, False)
        assert smem > general_frames.SMEM_LIMIT
        assert general_frames.kernel_limits(*limits) == []
        assert general_frames.layout_for(*limits) == "global"
    elif what is None:
        assert general_frames.kernel_limits(*limits) == []
        assert general_frames.layout_for(*limits) == ("global" if V > 2048 else "")
    else:
        assert general_frames.kernel_limits(*limits) == [what]
    assert general_frames.kernel_limits(1024, 64, 16, 4, 16) == []
    assert general_frames.kernel_limits(2048, 64, 16, 4, None, 9) == []


@pytest.mark.parametrize("limits,what", [
    ((25, 20, 3, 3, 3, 9), []),
    ((25, 20, 3, 4, 3, 10), []),
    ((25, 20, 3, 5, 3, 10), []),
    ((25, 20, 3, 3, None, 9), []),
], ids=["predecessors", "predecessors-and-candidates", "successors-and-candidates",
        "dynamical"])
def test_connected_limits_are_named(limits, what):
    """Under the connected-lane search (K given) the candidate tables hold
    the scene's K = 1 + S + P lanes a lane: 5 predecessors, 10 candidates
    and a dynamical action's raw controls are no limit; the K columns count
    in the block's shared memory."""
    assert general_frames.kernel_limits(*limits) == what
    L, S, K = limits[1], limits[3], limits[5]
    assert general_frames.launch_smem(25, L, 3, S, K, False) == (
        general_frames.launch_smem(25, L, 3, S, 0, False) + 4 * 2 * L * K)


def test_a_route_of_17_slots_makes_and_steps():
    """Routes of 17 slots, over the 16 the route check took (roundabout-v0's
    routes padded with empty slots), are made and step, on any device."""
    from highwayenv_tpu_torch.envs.roundabout import RoundaboutEnv

    class LongRoutes(RoundaboutEnv):
        def _build_scene(self):
            super()._build_scene()
            pad = 17 - self.route_slots
            # an empty slot: no base lane, no lanes, no lane id
            fill = torch.tensor([-1, 0, -1], dtype=torch.int32)[:, None].expand(3, pad)
            self._npc_routes = torch.cat(
                [self._npc_routes, fill.expand(*self._npc_routes.shape[:-1], pad)], dim=-1)
            self._ego_route = torch.cat([self._ego_route, fill], dim=-1)
            self.route_slots = 17

    env = LongRoutes(device="cpu")
    params = _launch_tables(env)
    assert params.R == 17
    st = _steps(env)
    assert st.vehicles.route_base.shape[-1] == 17


def test_a_crowded_node_makes_and_steps_under_the_connected_search():
    """merge with 8 more edges into node "b" (10 predecessor edges, 12
    candidate lanes): made and stepped with the connected-lane search, and
    without it, which never reads predecessors."""
    env = CrowdedMerge(device="cpu")
    assert env.geo.pred_edge_base.shape[1] == 10 and env.geo.conn_lanes.shape[1] == 12
    conn = CrowdedMerge({"neighbour_vehicles_connected_lanes": True}, device="cpu")
    assert conn._general.connected and _launch_tables(conn).K == 12
    _steps(conn)


@pytest.mark.parametrize("env_id", ht.registered_ids())
def test_every_made_env_builds_its_launch(env_id):
    env = ht.make(env_id, device="cpu")
    params = _launch_tables(env)
    if params is not None:
        assert params.M == env.max_edge_lanes and params.R == env.route_slots
