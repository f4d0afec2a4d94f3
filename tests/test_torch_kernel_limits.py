"""The kernels' limits are refused when an env is made, never at launch.

Every limit of the CUDA frame kernels' arrays (slots, lanes, lanes an
edge, route slots, successor edges and target speeds of the general
kernels, and under the connected-lane search predecessor edges and
candidates a lane; slots and lanes of the straight ones) is checked by
``make`` on every device, which raises ``NotImplementedError`` naming the
limit and "not ported".  So ``kernel_params``, ``lane_tables``,
``conn_tables`` and ``check_frame_shape`` never raise for an env that
``make`` returned: checked here for every registered id.

Three configs that the general kernels refused at launch before their
edge-lane and target-speed arrays were widened now make, and one policy
step of each from a JAX reset batch matches the JAX step (the XLA general
frame) on the CPU: exit-v0 with 8 lanes (9 lanes on the exit section's
edge), roundabout-v0 with 9 target speeds and merge-v0 with 10; and a
config that ``make`` refused before the lane tables held 64 lanes,
racetrack-oval-v0 with 5 lanes (40 lanes, 5 an edge, raw controls).
Tolerances: discrete fields exact, pos 2e-4 m, other continuous state
1e-4 of its magnitude, obs and reward 1e-5.
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
from highwayenv_tpu_torch.envs.merge import MergeEnv
from highwayenv_tpu_torch.ops import general_frames, straight_frames
from highwayenv_tpu_torch.road.network import StraightLane
from highwayenv_tpu_torch.vehicle.state import VehicleState

torch.set_num_threads(1)

B = 8
STATE_DISCRETE = ("lane", "target_lane", "crashed", "hit", "impact_pending",
                  "speed_index", "kind", "route_ptr")
STATE_CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer",
                    "impact", "steering", "accel")


def _meta(speeds):
    return {"action": {"type": "DiscreteMetaAction", "target_speeds": list(speeds)}}


class FivePredecessorMerge(MergeEnv):
    """merge with 3 more edges into node "b": 5 predecessor edges, one
    over the candidate tables' 4 under the connected-lane search."""

    def _build_scene(self):
        super()._build_scene()
        for k in range(3):
            self.net.add_lane(f"x{k}", "b", StraightLane(
                [100.0, 40.0 + 10.0 * k], [230.0, 40.0 + 10.0 * k]))
        self.geo = self.net.build(device=self.device)


def _make(env, config):
    """``ht.make`` of a registered id, or an env class made with ``config``."""
    return env(config, device="cpu") if isinstance(env, type) else ht.make(env, config,
                                                                            device="cpu")


#: (env id, config, lanes an edge, target speeds; None under raw controls)
PROBES = [
    ("exit-v0", {"lanes_count": 8}, 9, 3),
    ("roundabout-v0", _meta(np.linspace(0.0, 16.0, 9)), 2, 9),
    ("merge-v0", _meta(np.linspace(20.0, 30.0, 10)), 3, 10),
    ("racetrack-oval-v0", {"no_lanes": 5}, 5, None),
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
    if n_speeds is None:  # raw controls: no speed grid
        assert et.action_type.stores_raw_controls and params.n_speeds == 0
        assert params.L == et.geo.num_lanes > 32
    else:
        assert len(et.action_type.target_speeds) == n_speeds == params.n_speeds
        assert list(params.target_speeds[:n_speeds]) == list(
            np.asarray(et.action_type.target_speeds, np.float32))

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
    ("roundabout-v0", _meta(np.linspace(0.0, 16.0, 17)), "17 target speeds outside 2 to 16"),
    ("merge-v0", _meta([25.0]), "1 target speeds outside 2 to 16"),
    ("highway-v0", {"lanes_count": 17}, "17 straight lanes > 16"),
    ("highway-fast-v0", {"vehicles_count": 1024}, "1025 slots > 1024"),
    ("racetrack-oval-v0", {"no_lanes": 9}, "72 lanes > 64"),
    ("exit-v0", {"vehicles_count": 2048}, "2049 slots > 2048"),
    ("highway-v0", {"action": {"type": "ContinuousAction", "dynamical": True}},
     "a dynamical action on a straight road"),
    # a dynamical action under the connected-lane search is made now; the
    # search's own limits still hold under it
    (FivePredecessorMerge, {"neighbour_vehicles_connected_lanes": True, "action": {
        "type": "ContinuousAction", "dynamical": True}}, "5 predecessor edges > 4"),
], ids=["speeds-17", "speeds-1", "straight-lanes", "straight-slots", "general-lanes",
        "general-slots", "straight-dynamical", "connected-dynamical"])
def test_over_limit_configs_are_refused_at_make(env_id, config, what):
    with pytest.raises(NotImplementedError, match=f"{what}.*not ported"):
        _make(env_id, config)


@pytest.mark.parametrize("limits,what", [
    ((2049, 20, 4, 3, 2, 3), "2049 slots > 2048"),
    ((25, 65, 4, 3, 2, 3), "65 lanes > 64"),
    ((25, 64, 65, 3, 2, 3), "65 lanes an edge > 64"),
    ((25, 20, 4, 17, 2, 3), "17 route slots > 16"),
    ((25, 20, 4, 3, 5, 3), "5 successor edges > 4"),
    ((25, 20, 4, 3, 2, 17), "17 target speeds outside 2 to 16"),
], ids=["slots", "lanes", "edge-lanes", "route", "successors", "speeds"])
def test_each_general_limit_is_named(limits, what):
    assert general_frames.kernel_limits(*limits) == [what]
    assert general_frames.kernel_limits(1024, 64, 64, 16, 4, 16) == []
    assert general_frames.kernel_limits(1024, 64, 64, 16, 4, None) == []
    assert general_frames.kernel_limits(1024, 64, 64, 16, 4, 16, 4) == []
    assert general_frames.kernel_limits(2048, 64, 64, 16, 4, None, 4) == []


@pytest.mark.parametrize("limits,what", [
    ((25, 20, 4, 3, 3, 3, 5), ["5 predecessor edges > 4"]),
    ((25, 20, 4, 3, 4, 3, 5),
     ["5 predecessor edges > 4", "10 connected-lane candidates > 9"]),
    ((25, 20, 4, 3, 5, 3, 4),
     ["5 successor edges > 4", "10 connected-lane candidates > 9"]),
    # a dynamical action's raw controls (no target speeds): its law is
    # refused no more under the search, only the search's own tables
    ((25, 20, 4, 3, 3, None, 5), ["5 predecessor edges > 4"]),
], ids=["predecessors", "predecessors-and-candidates", "successors-and-candidates",
        "dynamical"])
def test_connected_limits_are_named(limits, what):
    """Under the connected-lane search (P given) the kernels' candidate
    tables hold MAX_CONN = 1 + MAX_SUCC + MAX_PRED lanes a lane."""
    assert general_frames.MAX_CONN == 1 + general_frames.MAX_SUCC + general_frames.MAX_PRED
    assert general_frames.kernel_limits(*limits) == what
    # without the search, predecessors are not read
    assert general_frames.kernel_limits(*limits[:6]) == what[:1] * (limits[4] > 4)


def test_a_route_longer_than_the_kernel_is_refused_at_make():
    """A route width the kernel does not hold is refused like the others,
    on any device, before the env is stepped."""
    from highwayenv_tpu_torch.envs.roundabout import RoundaboutEnv

    class LongRoutes(RoundaboutEnv):
        def _build_scene(self):
            super()._build_scene()
            self.route_slots = 17

    with pytest.raises(NotImplementedError, match="17 route slots > 16.*not ported"):
        LongRoutes(device="cpu")


def test_a_crowded_node_is_refused_under_the_connected_search():
    """merge with 8 more edges into node "b" (10 predecessor edges, 12
    candidate lanes): made without the connected-lane search, which never
    reads predecessors, refused with it."""
    from highwayenv_tpu_torch.envs.merge import MergeEnv
    from highwayenv_tpu_torch.road.network import StraightLane

    class CrowdedMerge(MergeEnv):
        def _build_scene(self):
            super()._build_scene()
            for k in range(8):
                self.net.add_lane(f"x{k}", "b", StraightLane(
                    [100.0, 40.0 + 10.0 * k], [230.0, 40.0 + 10.0 * k]))
            self.geo = self.net.build(device=self.device)

    env = CrowdedMerge(device="cpu")
    assert env.geo.pred_edge_base.shape[1] == 10 and env.geo.conn_lanes.shape[1] == 12
    with pytest.raises(NotImplementedError, match="10 predecessor edges > 4, 12 "
                       "connected-lane candidates > 9 not ported"):
        CrowdedMerge({"neighbour_vehicles_connected_lanes": True}, device="cpu")


@pytest.mark.parametrize("env_id", ht.registered_ids())
def test_every_made_env_builds_its_launch(env_id):
    env = ht.make(env_id, device="cpu")
    params = _launch_tables(env)
    if params is not None:
        assert params.M == env.max_edge_lanes and params.R == env.route_slots
