"""The connected-lane neighbour search of the -v1 / -v2 ids against the JAX package, on the CPU.

The reference's ``neighbour_vehicles_connected_lanes`` mode (the JAX
package's ``vehicle/behavior.py::neighbours_connected``): a neighbour query
on lane q also searches q's successor and predecessor lanes, each object on
the first candidate lane it is on, its s shifted into q's frame.

  - the candidate tables ``conn_lanes`` / ``conn_offsets`` equal the JAX
    package's exactly at all 11 connected ids, and the kernels' padded
    copy (``general_frames.conn_tables``) holds them;
  - the port's ``neighbours_connected`` equals the JAX function (front and
    rear index and existence, exactly) on the same projection tables, on
    seeded states of u-turn-v1, merge-v1, exit-v1, roundabout-v1,
    racetrack-v1 and intersection-v2, and on crafted tables with equal s on
    several candidate lanes and equal keys across slots (the tie rules);
  - three policy steps of ``step_autoreset_batched`` from a port reset batch
    against the JAX package's ``step_batched`` (its vmapped XLA frame: the
    JAX kernels have no connected branch) at roundabout-v1, merge-v1,
    racetrack-v1 (raw controls) and intersection-v2 (no spawns), each step
    from the JAX state of the step before: discrete fields exact, pos,
    speed and heading within 5e-4, other state within 1e-4 of its
    magnitude, obs and reward within 1e-5;
  - the other connected ids make, reset and step on the CPU, through the
    plain frames (no kernel launch).
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
from highwayenv_tpu.vehicle import behavior as j_behavior
from highwayenv_tpu.vehicle.state import VehicleState as JaxVehicleState
from highwayenv_tpu_torch.bridge import from_numpy_state, to_numpy_state
from highwayenv_tpu_torch.ops import general_frames
from highwayenv_tpu_torch.parallel.rollout import random_actions
from highwayenv_tpu_torch.road import lane as t_lane
from highwayenv_tpu_torch.vehicle import behavior
from highwayenv_tpu_torch.vehicle.state import KIND_IDM, KIND_LANDMARK, VehicleState

torch.set_num_threads(1)

B = 8
CONNECTED_IDS = [
    "merge-v1", "merge-generic-v1", "u-turn-v1", "exit-v1", "roundabout-v1",
    "roundabout-generic-v1", "racetrack-v1", "racetrack-large-v1", "racetrack-oval-v1",
    "intersection-v2", "intersection-multi-agent-v2",
]
SEARCH_IDS = ["u-turn-v1", "merge-v1", "exit-v1", "roundabout-v1", "racetrack-v1",
              "intersection-v2"]
STEP_IDS = ["roundabout-v1", "merge-v1", "racetrack-v1", "intersection-v2"]
#: intersection-v2 without spawns: the JAX package's draw from its own key
CONFIGS = {"intersection-v2": {"spawn_probability": 0.0}}
DISCRETE = ("lane", "target_lane", "route_ptr", "crashed", "hit", "impact_pending",
            "speed_index", "kind", "is_yielding", "yield_timer")
CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer", "impact", "steering",
              "accel")
STEP_ATOL = {"pos": 5e-4, "speed": 5e-4, "heading": 5e-4}
HEAD_ATOL = 1e-5


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


@pytest.mark.parametrize("env_id", CONNECTED_IDS)
def test_conn_tables_match_jax(env_id):
    ej, et = hj.make(env_id), ht.make(env_id, device="cpu")
    assert ej.config["neighbour_vehicles_connected_lanes"] and et._general.connected
    want_l, want_o = np.asarray(ej.geo.conn_lanes), np.asarray(ej.geo.conn_offsets)
    np.testing.assert_array_equal(et.geo.conn_lanes.numpy(), want_l)
    assert et.geo.conn_offsets.dtype == torch.float32
    np.testing.assert_array_equal(et.geo.conn_offsets.numpy().view(np.int32),
                                  want_o.astype(np.float32).view(np.int32))
    # column 0 is the lane itself at offset 0; the kernels' copy has the
    # scene's K = 1 + S + P columns
    L, K = want_l.shape
    assert (want_l[:, 0] == np.arange(L)).all() and (want_o[:, 0] == 0).all()
    lanes, offsets = general_frames.conn_tables(et.geo, "cpu")
    assert K == 1 + et.geo.succ_edge_base.shape[1] + et.geo.pred_edge_base.shape[1]
    assert lanes.shape == offsets.shape == (L, K) and lanes.dtype == torch.int32
    assert torch.equal(lanes, et.geo.conn_lanes) and torch.equal(offsets, et.geo.conn_offsets)


def _jax_search(ej):
    """The JAX package's ``neighbours_connected`` over a batch, jitted."""

    def one(veh, query, s, lat):
        n = j_behavior.neighbours_connected(ej.geo, veh, query, s, lat)
        return n.front_idx, n.front_ex, n.rear_idx, n.rear_ex

    return jax.jit(jax.vmap(one))


def _held_to_jax(search, et, veh, query, s, lat, where) -> int:
    """The port's search against the JAX one on the same tables; returns
    the neighbours found."""
    veh_j = JaxVehicleState(**{f.name: jnp.asarray(getattr(veh, f.name).numpy())
                               for f in dataclasses.fields(VehicleState)})
    fi, fe, ri, re_ = (np.asarray(x) for x in search(
        veh_j, jnp.asarray(query.numpy()), jnp.asarray(s.numpy()), jnp.asarray(lat.numpy())))
    front, rear = behavior.neighbours_connected(et.geo, veh, query, s, lat)
    front, rear = front.numpy(), rear.numpy()
    np.testing.assert_array_equal(front >= 0, fe, err_msg=f"{where} front exists")
    np.testing.assert_array_equal(rear >= 0, re_, err_msg=f"{where} rear exists")
    np.testing.assert_array_equal(np.where(fe, front, -1), np.where(fe, fi, -1),
                                  err_msg=f"{where} front")
    np.testing.assert_array_equal(np.where(re_, rear, -1), np.where(re_, ri, -1),
                                  err_msg=f"{where} rear")
    return int(fe.sum() + re_.sum())


@pytest.mark.parametrize("env_id", SEARCH_IDS)
def test_neighbours_connected_matches_jax(env_id):
    """On a reset batch and two plain steps in, every slot's own lane and
    target lane as the query, and every lane of the network queried by
    every slot."""
    ej, et = hj.make(env_id), ht.make(env_id, device="cpu")
    search = _jax_search(ej)
    gen = et.generator(11)
    _, st = et.reset(B, gen)
    found = 0
    for step in range(3):
        veh = st.vehicles
        s, lat = t_lane.projection_table(et.geo, veh.pos)
        for name, query in (("lane", veh.lane), ("target_lane", veh.target_lane)):
            found += _held_to_jax(search, et, veh, query, s, lat, f"{env_id} {step} {name}")
        for lane in range(et.geo.num_lanes):
            query = torch.full_like(veh.lane, lane)
            found += _held_to_jax(search, et, veh, query, s, lat, f"{env_id} {step} {lane}")
        st = et.step_autoreset(st, random_actions(et, B, gen), gen)[1]
    assert found > 0


@pytest.mark.parametrize("env_id", ["u-turn-v1", "intersection-v2"])
def test_connected_tie_rules_match_jax(env_id):
    """Crafted tables: s on a 2.5 m grid (equal keys across slots and
    across candidate lanes), lat 0 on most entries (a slot on several
    candidate lanes takes the first), slots 2 and 3 on the same spot of
    every lane (the front keeps 3, the rear 2), a landmark and an empty
    slot; every lane queried by every slot."""
    ej, et = hj.make(env_id), ht.make(env_id, device="cpu")
    search = _jax_search(ej)
    _, st = et.reset(B, et.generator(3))
    veh = st.vehicles
    V, L = et.num_slots, et.geo.num_lanes
    rng = np.random.default_rng(V)
    length = et.geo.length.numpy()[None, :, None]
    s = np.round(rng.uniform(-7.0, 1.0, (B, L, V)) * (length + 10.0) / 2.5) * 2.5
    s = np.where(rng.random((B, L, V)) < 0.3, 0.0, s)  # many slots at s = 0 on a lane
    lat = np.where(rng.random((B, L, V)) < 0.7, 0.0, rng.uniform(-5.0, 5.0, (B, L, V)))
    s[..., 3], lat[..., 3] = s[..., 2], lat[..., 2]
    kind = veh.kind.clone()
    kind[:, 1] = KIND_LANDMARK
    kind[:, 2:4] = KIND_IDM
    kind[:, -2] = 0
    veh = veh.replace(kind=kind)
    s_t = torch.from_numpy(s.astype(np.float32))
    lat_t = torch.from_numpy(lat.astype(np.float32))
    found = ties = 0
    for lane in range(L):
        query = torch.full_like(veh.lane, lane)
        found += _held_to_jax(search, et, veh, query, s_t, lat_t, f"{env_id} lane {lane}")
        front, rear = behavior.neighbours_connected(et.geo, veh, query, s_t, lat_t)
        ties += int(((front == 3) | (rear == 2)).sum())
    assert found > 0 and ties > 0


@pytest.mark.parametrize("env_id", STEP_IDS)
def test_steps_match_jax(env_id):
    """The roundabout ego never brakes (no SLOWER), as in
    test_torch_general.py: its target speed 0 takes it below ~0.5 m/s,
    where the steering law divides by the speed and a 1-ulp difference of
    the two CPU libms passes 5e-4 m within a policy step; that regime is
    held frame by frame there (the connected search does not touch the
    steering law)."""
    config = CONFIGS.get(env_id)
    ej, et = hj.make(env_id, config), ht.make(env_id, config, device="cpu")
    assert et._general.connected
    step_j = jax.jit(ej.step_batched)
    gen = et.generator(7)
    _, st = et.reset(B, gen)
    sj = _jax_state(st, 7)
    for step in range(3):
        acts = random_actions(et, B, gen)
        if env_id == "roundabout-v1":
            acts = torch.remainder(acts, 4)
        obs_j, sj, rew_j, term_j, trunc_j, _ = step_j(sj, jnp.asarray(acts.numpy()))
        obs_t, st_t, rew_t, term_t, trunc_t, _ = et.step_autoreset_batched(
            st, acts, et.generator(100 + step))
        np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j))
        np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j))
        keep = ~(term_t | trunc_t).numpy()
        where = f"{env_id} step {step}"
        _close(rew_t, rew_j, HEAD_ATOL, f"{where} reward")
        _close(obs_t.numpy()[keep], np.asarray(obs_j)[keep], HEAD_ATOL, f"{where} obs")
        vt, vj = st_t.vehicles, sj.vehicles
        for name in DISCRETE:
            np.testing.assert_array_equal(getattr(vt, name).numpy()[keep],
                                          np.asarray(getattr(vj, name))[keep],
                                          err_msg=f"{where} {name}")
        for name in CONTINUOUS:
            b = np.asarray(getattr(vj, name))[keep]
            tol = STEP_ATOL.get(name, 1e-4 * max(1.0, float(np.abs(b).max())))
            _close(getattr(vt, name).numpy()[keep], b, tol, f"{where} {name}")
        st = _port_state(sj)  # the next step from the JAX state


@pytest.mark.parametrize("env_id", sorted(set(CONNECTED_IDS) - set(STEP_IDS)))
def test_other_connected_ids_make_reset_and_step(env_id):
    et = ht.make(env_id, device="cpu")
    assert et._general is not None and et._general.connected
    before = [k.launches for k in (general_frames.frames_general_connected_kernel,
                                   general_frames.frames_regulated_connected_kernel)]
    gen = et.generator(1)
    _, st = et.reset(2, gen)
    obs, st, reward, term, trunc, _ = et.step_autoreset_batched(
        st, random_actions(et, 2, gen), gen)
    after = [k.launches for k in (general_frames.frames_general_connected_kernel,
                                  general_frames.frames_regulated_connected_kernel)]
    assert after == before  # CPU tensors: the plain frames
    for o in obs if isinstance(obs, tuple) else (obs,):
        assert bool(torch.isfinite(o).all())
    assert bool(torch.isfinite(reward).all()) and bool(torch.isfinite(st.vehicles.pos).all())


def test_each_wrapper_takes_only_its_own_spec():
    """The connected instantiations take a connected spec and the v0 ones a
    spec without it; on CPU tensors each runs the plain frames and counts
    no launch."""
    v1, v0 = ht.make("roundabout-v1", device="cpu"), ht.make("roundabout-v0", device="cpu")
    _, st = v1.reset(2, v1.generator(0))
    sa = v1._action_to_slots(random_actions(v1, 2, v1.generator(1)))
    k4, k4c = general_frames.frames_general_kernel, general_frames.frames_general_connected_kernel
    with pytest.raises(ValueError, match="connected spec"):
        k4c(st.vehicles, v0._general, sa, 1)
    with pytest.raises(ValueError, match="connected spec"):
        k4(st.vehicles, v1._general, sa, 1)
    before = k4c.launches
    out = k4c(st.vehicles, v1._general, sa, 2)
    want = general_frames.frames_general_plain(st.vehicles, v1._general, sa, 2)
    assert k4c.launches == before
    for f in dataclasses.fields(VehicleState):
        assert torch.equal(getattr(out, f.name), getattr(want, f.name)), f.name
    assert (k4c.entry, general_frames.frames_regulated_connected_kernel.entry) == (
        "general_frames_connected", "general_frames_regulated_connected")
