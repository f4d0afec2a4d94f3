"""roundabout-v0 and merge-v0 in the port against the JAX package, on the CPU.

One ``step_autoreset_batched`` from a JAX reset batch carried across with
the same actions: obs, reward, terminated, truncated, info and the state of
the rows that go on match the JAX step (the XLA general frame on the CPU);
the done rows equal the port's own ``_reset`` drawn from a clone of the
step's generator.  Tolerances as in test_torch_env.py: booleans and lanes
exact, pos 2e-4 m, other continuous state 1e-4 of its magnitude, obs and
reward 1e-5.

Resets draw from a ``torch.Generator`` where the JAX package splits
threefry keys, so they are held to the JAX resets by their invariants and by
seeded two-sample tests of the drawn quantities.  Then the general path's
gate: which envs take it and which configurations raise, naming why.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy import stats

import highwayenv_tpu as hj
import highwayenv_tpu_torch as ht
from highwayenv_tpu_torch.bridge import from_numpy_state
from highwayenv_tpu_torch.envs.roundabout import RoundaboutEnv
from highwayenv_tpu_torch.ops import general_frames
from highwayenv_tpu_torch.parallel.rollout import rollout
from highwayenv_tpu_torch.road import lane as t_lane
from highwayenv_tpu_torch.road.network import RoadNetworkBuilder
from highwayenv_tpu_torch.vehicle.state import (
    KIND_EGO,
    KIND_IDM,
    KIND_OBSTACLE,
    VehicleState,
)

torch.set_num_threads(1)

B = 8
N_RESET = 256
STATE_DISCRETE = ("lane", "target_lane", "crashed", "hit", "impact_pending",
                  "speed_index", "kind", "route_ptr")
STATE_CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer",
                    "impact", "steering", "accel")
HEAD_ATOL = 1e-5
CASES = {
    "roundabout-v0": ("crashed_ego", "near_duration"),
    "merge-v0": ("crashed_ego", "past_the_end"),
}

_SETUP: dict = {}


def _setup(env_id):
    """JAX env, port env, a JAX reset batch and the jitted JAX step, built
    once per env so the JAX step compiles once per test process."""
    if env_id not in _SETUP:
        ej = hj.make(env_id)
        et = ht.make(env_id, device="cpu")
        _, states = jax.jit(jax.vmap(ej._reset))(
            jax.random.split(jax.random.PRNGKey(3), B)
        )
        _SETUP[env_id] = (ej, et, states, jax.jit(ej.step_autoreset_batched))
    return _SETUP[env_id]


def _numpy_state(states) -> dict:
    return {
        "vehicles": {
            f.name: np.asarray(getattr(states.vehicles, f.name))
            for f in dataclasses.fields(VehicleState)
        },
        "time": np.asarray(states.time),
        "steps": np.asarray(states.steps),
    }


def _ending(states, et, case):
    """Rows 0, 2, 4 and 6 end this step: a crashed ego, one policy step
    left before ``duration`` (roundabout), or the ego 1 m short of merge's
    x = 370 end line."""
    ending = np.arange(B) % 2 == 0
    veh = states.vehicles
    if case == "crashed_ego":
        crashed = np.asarray(veh.crashed).copy()
        crashed[ending, 0] = True
        return states.replace(vehicles=veh.replace(crashed=jnp.asarray(crashed)))
    if case == "past_the_end":
        pos = np.asarray(veh.pos).copy()
        pos[ending, 0, 0] = 369.0
        return states.replace(vehicles=veh.replace(pos=jnp.asarray(pos)))
    time = np.asarray(states.time).copy()
    time[ending] = et.config["duration"] - 1.0 / et.config["policy_frequency"]
    return states.replace(time=jnp.asarray(time))


def _close(a, b, atol, where):
    np.testing.assert_allclose(
        np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=0,
        atol=atol, err_msg=where,
    )


@pytest.mark.parametrize(
    "env_id,case", [(e, c) for e in CASES for c in CASES[e]]
)
def test_step_autoreset_batched_matches_jax(env_id, case):
    ej, et, states, jstep = _setup(env_id)
    sj = _ending(states, et, case)
    st = from_numpy_state(_numpy_state(sj))
    acts = np.random.default_rng(11).integers(0, et.action_type.n, B).astype(np.int32)

    obs_j, st_j, rew_j, term_j, trunc_j, info_j = jstep(sj, jnp.asarray(acts))
    gen = et.generator(5)
    gen_clone = et.generator(0)
    gen_clone.set_state(gen.get_state())
    obs_t, st_t, rew_t, term_t, trunc_t, info_t = et.step_autoreset_batched(
        st, torch.from_numpy(acts), gen
    )

    done = (term_t | trunc_t).numpy()
    np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j))
    np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j))
    assert done[::2].all() and not done[1::2].any()
    _close(rew_t, rew_j, HEAD_ATOL, "reward")
    _close(info_t["speed"], info_j["speed"], 1e-4 * 40.0, "info speed")
    np.testing.assert_array_equal(info_t["crashed"].numpy(), np.asarray(info_j["crashed"]))
    assert set(info_t["rewards"]) == set(info_j["rewards"])
    for name, value in info_t["rewards"].items():
        _close(value, info_j["rewards"][name], HEAD_ATOL, f"info rewards {name}")

    keep = ~done
    _close(obs_t.numpy()[keep], np.asarray(obs_j)[keep], HEAD_ATOL, "obs")
    np.testing.assert_array_equal(st_t.steps.numpy()[keep], np.asarray(st_j.steps)[keep])
    for name in STATE_DISCRETE:
        np.testing.assert_array_equal(
            getattr(st_t.vehicles, name).numpy()[keep],
            np.asarray(getattr(st_j.vehicles, name))[keep], err_msg=name,
        )
    for name in STATE_CONTINUOUS:
        b = np.asarray(getattr(st_j.vehicles, name))[keep]
        tol = 2e-4 if name == "pos" else 1e-4 * max(1.0, float(np.abs(b).max()))
        _close(getattr(st_t.vehicles, name).numpy()[keep], b, tol, name)

    # done rows: the port's own reset from the generator as it stood
    obs_r, st_r = et._reset(B, gen_clone)
    np.testing.assert_array_equal(obs_t.numpy()[done], obs_r.numpy()[done])
    for f in dataclasses.fields(VehicleState):
        np.testing.assert_array_equal(
            getattr(st_t.vehicles, f.name).numpy()[done],
            getattr(st_r.vehicles, f.name).numpy()[done], err_msg=f.name,
        )


def _resets(env_id, seed_t=1, seed_j=2):
    ej, et, _, _ = _setup(env_id)
    _, st = et.reset(N_RESET, et.generator(seed_t))
    _, sj = jax.jit(jax.vmap(ej._reset))(jax.random.split(jax.random.PRNGKey(seed_j), N_RESET))
    return et, st.vehicles, from_numpy_state(_numpy_state(sj)).vehicles


def _ks(name, a, b):
    p = stats.ks_2samp(np.ravel(a), np.ravel(b)).pvalue
    assert p > 1e-3, f"{name}: KS p-value {p}"


def _destinations(et, veh):
    """(N, 4) index of each NPC's destination, read back from its route."""
    routes = torch.stack([veh.route_base, veh.route_n, veh.route_id], dim=2)[:, 1:]
    cand = et._npc_routes  # (4 NPCs, 3 destinations, 3, R)
    match = (routes[:, :, None] == cand[None]).flatten(3).all(dim=-1)  # (N, 4, 3)
    assert bool(match.any(dim=-1).all())
    return match.int().argmax(dim=-1).numpy()


def test_roundabout_reset_invariants_and_distribution_match_jax():
    et, vt, vj = _resets("roundabout-v0")
    kind = vt.kind.numpy()
    assert (kind[:, 0] == KIND_EGO).all() and (kind[:, 1:] == KIND_IDM).all()
    assert (vt.target_lane == vt.lane).all() and (vt.route_ptr == 0).all()
    # the ego: deterministic, the same as JAX's
    for name in ("pos", "heading", "speed", "target_speed", "speed_index", "lane",
                 "route_base", "route_n", "route_id", "route_len"):
        np.testing.assert_array_equal(
            getattr(vt, name)[:, 0].numpy(), getattr(vj, name)[:, 0].numpy(), err_msg=name
        )
    assert (vt.speed[:, 0] == 8.0).all() and (vt.speed_index[:, 0] == 1).all()
    # NPCs on their spawn lanes: s jitter N(0, 2), speed N(16, 2), delta
    # U(3.5, 4.5), destinations uniform over 3
    lane = et._spawn_lane.expand(N_RESET, 4)

    def jitter(veh):
        s, lat = t_lane.local_coordinates(et.geo, lane, veh.pos[:, 1:])
        assert float(lat.abs().max()) < 1e-3
        return (s - et._spawn_s).numpy()

    _ks("npc s jitter", jitter(vt), jitter(vj))
    _ks("npc speed", vt.speed[:, 1:].numpy(), vj.speed[:, 1:].numpy())
    _ks("npc delta", vt.delta[:, 1:].numpy(), vj.delta[:, 1:].numpy())
    assert abs(float(jitter(vt).std()) - 2.0) < 0.2
    assert abs(float(vt.speed[:, 1:].mean()) - 16.0) < 0.3
    d_t, d_j = _destinations(et, vt), _destinations(et, vj)
    counts = np.stack([np.bincount(d.ravel(), minlength=3) for d in (d_t, d_j)])
    assert stats.chi2_contingency(counts).pvalue > 1e-3
    assert stats.chisquare(counts[0]).pvalue > 1e-3  # uniform over 3
    # the MOBIL timer is seeded from the position, as in the reference
    timer = torch.remainder((vt.pos[..., 0] + vt.pos[..., 1]) * np.pi, 1.0)
    torch.testing.assert_close(vt.timer, timer, rtol=0, atol=1e-6)


def test_incoming_vehicle_destination_is_honoured():
    et = ht.make("roundabout-v0", {"incoming_vehicle_destination": 2}, device="cpu")
    _, st = et.reset(16, et.generator(0))
    d = _destinations(et, st.vehicles)
    assert (d[:, 0] == 2).all() and len(np.unique(d[:, 1:])) > 1


def test_merge_reset_invariants_and_distribution_match_jax():
    et, vt, vj = _resets("merge-v0")
    kind = vt.kind.numpy()
    np.testing.assert_array_equal(
        kind, np.broadcast_to([KIND_EGO] + [KIND_IDM] * 4 + [KIND_OBSTACLE], kind.shape)
    )
    # deterministic slots: the ego, the ramp vehicle and the obstacle at
    # the end of the ramp, lbc.position(80, 0); the obstacle is 2 m x 2 m
    for slot in (0, 4, 5):
        for name in ("pos", "heading", "speed", "target_speed", "lane", "length", "width"):
            np.testing.assert_array_equal(
                getattr(vt, name)[:, slot].numpy(), getattr(vj, name)[:, slot].numpy(),
                err_msg=f"slot {slot} {name}",
            )
    lbc = et.net.get_lane(("b", "c", 2))
    np.testing.assert_array_equal(
        vt.pos[0, 5].numpy(), np.asarray(lbc.position(80.0, 0.0), np.float32)
    )
    assert (vt.target_speed[:, 4] == 30.0).all() and (vt.speed[:, 4] == 20.0).all()
    assert (vt.length[:, 5] == 2.0).all() and (vt.width[:, 5] == 2.0).all()
    # three highway NPCs: s in {90, 70, 5} + U(-5, 5) on a random lane of
    # a -> b, speeds {29, 31, 31.5} + U(-1, 1)
    ds_t = vt.pos[:, 1:4, 0].numpy() - np.array([90.0, 70.0, 5.0])
    ds_j = vj.pos[:, 1:4, 0].numpy() - np.array([90.0, 70.0, 5.0])
    dv_t = vt.speed[:, 1:4].numpy() - np.array([29.0, 31.0, 31.5])
    dv_j = vj.speed[:, 1:4].numpy() - np.array([29.0, 31.0, 31.5])
    assert np.abs(ds_t).max() <= 5.0 + 1e-4 and np.abs(dv_t).max() <= 1.0 + 1e-5
    _ks("npc s jitter", ds_t, ds_j)
    _ks("npc speed jitter", dv_t, dv_j)
    lanes_t, lanes_j = vt.lane[:, 1:4].numpy(), vj.lane[:, 1:4].numpy()
    assert set(np.unique(lanes_t)) == {0, 1}
    counts = np.stack([np.bincount(x.ravel(), minlength=2) for x in (lanes_t, lanes_j)])
    assert stats.chi2_contingency(counts).pvalue > 1e-3


def test_general_gate_and_what_it_refuses():
    for env_id in ("roundabout-v0", "merge-v0"):
        env = ht.make(env_id, device="cpu")
        assert env._straight is None and env._general is not None, env_id
    env = ht.make("highway-v0", device="cpu")
    assert env._straight is not None and env._general is None
    # the -v1 variants' connected-lane neighbour search: the same gate, its spec
    # carries the search
    env = ht.make("roundabout-v0", {"neighbour_vehicles_connected_lanes": True}, device="cpu")
    assert env._general is not None and env._general.connected
    # a regulated road takes the general path too, with its tick period

    class Regulated(RoundaboutEnv):
        regulated = True

    reg = Regulated(device="cpu")
    assert reg._general is not None and reg._general.period == 7
    assert ht.make("roundabout-v0", device="cpu")._general.period is None

    # more slots than the global kernels hold

    class Crowded(RoundaboutEnv):
        def _build_scene(self):
            super()._build_scene()
            self.num_slots = general_frames.GLOBAL_SLOTS + 1

    limit = general_frames.GLOBAL_SLOTS
    with pytest.raises(NotImplementedError, match=f"{limit + 1} slots > {limit}"):
        Crowded(device="cpu")
    # lane kinds other than straight, sine and circular
    with pytest.raises(NotImplementedError, match="not ported"):
        RoadNetworkBuilder().add_lane("a", "b", object())
    # an id not registered in the port: NotImplementedError (and KeyError);
    # intersection-multi-agent-v1, the last id, is registered now
    with pytest.raises(NotImplementedError, match="not ported"):
        ht.make("no-such-env-v0", device="cpu")
    with pytest.raises(KeyError, match="not ported"):
        ht.make("no-such-env-v0", device="cpu")
    assert ht.make("intersection-multi-agent-v1", device="cpu").ego_slots == (24, 25)
    # intersection-v1 is made: the regulated road under a dynamical action
    env = ht.make("intersection-v1", device="cpu")
    assert env.regulated and env._general.dynamical


@pytest.mark.parametrize("env_id", ["roundabout-v0", "merge-v0"])
def test_rollout_on_the_cpu_is_finite_and_launches_no_kernel(env_id):
    et = ht.make(env_id, device="cpu")
    gen = et.generator(0)
    _, states = et.reset(4, gen)
    before = general_frames.frames_general_kernel.launches
    states, metrics = rollout(et, states, 3, gen)
    assert general_frames.frames_general_kernel.launches == before
    for name, value in metrics.items():
        assert value.shape == () and bool(torch.isfinite(value)), name
    assert 0.0 <= float(metrics["mean_reward"]) <= 1.0
    assert bool(torch.isfinite(states.vehicles.pos).all())
