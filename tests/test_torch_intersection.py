"""intersection-v0 in the port against the JAX package, on the CPU.

The road network and its route tables field by field; the spawn placement
fed the JAX package's own draws, the clearing of leaving NPCs and the
arrival test, exactly; one ``step_autoreset_batched`` from a JAX reset batch
with the same actions and no spawns (``spawn_probability=0``): obs, reward,
terminated, truncated and info within 1e-5, the state of the rows that go
on as in test_torch_regulated.py, and the done rows equal to the port's own
reset drawn from a clone of the step's generator after the population
hook's draws.  Resets draw from a ``torch.Generator`` where the JAX package
splits threefry keys, so they are held to the JAX resets by their
invariants and by seeded two-sample tests.  Then the registry's other
intersection ids, and a CPU rollout that launches no kernel.
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
from highwayenv_tpu_torch.envs.intersection import SpawnDraws
from highwayenv_tpu_torch.ops import general_frames
from highwayenv_tpu_torch.parallel.rollout import rollout
from highwayenv_tpu_torch.road import lane as t_lane
from highwayenv_tpu_torch.vehicle.behavior import IDMParams
from highwayenv_tpu_torch.vehicle.state import KIND_EGO, KIND_IDM, KIND_PAD, VehicleState

torch.set_num_threads(1)

B = 8
N_RESET = 256
CONFIG = {"spawn_probability": 0.0}
STATE_DISCRETE = ("lane", "target_lane", "route_ptr", "crashed", "hit", "impact_pending",
                  "speed_index", "kind", "is_yielding", "yield_timer")
STATE_CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer", "impact",
                    "steering", "accel")
STEP_ATOL = {"pos": 5e-4, "speed": 5e-4, "heading": 5e-4, "target_speed": 5e-4}
HEAD_ATOL = 1e-5
GEO_FIELDS = ("kind", "start", "end", "direction", "direction_lateral", "heading0",
              "center", "radius", "start_phase", "cw", "width", "length", "speed_limit",
              "forbidden", "priority", "line_types", "from_node", "to_node", "lane_id",
              "edge_id", "edge_base", "edge_n", "succ_edge_base", "succ_edge_n",
              "pred_edge_base", "pred_edge_n")

_SETUP: dict = {}


def _setup():
    """JAX env, port env, one JAX reset batch of N_RESET envs (the step's
    rows are its first B) and the jitted JAX step, each compiled once per
    test process."""
    if not _SETUP:
        ej = hj.make("intersection-v0", CONFIG)
        et = ht.make("intersection-v0", CONFIG, device="cpu")
        _, states = jax.jit(jax.vmap(ej._reset))(
            jax.random.split(jax.random.PRNGKey(2), N_RESET)
        )
        _SETUP.update(ej=ej, et=et, states=states, step=jax.jit(ej.step_autoreset_batched))
    return _SETUP


def _numpy_state(states) -> dict:
    return {
        "vehicles": {f.name: np.array(getattr(states.vehicles, f.name))
                     for f in dataclasses.fields(VehicleState)},
        "time": np.array(states.time),
        "steps": np.array(states.steps),
    }


def _rows(states, n):
    return jax.tree.map(lambda x: x[:n], states)


def _close(a, b, atol, where):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=atol, err_msg=where)


def test_network_and_route_tables_match_jax():
    s = _setup()
    ej, et = s["ej"], s["et"]
    assert list(et.net.edges) == list(ej.net.edges)
    assert et.geo.num_lanes == 20 and et.geo.all_straight is False
    for name in GEO_FIELDS:
        t = getattr(ej.geo, name)
        np.testing.assert_array_equal(getattr(et.geo, name).numpy(),
                                      np.asarray(t.a if hasattr(t, "a") else t), err_msg=name)
    # all 12 routes between distinct corners
    for mine, theirs in zip(et._routes, ej._routes):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    for i in range(4):
        for j in range(4):
            if i != j:
                got = et.net.route_arrays((f"o{i}", f"ir{i}", 0), f"o{j}", 3)
                want = ej.net.route_arrays((f"o{i}", f"ir{i}", 0), f"o{j}", 3)
                for a, b in zip(got, want):
                    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(et._spawn_lane.numpy(), np.asarray(ej._spawn_lane))
    np.testing.assert_array_equal(et._exit_lane_mask.numpy(), np.asarray(ej._exit_lane_mask))
    assert int(et._exit_lane_mask.sum()) == 4
    # the slots: 9 initial NPCs, the challenger, 14 spawn slots, the ego
    assert et.num_slots == ej.num_slots == 25 and et.ego_slots == ej.ego_slots == (24,)
    assert (et._initial_steps, et._warmup_frames, et._regulation_period) == (45, 45, 7)


def test_idm_params_hook():
    et = _setup()["et"]
    want = IDMParams(distance_wanted=7.0, comfort_acc_max=6.0, comfort_acc_min=-3.0)
    assert et.idm_params == want and et._general.p == want
    assert ht.make("roundabout-v0", device="cpu").idm_params == IDMParams()


def _jax_spawn(case):
    """(JAX state before, the six draws of each row, JAX state after) of one
    spawn attempt per row, split from each row's key as
    ``_spawn_into_slot`` splits it."""
    s = _setup()
    ej = s["ej"]
    veh = _rows(s["states"], B).vehicles
    kind = np.array(veh.kind)
    slot, longitudinal, kw = {
        "initial": (3, float(np.linspace(0, 80, 10)[3]), {}),
        "challenger": (9, 60.0, dict(position_deviation=0.1, speed_deviation=0.0,
                                     spawn_probability=1.0, go_straight=True)),
        "runtime": (None, 0.0, dict(spawn_probability=0.6)),
    }[case]
    if slot is not None:
        kind[::2, slot] = KIND_PAD  # a free slot in half the rows
    else:
        kind[1, :ej._n_npc] = KIND_IDM  # no free slot: slot 0 is refused
        kind[2, 5:ej._n_npc] = KIND_PAD
    veh = veh.replace(kind=jnp.asarray(kind))

    def one(v, key):
        free = jnp.argmax(v.kind[: ej._n_npc] == KIND_PAD) if slot is None else slot
        k_p, k_r0, k_r1, k_pos, k_speed, k_delta = jax.random.split(key, 6)
        draws = (
            jax.random.uniform(k_p), jax.random.randint(k_r0, (), 0, 4),
            jax.random.randint(k_r1, (), 1, 4), jax.random.normal(k_pos),
            jax.random.normal(k_speed),
            jax.random.uniform(k_delta, (), minval=3.5, maxval=4.5),
        )
        return draws, ej._spawn_into_slot(v, free, key, jnp.float32(longitudinal), **kw)

    keys = jax.random.split(jax.random.PRNGKey({"initial": 1, "challenger": 2,
                                                "runtime": 3}[case]), B)
    draws, out = jax.jit(jax.vmap(one))(veh, keys)
    return veh, slot, longitudinal, kw, draws, out


@pytest.mark.parametrize("case", ["initial", "challenger", "runtime"])
def test_spawn_placement_fed_jax_draws_matches_jax(case):
    s = _setup()
    et = s["et"]
    veh_j, slot, longitudinal, kw, draws, out_j = _jax_spawn(case)
    veh_t = from_numpy_state(_numpy_state(s["states"].replace(vehicles=veh_j))).vehicles
    d = SpawnDraws(*(torch.from_numpy(np.array(x)) for x in draws))
    if slot is None:
        slot = (veh_t.kind[:, : et._n_npc] == KIND_PAD).int().argmax(dim=1)
    out_t = et.place_spawn(veh_t, slot, d, longitudinal, **kw)
    for f in dataclasses.fields(VehicleState):
        np.testing.assert_array_equal(getattr(out_t, f.name).numpy(),
                                      np.asarray(getattr(out_j, f.name)), err_msg=f.name)
    placed = (out_t.kind != veh_t.kind).any(dim=1)
    assert bool(placed.any()) and (case == "challenger" or not bool(placed.all()))


def test_clear_vehicles_and_has_arrived_match_jax():
    """From a JAX batch with NPCs near the end of the exit lanes and the ego
    at and past 25 m into one."""
    s = _setup()
    ej, et = s["ej"], s["et"]
    st = _rows(s["states"], B)
    v = _numpy_state(st)["vehicles"]
    for b in range(B):
        for k, slot in enumerate(range(4)):
            lane_index = (f"il{k}", f"o{k}", 0)
            g = et.net.global_lane_index(lane_index)
            length = float(et.geo.length[g])
            sv = length - 4 * 5.0 - 1.0 + 0.5 * b  # 4 vehicle lengths from the end
            pos = t_lane.position(et.geo, torch.tensor([g]), torch.tensor([sv]),
                                  torch.zeros(1))[0]
            v["pos"][b, slot], v["lane"][b, slot], v["kind"][b, slot] = pos.numpy(), g, KIND_IDM
        g = et.net.global_lane_index(("il1", "o1", 0))
        pos = t_lane.position(et.geo, torch.tensor([g]), torch.tensor([21.0 + b]),
                              torch.zeros(1))[0]
        v["pos"][b, 24], v["lane"][b, 24] = pos.numpy(), g
    st = st.replace(vehicles=st.vehicles.replace(**{k: jnp.asarray(a) for k, a in v.items()}))
    cleared_j = jax.jit(jax.vmap(ej._clear_vehicles))(st.vehicles)
    arrived_j = jax.jit(jax.vmap(lambda x: ej._has_arrived(x, 24)))(st)
    st_t = from_numpy_state(_numpy_state(st))
    cleared_t = et._clear_vehicles(st_t.vehicles)
    np.testing.assert_array_equal(cleared_t.kind.numpy(), np.asarray(cleared_j.kind))
    np.testing.assert_array_equal(et._has_arrived(st_t, 24).numpy(), np.asarray(arrived_j))
    dropped = (cleared_t.kind != st_t.vehicles.kind)[:, :4]
    assert bool(dropped.any()) and not bool(dropped.all())
    arrived = et._has_arrived(st_t, 24)
    assert bool(arrived.any()) and not bool(arrived.all())


def _ending(states, et, case):
    """Rows 0, 2, 4 and 6 end this step: a crashed ego, or one policy step
    left before ``duration``."""
    ending = np.arange(B) % 2 == 0
    if case == "crashed_ego":
        crashed = np.array(states.vehicles.crashed)
        crashed[ending, 24] = True
        return states.replace(vehicles=states.vehicles.replace(crashed=jnp.asarray(crashed)))
    time = np.array(states.time)
    time[ending] = et.config["duration"] - 1.0 / et.config["policy_frequency"]
    return states.replace(time=jnp.asarray(time))


@pytest.mark.parametrize("case", ["crashed_ego", "near_duration"])
def test_step_autoreset_batched_matches_jax(case):
    s = _setup()
    et = s["et"]
    sj = _ending(_rows(s["states"], B), et, case)
    st = from_numpy_state(_numpy_state(sj))
    acts = np.random.default_rng(12).integers(0, et.action_type.n, B).astype(np.int32)

    obs_j, st_j, rew_j, term_j, trunc_j, info_j = s["step"](sj, jnp.asarray(acts))
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
    _close(info_t["speed"], info_j["speed"], HEAD_ATOL, "info speed")
    np.testing.assert_array_equal(info_t["crashed"].numpy(), np.asarray(info_j["crashed"]))
    assert set(info_t["rewards"]) == set(info_j["rewards"])
    for name, value in info_t["rewards"].items():
        _close(value, info_j["rewards"][name], HEAD_ATOL, f"info rewards {name}")
    for a, b in zip(info_t["agents_rewards"], info_j["agents_rewards"], strict=True):
        _close(a, b, HEAD_ATOL, "agents_rewards")
    for a, b in zip(info_t["agents_terminated"], info_j["agents_terminated"], strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    keep = ~done
    _close(obs_t.numpy()[keep], np.asarray(obs_j)[keep], HEAD_ATOL, "obs")
    np.testing.assert_array_equal(st_t.steps.numpy()[keep], np.asarray(st_j.steps)[keep])
    np.testing.assert_array_equal(st_t.time.numpy()[keep], np.asarray(st_j.time)[keep])
    for name in STATE_DISCRETE:
        np.testing.assert_array_equal(getattr(st_t.vehicles, name).numpy()[keep],
                                      np.asarray(getattr(st_j.vehicles, name))[keep],
                                      err_msg=name)
    for name in STATE_CONTINUOUS:
        b = np.asarray(getattr(st_j.vehicles, name))[keep]
        tol = STEP_ATOL.get(name, 1e-4 * max(1.0, float(np.abs(b).max())))
        _close(getattr(st_t.vehicles, name).numpy()[keep], b, tol, name)

    # done rows: the port's own reset from the generator after the hook's
    # draws (one spawn attempt per env)
    et.spawn_draws((B,), gen_clone)
    obs_r, st_r = et._reset(B, gen_clone)
    np.testing.assert_array_equal(obs_t.numpy()[done], obs_r.numpy()[done])
    np.testing.assert_array_equal(st_t.steps.numpy()[done], 45)
    for f in dataclasses.fields(VehicleState):
        np.testing.assert_array_equal(getattr(st_t.vehicles, f.name).numpy()[done],
                                      getattr(st_r.vehicles, f.name).numpy()[done],
                                      err_msg=f.name)


def _ks(name, a, b):
    p = stats.ks_2samp(np.ravel(a), np.ravel(b)).pvalue
    assert p > 1e-3, f"{name}: KS p-value {p}"


def test_reset_invariants_and_distribution_match_jax():
    s = _setup()
    et = s["et"]
    _, st = et.reset(N_RESET, et.generator(1))
    vt = st.vehicles
    vj = from_numpy_state(_numpy_state(s["states"])).vehicles
    assert (st.steps == 45).all() and (st.time == 0).all()
    rb, rn, rid, rlen = et._routes
    for v in (vt, vj):
        kind = v.kind.numpy()
        assert (kind[:, 24] == KIND_EGO).all()
        assert np.isin(kind[:, :10], [KIND_PAD, KIND_IDM]).all() and (kind[:, 10:24] == KIND_PAD).all()
        # the ego at 10 m/s, target 9 (index 2), on corner 0's incoming lane,
        # routed to o1
        assert (v.speed[:, 24] == 10.0).all() and (v.target_speed[:, 24] == 9.0).all()
        assert (v.speed_index[:, 24] == 2).all() and (v.lane[:, 24] == et._spawn_lane[0]).all()
        for field, table in (("route_base", rb), ("route_n", rn), ("route_id", rid)):
            assert (getattr(v, field)[:, 24] == table[0, 1]).all(), field
        assert (v.route_len[:, 24] == rlen[0, 1]).all()
        # no NPC within 20 m of the ego
        d = (v.pos - v.pos[:, 24:25]).norm(dim=-1)
        npc = (v.kind != KIND_PAD) & (v.kind != KIND_EGO)
        assert not bool((npc & (d < 20.0)).any())
    # the ego's station s = 60 + 5 (1 + N(0, 1)) on its lane, against that
    # law: JAX's 256 stations sit 2.6 standard errors above its mean
    s_t, lat = t_lane.local_coordinates(et.geo, vt.lane[:, 24], vt.pos[:, 24])
    assert float(lat.abs().max()) < 1e-3
    assert stats.kstest(s_t.numpy(), "norm", args=(65.0, 5.0)).pvalue > 1e-3
    # live NPCs per env, their speeds, their spawn corners and destinations
    npc_t = (vt.kind == KIND_IDM).numpy()
    npc_j = (vj.kind == KIND_IDM).numpy()
    _ks("live NPC count", npc_t.sum(1), npc_j.sum(1))
    # the challenger, placed unless an object is within 15 m and kept unless
    # within 20 m of the ego
    present = np.array([[n[:, 9].sum(), (~n[:, 9]).sum()] for n in (npc_t, npc_j)])
    assert stats.chi2_contingency(present).pvalue > 1e-3 and present[0, 0] > 0
    _ks("NPC speed", vt.speed.numpy()[npc_t], vj.speed.numpy()[npc_j])

    def corners(v, npc):
        first = v.route_base[..., 0].numpy()[npc]
        bases = et._routes[0][:, :, 0].amax(dim=1).numpy()  # corner i's first edge
        return np.argmax(first[:, None] == bases[None, :], axis=1)

    c_t, c_j = corners(vt, npc_t), corners(vj, npc_j)
    counts = np.stack([np.bincount(c, minlength=4) for c in (c_t, c_j)])
    assert stats.chi2_contingency(counts).pvalue > 1e-3
    _ks("NPC delta", vt.delta.numpy()[npc_t], vj.delta.numpy()[npc_j])


def test_registry_and_what_stays_unported():
    et = ht.make("intersection-v0", device="cpu")
    assert et.regulated and et._straight is None and et._general.period == 7
    # intersection-multi-agent-v1 (Gymnasium wraps it in MultiAgentWrapper,
    # tests/test_torch_gym_env.py): two egos, the v0 spec
    ma1 = ht.make("intersection-multi-agent-v1", device="cpu")
    assert ma1.ego_slots == (24, 25) and not ma1._general.connected
    # intersection-v1: the regulated road under a dynamical ContinuousAction
    v1 = ht.make("intersection-v1", device="cpu")
    assert v1.regulated and v1._general.period == 7 and v1._general.dynamical
    # -v2 and the multi-agent ids: the connected-lane search, two egos
    for env_id, connected, egos in (("intersection-v2", True, (24,)),
                                    ("intersection-multi-agent-v0", False, (24, 25)),
                                    ("intersection-multi-agent-v2", True, (24, 25))):
        env = ht.make(env_id, device="cpu")
        assert env.regulated and env._general.connected == connected, env_id
        assert env.ego_slots == egos and env._general.period == 7, env_id


def test_rollout_on_the_cpu_is_finite_and_launches_no_kernel():
    et = _setup()["et"]
    gen = et.generator(0)
    _, states = et.reset(4, gen)
    k4, k5 = general_frames.frames_general_kernel, general_frames.frames_regulated_kernel
    before = (k4.launches, k5.launches)
    states, metrics = rollout(et, states, 3, gen)
    assert (k4.launches, k5.launches) == before
    for name, value in metrics.items():
        assert value.shape == () and bool(torch.isfinite(value)), name
    assert bool(torch.isfinite(states.vehicles.pos).all())
    assert (states.steps >= 45).all()
