"""merge-generic-v0 and roundabout-generic-v0 in the port against the JAX
package, on the CPU.

One ``step_autoreset_batched`` of the port from a JAX reset batch carried
across with the same actions: obs, reward, terminated, truncated, info and
the state of the rows that go on match the JAX step (the XLA general frame
on the CPU; ``step_batched``, whose kept rows are those of
``step_autoreset_batched``, so that the JAX reset is not compiled into the
step); the done rows equal the port's own ``_reset`` drawn from a clone of
the step's generator.  Tolerances: discrete fields exact, pos 2e-4 m,
other continuous state 1e-4 of its magnitude, obs and reward 1e-5.

The resets are rejection-sampled: each NPC takes the first of 10 tries
that keeps its clearance (15 m on its lane on merge-generic, 7 m from
every vehicle on roundabout-generic).  They are held to N_RESET JAX
resets (made eagerly: the unrolled tries compile for over a minute) by
their invariants, the share of placed NPCs and seeded two-sample tests of
what they draw, and the placement to a per-env replay of the tries in
plain Python from the port's own draws, on a crowded road where tries are
rejected.
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
from highwayenv_tpu_torch.envs import roundabout_generic
from highwayenv_tpu_torch.ops import general_frames
from highwayenv_tpu_torch.parallel.rollout import random_actions, rollout
from highwayenv_tpu_torch.vehicle.state import (
    KIND_EGO,
    KIND_IDM,
    KIND_OBSTACLE,
    KIND_PAD,
    VehicleState,
)

torch.set_num_threads(1)

B = 8
N_RESET = 256
GENERIC_IDS = ["merge-generic-v0", "roundabout-generic-v0"]
STATE_DISCRETE = ("lane", "target_lane", "crashed", "hit", "impact_pending",
                  "speed_index", "kind", "route_ptr")
STATE_CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer",
                    "impact", "steering", "accel")
HEAD_ATOL = 1e-5
CASES = {
    "merge-generic-v0": ("crashed_ego", "past_the_end"),
    "roundabout-generic-v0": ("crashed_ego", "near_duration"),
}
#: crowded roads on which tries are rejected
CROWDED = {
    "merge-generic-v0": {"vehicles_count": 16, "lanes_count": 1},
    "roundabout-generic-v0": {"vehicles_count": 24},
}

_SETUP: dict = {}


def _numpy_state(states) -> dict:
    return {
        "vehicles": {
            f.name: np.array(getattr(states.vehicles, f.name))
            for f in dataclasses.fields(VehicleState)
        },
        "time": np.array(states.time),
        "steps": np.array(states.steps),
    }


def _setup(env_id):
    """JAX env, port env, N_RESET JAX resets and the jitted JAX step, built
    once per env so the step compiles once per test process."""
    if env_id not in _SETUP:
        ej = hj.make(env_id)
        et = ht.make(env_id, device="cpu")
        _, states = jax.vmap(ej._reset)(jax.random.split(jax.random.PRNGKey(3), N_RESET))
        _SETUP[env_id] = (ej, et, states, jax.jit(ej.step_batched))
    return _SETUP[env_id]


def _ending(states, et, case):
    """Rows 0, 2, 4 and 6 end this step: a crashed ego, the ego 1 m short of
    merge's end line, or one policy step left before ``duration``."""
    ending = np.arange(B) % 2 == 0
    veh = states.vehicles
    if case == "crashed_ego":
        crashed = np.array(veh.crashed)
        crashed[ending, 0] = True
        return states.replace(vehicles=veh.replace(crashed=jnp.asarray(crashed)))
    if case == "past_the_end":
        pos = np.array(veh.pos)
        pos[ending, 0, 0] = et.end_position - 1.0
        return states.replace(vehicles=veh.replace(pos=jnp.asarray(pos)))
    time = np.array(states.time)
    time[ending] = et.config["duration"] - 1.0 / et.config["policy_frequency"]
    return states.replace(time=jnp.asarray(time))


def _close(a, b, atol, where):
    np.testing.assert_allclose(
        np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=0,
        atol=atol, err_msg=where,
    )


@pytest.mark.parametrize("env_id,case", [(e, c) for e in CASES for c in CASES[e]])
def test_step_autoreset_batched_matches_jax(env_id, case):
    ej, et, states, jstep = _setup(env_id)
    sj = _ending(jax.tree.map(lambda x: x[:B], states), et, case)
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

    obs_r, st_r = et._reset(B, gen_clone)
    np.testing.assert_array_equal(obs_t.numpy()[done], obs_r.numpy()[done])
    for f in dataclasses.fields(VehicleState):
        np.testing.assert_array_equal(
            getattr(st_t.vehicles, f.name).numpy()[done],
            getattr(st_r.vehicles, f.name).numpy()[done], err_msg=f.name,
        )


def _resets(env_id, seed_t=1):
    ej, et, states, _ = _setup(env_id)
    _, st = et.reset(N_RESET, et.generator(seed_t))
    return ej, et, st.vehicles, from_numpy_state(_numpy_state(states)).vehicles


def _ks(name, a, b):
    p = stats.ks_2samp(np.ravel(a), np.ravel(b)).pvalue
    assert p > 1e-3, f"{name}: KS p-value {p}"


def _same_share(name, placed_t, placed_j):
    """The shares of placed NPCs agree (Fisher's exact test)."""
    table = [[int(placed_t.sum()), int((~placed_t).sum())],
             [int(placed_j.sum()), int((~placed_j).sum())]]
    p = stats.fisher_exact(table).pvalue
    assert p > 1e-3, f"{name}: placed {table}, p-value {p}"


def _merge_clearance_holds(et, veh):
    """Every placed NPC keeps more than 15 m on its lane of ("a", "b") from
    the ego and from every NPC placed before it."""
    lanes, n = et.config["lanes_count"], et.config["vehicles_count"]
    kind = veh.kind.numpy()
    lane_id = veh.pos[..., 1].numpy() / 4.0
    s = veh.pos[..., 0].numpy()
    assert np.allclose(lane_id[:, 0], lanes - 1) and np.allclose(s[:, 0], 30.0)
    for i in range(1, 1 + n):
        for j in range(i):
            both = (kind[:, i] != KIND_PAD) & (kind[:, j] != KIND_PAD)
            same = both & (np.round(lane_id[:, i]) == np.round(lane_id[:, j]))
            assert (np.abs(s[:, i] - s[:, j])[same] > 15.0 - 1e-3).all(), (i, j)


def test_merge_generic_reset_invariants_and_distribution_match_jax():
    ej, et, vt, vj = _resets("merge-generic-v0")
    kind = vt.kind.numpy()
    assert et.num_slots == 6 and et.geo.num_lanes == 9 and et.max_edge_lanes == 3
    assert (kind[:, 0] == KIND_EGO).all() and (kind[:, 4] == KIND_IDM).all()
    assert (kind[:, 5] == KIND_OBSTACLE).all()
    assert np.isin(kind[:, 1:4], (KIND_IDM, KIND_PAD)).all()
    # the ego, the merging vehicle and the obstacle: as in JAX
    for slot in (0, 4, 5):
        for name in ("pos", "heading", "speed", "target_speed", "lane", "length",
                     "width", "kind"):
            np.testing.assert_array_equal(
                getattr(vt, name)[:, slot].numpy(), getattr(vj, name)[:, slot].numpy(),
                err_msg=f"slot {slot} {name}",
            )
    _merge_clearance_holds(et, vt)
    _merge_clearance_holds(et, vj)
    placed_t, placed_j = kind[:, 1:4] == KIND_IDM, vj.kind[:, 1:4].numpy() == KIND_IDM
    _same_share("merge-generic", placed_t, placed_j)
    # placed NPCs: stations U(0, 310), lanes uniform over ("a", "b"),
    # speeds 30 + U(-2, 2)
    s_t, s_j = vt.pos[:, 1:4, 0].numpy()[placed_t], vj.pos[:, 1:4, 0].numpy()[placed_j]
    assert s_t.min() >= 0.0 and s_t.max() <= 310.0
    _ks("npc station", s_t, s_j)
    v_t, v_j = vt.speed[:, 1:4].numpy()[placed_t], vj.speed[:, 1:4].numpy()[placed_j]
    assert v_t.min() >= 28.0 and v_t.max() <= 32.0
    _ks("npc speed", v_t, v_j)
    # the lane id from y (a station past x = 230 lies on ("b", "c"))
    lanes_t = np.round(vt.pos[:, 1:4, 1].numpy()[placed_t] / 4.0).astype(int)
    lanes_j = np.round(vj.pos[:, 1:4, 1].numpy()[placed_j] / 4.0).astype(int)
    counts = np.stack([np.bincount(x, minlength=2) for x in (lanes_t, lanes_j)])
    assert set(np.unique(lanes_t)) == {0, 1}
    assert stats.chi2_contingency(counts).pvalue > 1e-3


def _destinations(et, veh):
    """(N, NPCs) index of each NPC's destination in DESTINATIONS, read from
    the end node of its route's last segment (-1 where not placed)."""
    base, length = veh.route_base.numpy(), veh.route_len.numpy()
    out = np.full(length[:, 1:].shape, -1)
    for n, i in zip(*np.nonzero(veh.kind[:, 1:].numpy() == KIND_IDM)):
        last = base[n, 1 + i, length[n, 1 + i] - 1]
        out[n, i] = roundabout_generic.DESTINATIONS.index(
            et.net.lane_index_from_global(int(last))[1])
    return out


def _roundabout_clearance_holds(veh):
    """Every placed vehicle keeps 7 m from every other placed one."""
    pos, kind = veh.pos.numpy(), veh.kind.numpy()
    d = np.linalg.norm(pos[:, :, None] - pos[:, None], axis=-1)
    both = (kind[:, :, None] != KIND_PAD) & (kind[:, None] != KIND_PAD)
    both &= ~np.eye(kind.shape[1], dtype=bool)
    assert (d[both] >= 7.0 - 1e-3).all()


def test_roundabout_generic_reset_invariants_and_distribution_match_jax():
    ej, et, vt, vj = _resets("roundabout-generic-v0")
    assert et.num_slots == 6 and et.geo.num_lanes == 32 and et.route_slots == 11
    kind = vt.kind.numpy()
    assert (kind[:, 0] == KIND_EGO).all() and np.isin(kind[:, 1:], (KIND_IDM, KIND_PAD)).all()
    for name in ("pos", "heading", "speed", "target_speed", "speed_index", "lane",
                 "route_base", "route_n", "route_id", "route_len", "delta"):
        np.testing.assert_array_equal(
            getattr(vt, name)[:, 0].numpy(), getattr(vj, name)[:, 0].numpy(), err_msg=name
        )
    _roundabout_clearance_holds(vt)
    _roundabout_clearance_holds(vj)
    placed_t, placed_j = kind[:, 1:] == KIND_IDM, vj.kind[:, 1:].numpy() == KIND_IDM
    _same_share("roundabout-generic", placed_t, placed_j)
    # destinations uniform over the four exits, spawn edges uniform over 7
    d_t, d_j = _destinations(et, vt)[placed_t], _destinations(et, vj)[placed_j]
    counts = np.stack([np.bincount(d, minlength=4) for d in (d_t, d_j)])
    assert stats.chi2_contingency(counts).pvalue > 1e-3
    assert stats.chisquare(counts[0]).pvalue > 1e-3
    e_t = vt.route_base[:, 1:, 0].numpy()[placed_t]
    e_j = vj.route_base[:, 1:, 0].numpy()[placed_j]
    bases = np.unique(np.concatenate([e_t, e_j]))
    counts = np.stack([(x[:, None] == bases).sum(0) for x in (e_t, e_j)])
    assert len(bases) == 7 and stats.chi2_contingency(counts).pvalue > 1e-3
    _ks("npc speed", vt.speed[:, 1:].numpy()[placed_t], vj.speed[:, 1:].numpy()[placed_j])
    _ks("npc delta", vt.delta[:, 1:].numpy(), vj.delta[:, 1:].numpy())
    # routes and lanes: the empty route and the pad's lane where not placed
    assert (vt.route_len[:, 1:].numpy()[~placed_t] == 0).all()
    assert (vt.route_base[:, 1:].numpy()[~placed_t] == -1).all()


def test_incoming_vehicle_destination_is_honoured():
    et = ht.make("roundabout-generic-v0", {"incoming_vehicle_destination": 5},
                 device="cpu")
    _, st = et.reset(32, et.generator(0))
    d = _destinations(et, st.vehicles)
    placed = st.vehicles.kind[:, 1:].numpy() == KIND_IDM
    assert (d[placed] == 3).all()  # min(5, 3): "wxr"


def _replay_merge(et, draws, n):
    """Row ``n``'s placed (lane id, station) per NPC slot, the tries
    replayed one by one (reference merge_env.py ``_make_vehicles``)."""
    placed = [(et.config["lanes_count"] - 1, 30.0)]
    out = []
    for i in range(et.config["vehicles_count"]):
        got = None
        for t in range(10):
            lane, s = int(draws["lane"][n, i, t]), float(draws["s"][n, i, t])
            if all(not (pl == lane and abs(ps - s) <= 15.0) for pl, ps in placed):
                got = (lane, s)
                break
        if got is not None:
            placed.append(got)
        out.append(got)
    return out


def _replay_roundabout(et, draws, n, ego_pos):
    """Row ``n``'s chosen (edge, lane id) per NPC slot, the tries replayed
    one by one on the host lanes (reference roundabout_env.py
    ``RoundaboutEnvGeneric._make_vehicles``)."""
    placed = [np.asarray(ego_pos, np.float64)]
    out = []
    for i in range(et.config["vehicles_count"]):
        got = None
        for t in range(10):
            e = int(draws["edge"][n, i, t])
            f, to = roundabout_generic.SPAWN_EDGES[e]
            lid = int(draws["lane"][n, i, t]) % len(et.net.lanes_on_edge(f, to))
            lane = et.net.get_lane((f, to, lid))
            hi = max(5.0, lane.length - 5.0)
            s = max(5.0, float(draws["s"][n, i, t]) * (hi - 5.0) + 5.0)
            p = lane.position(s, 0.0)
            if all(np.linalg.norm(p - q) >= 7.0 + 1e-3 for q in placed):
                got = (e, lid)
                break
            if not all(np.linalg.norm(p - q) >= 7.0 - 1e-3 for q in placed):
                continue
            return None  # a distance within rounding of 7 m: undecided
        if got is not None:
            placed.append(p)
        out.append(got)
    return out


@pytest.mark.parametrize("env_id", GENERIC_IDS)
def test_crowded_placement_replays_the_tries(env_id):
    """On a crowded road tries are rejected and some NPCs stay unplaced;
    each row's placement is the first clear try of each NPC, replayed in
    plain Python from the same draws."""
    et = ht.make(env_id, CROWDED[env_id], device="cpu")
    draws = et._reset_draws(64, et.generator(0))
    veh = et._place_vehicles(draws)
    kind = veh.kind.numpy()
    n_npc = et.config["vehicles_count"]
    placed = kind[:, 1 : 1 + n_npc] == KIND_IDM
    assert 0.05 < 1.0 - placed.mean() < 0.95, placed.mean()
    checked = 0
    for n in range(64):
        if env_id == "merge-generic-v0":
            got = _replay_merge(et, draws, n)
            for i, g in enumerate(got):
                assert (g is not None) == placed[n, i], (n, i)
                if g is not None:
                    assert float(veh.pos[n, 1 + i, 0]) == pytest.approx(g[1], abs=1e-4)
                    assert round(float(veh.pos[n, 1 + i, 1]) / 4.0) == g[0]
            _merge_clearance_holds(et, veh)
        else:
            got = _replay_roundabout(et, draws, n, veh.pos[n, 0].numpy())
            if got is None:
                continue
            for i, g in enumerate(got):
                assert (g is not None) == placed[n, i], (n, i)
                if g is not None:
                    edge = roundabout_generic.SPAWN_EDGES[g[0]]
                    first = int(veh.route_base[n, 1 + i, 0])
                    assert et.net.lane_index_from_global(first)[:2] == edge
            _roundabout_clearance_holds(veh)
        checked += 1
    assert checked > 48


@pytest.mark.parametrize("env_id", GENERIC_IDS)
def test_compact_autoreset_and_rollout(env_id):
    et = ht.make(env_id, device="cpu")
    _, states = et.reset(6, et.generator(0))
    crashed = states.vehicles.crashed.clone()
    crashed[::2, 0] = True
    states = states.replace(vehicles=states.vehicles.replace(crashed=crashed))
    acts = torch.arange(6, dtype=torch.int32) % et.action_type.n
    g_full, g_compact = et.generator(7), et.generator(7)
    full = et.step_autoreset_batched(states, acts, g_full)
    compact = et.step_autoreset_batched(states, acts, g_compact, reset_slots=2)
    torch.testing.assert_close(compact[0], full[0], rtol=0, atol=0)
    for f in dataclasses.fields(VehicleState):
        torch.testing.assert_close(getattr(compact[1].vehicles, f.name),
                                   getattr(full[1].vehicles, f.name), rtol=0, atol=0)
    assert torch.equal(g_full.get_state(), g_compact.get_state())

    gen = et.generator(1)
    _, states = et.reset(4, gen)
    before = general_frames.frames_general_kernel.launches
    states, metrics = rollout(et, states, 3, gen)
    assert general_frames.frames_general_kernel.launches == before
    for name, value in metrics.items():
        assert value.shape == () and bool(torch.isfinite(value)), name
    assert bool(torch.isfinite(states.vehicles.pos).all())


@pytest.mark.parametrize(
    "env_id", ["merge-generic-v1", "roundabout-generic-v1", "u-turn-v1", "exit-v1"]
)
def test_v1_ids_name_the_connected_lane_search(env_id):
    """The -v1 forms of this slice's envs are the -v0 envs with the
    connected-lane neighbour search in their general spec; one CPU step of
    each runs the plain frames (tests/test_torch_connected.py holds them to
    the JAX package)."""
    env = ht.make(env_id, device="cpu")
    assert env.config["neighbour_vehicles_connected_lanes"] and env._general.connected
    assert type(env) is type(ht.make(env_id.replace("-v1", "-v0"), device="cpu"))
    gen = env.generator(0)
    _, st = env.reset(2, gen)
    obs, st, reward, *_ = env.step_autoreset_batched(st, random_actions(env, 2, gen), gen)
    assert bool(torch.isfinite(obs).all()) and bool(torch.isfinite(reward).all())
