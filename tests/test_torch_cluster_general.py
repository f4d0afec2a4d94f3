"""Scenes over the wide general kernels' 128 slots on the CPU: the gate, the cluster routing.

The wide K4 / K5 hold an env in one block of 128 threads; the cluster ones
(``csrc/general_frames_cluster.cu``) hold one in a thread-block cluster of
ceil(V / 128) blocks, slot j owned by thread j % 128 of rank j / 128, up to
``MAX_SLOTS`` = 2048 (16 blocks, over the portable cluster size of 8).
``make`` now accepts the scenes users reach with ordinary settings that
it refused before: intersection-v0, -v1 and -v2 at ``policy_frequency`` 15
(V=207: a decision every frame, the simulator's rate), intersection-v0
with ``duration`` 60 as well (V=912), exit-v0 and racetrack-v0 with 150
vehicles (V=151).  On the CPU every instantiation
runs ``frames_general_plain``, which takes any V; here

  - exit-v0 with 150 vehicles and intersection-v0 at ``policy_frequency``
    15 (``spawn_probability`` 0, its NPCs moved up by 120 slots so that
    they straddle the first rank boundary) take 3 ``step_batched`` steps
    from a port reset batch against the JAX package's (its XLA frames: the
    JAX kernels' gate stops at 32 slots), each step from the JAX state of
    the step before: discrete fields equal, pos, speed and heading within
    5e-4, the other state within 1e-4 of its magnitude, obs and reward
    within 1e-5.  On the regulated road each step starts with the frame
    counters at the phase whose one frame is a right-of-way tick: with
    fewer frames a step than the tick period (7), the JAX package's
    traced-phase schedule runs its masked prologue unclipped by the step's
    frames (``highwayenv_tpu/envs/base.py:530-534``: ``j < i0`` alone), so
    a step of one frame runs ``i0`` frames there at every other phase,
    where the port runs the one frame of HighwayEnv;
  - each scene is made, its launch tables and parameter block built as a
    launch builds them, and the instantiation it routes to
    (``frames_kernel_for``) asserted: the cluster twin over 128 slots; one
    slot over ``MAX_SLOTS`` is refused; a CPU rollout launches no kernel;
  - the cluster kernels' own orders, modelled in plain torch as the kernel
    runs them: the pairs counted over the cluster's threads (each pair
    once), the neighbour walks rank after rank over each rank's own words
    (the tie rules across the 128-slot boundary), and the impact as the
    highest partner, an atomicMax of partner + 1, held to the plain
    version's ``behavior.neighbours`` and ``collision.handle_collisions``
    on vehicles copied across the boundary; and the same at 16 ranks
    (exit-v0 with 2047 vehicles, V=2048), vehicles copied to the first
    slots of every rank.
"""

import dataclasses
import math

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
from highwayenv_tpu_torch.envs.base import map_fields
from highwayenv_tpu_torch.ops import collision, general_frames
from highwayenv_tpu_torch.parallel.rollout import random_actions, rollout
from highwayenv_tpu_torch.road import lane as lane_ops
from highwayenv_tpu_torch.utils.math import rects_intersecting_xy_folded
from highwayenv_tpu_torch.vehicle import behavior
from highwayenv_tpu_torch.vehicle.state import KIND_OBSTACLE, VehicleState

torch.set_num_threads(1)

B = 8
STEPS = 3
RANK_SLOTS = 128  # slots a cluster rank owns (the kernel's GEN_WIDE_SLOTS)
RANK_WORDS = RANK_SLOTS // 32
DISCRETE = ("lane", "target_lane", "route_ptr", "crashed", "hit", "impact_pending",
            "speed_index", "kind", "is_yielding", "yield_timer")
CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer", "impact", "steering",
              "accel")
STEP_ATOL = {"pos": 5e-4, "speed": 5e-4, "heading": 5e-4}
HEAD_ATOL = 1e-5
DYNAMICAL = {"action": {"type": "ContinuousAction", "dynamical": True}}
PF15 = {"policy_frequency": 15}

#: (env id, config, NPC shift): the scenes stepped against the JAX package
STEP_SCENES = [("exit-v0", {"vehicles_count": 150}, 0),
               ("intersection-v0", {**PF15, "spawn_probability": 0.0}, 120)]

#: (env id, config, V, the wrapper the scene routes to)
SCENES = [
    ("intersection-v0", PF15, 207, "frames_regulated_cluster_kernel"),
    ("intersection-v1", PF15, 207, "frames_regulated_dynamical_cluster_kernel"),
    ("intersection-v2", PF15, 207, "frames_regulated_connected_cluster_kernel"),
    ("intersection-v0", {"duration": 60, **PF15}, 912, "frames_regulated_cluster_kernel"),
    ("intersection-v0", {"policy_frequency": 10}, 142, "frames_regulated_cluster_kernel"),
    ("exit-v0", {"vehicles_count": 150}, 151, "frames_general_cluster_kernel"),
    ("exit-v1", {"vehicles_count": 150}, 151, "frames_general_connected_cluster_kernel"),
    ("racetrack-v0", {"other_vehicles": 150}, 151, "frames_general_cluster_kernel"),
    ("racetrack-v0", {"other_vehicles": 150, **DYNAMICAL}, 151,
     "frames_general_dynamical_cluster_kernel"),
    ("exit-v0", {"vehicles_count": 1023}, 1024, "frames_general_cluster_kernel"),
    ("exit-v0", {"vehicles_count": 127}, 128, "frames_general_wide_kernel"),
]
SCENE_IDS = [f"{e}-{'-'.join(f'{k}{v}' for k, v in c.items() if k != 'action')}"
             + ("-dynamical" if "action" in c else "") for e, c, *_ in SCENES]


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


def _shift_npcs(states, n_npc: int, shift: int):
    """``states`` with NPC slot k moved to slot (k + shift) % n_npc; the
    slots past the NPCs (the ego) stay."""
    V = states.vehicles.kind.shape[1]
    order = torch.cat([(torch.arange(n_npc) - shift) % n_npc, torch.arange(n_npc, V)])
    return states.replace(vehicles=map_fields(lambda t: t[:, order], states.vehicles))


def _close(a, b, atol, where):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=atol, err_msg=where)


@pytest.mark.parametrize("env_id,config,shift", STEP_SCENES, ids=[e for e, _, _ in STEP_SCENES])
def test_steps_over_the_wide_limits_match_jax(env_id, config, shift):
    ej, et = hj.make(env_id, config), ht.make(env_id, config, device="cpu")
    assert ej.num_slots == et.num_slots > general_frames.WIDE_SLOTS
    assert general_frames.frames_kernel_for(et._general, et.regulated, et.num_slots).cluster
    step_j = jax.jit(ej.step_batched)
    gen = et.generator(5)
    _, st = et.reset(B, gen)
    if shift:
        st = _shift_npcs(st, ej._n_npc, shift)
    sj = _jax_state(st, 5)
    for step in range(STEPS):
        if et.regulated:  # the one frame of the step a tick, on both sides
            period = et._general.period
            assert et.frames_per_step == 1 < period
            st = st.replace(steps=st.steps + (period - 1 - st.steps % period))
            sj = sj.replace(steps=jnp.asarray(st.steps.numpy()))
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
            tol = STEP_ATOL.get(name, 1e-4 * max(1.0, float(np.abs(b).max())))
            _close(getattr(vt, name).numpy(), b, tol, f"{where} {name}")
        st = _port_state(sj)  # the next step from the JAX state
    # live vehicles on both sides of the first rank boundary
    live = (st.vehicles.kind != 0).numpy()
    assert live[:, :RANK_SLOTS].any(axis=1).all() and live[:, RANK_SLOTS:].any(axis=1).all()


def _launch_tables(env):
    """What a launch of env's frame kernel builds from the env: the lane
    tables, the candidate tables (connected) and the parameter block."""
    _, st = env.reset(2, env.generator(0))
    veh = st.vehicles
    assert veh.route_base.shape[-1] == env.route_slots
    lanes_f, lanes_i = general_frames.lane_tables(env.geo, env.device)
    assert lanes_f.shape[0] == lanes_i.shape[0] == env.geo.num_lanes
    if env._general.connected:
        general_frames.conn_tables(env.geo, env.device)
    return veh, general_frames.kernel_params(
        env._general, env.num_slots, env.route_slots, env.frames_per_step,
        raw=env.action_type.stores_raw_controls, linear=env.linear_rows)


@pytest.mark.parametrize("env_id,config,V,wrapper", SCENES, ids=SCENE_IDS)
def test_scene_makes_and_routes_to_its_cluster_instantiation(env_id, config, V, wrapper):
    env = ht.make(env_id, config, device="cpu")
    assert env.num_slots == V
    veh, params = _launch_tables(env)
    assert veh.kind.shape[1] == params.V == V and params.L == env.geo.num_lanes
    kernel = general_frames.frames_kernel_for(env._general, env.regulated, V)
    assert kernel is getattr(general_frames, wrapper)
    cluster = V > general_frames.WIDE_SLOTS
    assert kernel.cluster == cluster and kernel.wide == (not cluster)
    assert kernel.source == ("general_frames_cluster" if cluster else "general_frames_wide")
    assert kernel.max_slots >= V
    if env.regulated:
        # the reset's warm-up keeps 16 slots: the narrow K5 of the same law
        warm = general_frames.frames_kernel_for(env._general, True, env._warmup_slots)
        assert env._warmup_slots == 16
        assert not (warm.wide or warm.cluster) and warm.entry == kernel.entry


def test_one_slot_over_the_cluster_limit_is_refused():
    """The cluster kernels hold 2048 slots; one slot more takes the global
    layout, and one slot past its 8192 is refused at ``make``."""
    limit = general_frames.MAX_SLOTS
    assert limit == 2048
    at = ht.make("exit-v0", {"vehicles_count": limit - 1}, device="cpu")
    over = ht.make("exit-v0", {"vehicles_count": limit}, device="cpu")
    assert general_frames.frames_kernel_for(at._general, False, at.num_slots).cluster
    assert general_frames.frames_kernel_for(over._general, False, over.num_slots).glob
    cap = general_frames.GLOBAL_SLOTS
    with pytest.raises(NotImplementedError, match=f"{cap + 1} slots > {cap}.*not ported"):
        ht.make("exit-v0", {"vehicles_count": cap}, device="cpu")


def test_cluster_wrappers_run_the_plain_frames_on_the_cpu():
    """Every cluster wrapper runs ``frames_general_plain`` on CPU tensors and
    counts no launch, and so does a rollout through them."""
    env = ht.make("exit-v0", {"vehicles_count": 150}, device="cpu")
    gen = env.generator(1)
    _, st = env.reset(2, gen)
    sa = env._action_to_slots(random_actions(env, 2, gen))
    want = general_frames.frames_general_plain(st.vehicles, env._general, sa,
                                               env.frames_per_step)
    kernel = general_frames.frames_general_cluster_kernel
    before = kernel.launches
    got = kernel(st.vehicles, env._general, sa, env.frames_per_step)
    assert kernel.launches == before
    for f in dataclasses.fields(VehicleState):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name
    clusters = [getattr(general_frames, n) for n in dir(general_frames)
                if n.endswith("_cluster_kernel")]
    assert len(clusters) == 8 and len({k.entry for k in clusters}) == 8
    assert all(k.cluster and not k.wide and k.source == "general_frames_cluster"
               and k.max_slots == general_frames.MAX_SLOTS for k in clusters)
    before = [k.launches for k in clusters]
    _, metrics = rollout(env, st, 2, gen)
    assert [k.launches for k in clusters] == before
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


# --------------------------------------------------------------------------- #
# the cluster kernels' orders, modelled in plain torch
# --------------------------------------------------------------------------- #


def _counted_pairs(V: int, t: int, T: int) -> list:
    """The kernel's ``for_pairs_counted``: the pairs a < b of V slots that
    thread t of T takes, the k-th pair in (a, b) order on thread k % T."""
    out, a, b = [], 0, t + 1
    while a < V - 1:
        if b < V:
            out.append((a, b))
            b += T
        else:
            a += 1
            b += a + 1 - V
    return out


@pytest.mark.parametrize("V", [129, 151, 207, 256, 912, 1024, 1025, 1212, 2048])
def test_counted_pairs_take_each_pair_once(V):
    T = -(-V // RANK_SLOTS) * RANK_SLOTS  # the cluster's threads
    seen = np.zeros((V, V), dtype=np.int64)
    for t in range(T):
        pairs = np.asarray(_counted_pairs(V, t, T), dtype=np.int64).reshape(-1, 2)
        np.add.at(seen, (pairs[:, 0], pairs[:, 1]), 1)
        # thread t's k-th pair is pair t + k T of the (a, b) order
        a, b = pairs[:, 0], pairs[:, 1]
        index = a * (2 * V - a - 1) // 2 + (b - a - 1)
        assert np.array_equal(index, t + T * np.arange(len(pairs)))
    assert np.array_equal(seen, np.triu(np.ones((V, V), dtype=np.int64), 1))


def _twins(env, n: int = 23, every_rank: bool = False, rows: int = 4):
    """A reset batch of ``rows`` rows of ``env`` with slots 1 .. n copied
    whole into slots 128 .. 127 + n (chip_smoke.py's tied scene): twins at
    the same s on the same lane, one on each side of the first rank
    boundary; with ``every_rank`` into the first n slots of every rank past
    the first, so that the copies meet across every boundary."""
    _, st = env.reset(rows, env.generator(3))
    V = env.num_slots
    starts = range(RANK_SLOTS, V, RANK_SLOTS) if every_rank else (RANK_SLOTS,)

    def copy(t):
        t = t.clone()
        for lo in starts:
            t[:, lo:lo + n] = t[:, 1:1 + n]
        return t

    return map_fields(copy, st.vehicles)


def _rank_walk_neighbours(query, table_s, elig):
    """The cluster kernel's search: for each slot i and its query lane, rank
    after rank (rank 0 first), each rank's own RANK_WORDS words of the
    lane's eligibility mask word after word and each word's bits ascending,
    i's own bit cleared in its owner's word; the dense loop's comparisons.
    query (B, V) lanes; returns (front, rear), -1 = none."""
    Bn, L, V = table_s.shape
    q = query.clamp(0, L - 1).long()
    s_q = torch.gather(table_s, 1, q[..., None].expand(Bn, V, V))  # [b, i, j]
    on_q = torch.gather(elig, 1, q[..., None].expand(Bn, V, V))
    on_q = on_q & ~torch.eye(V, dtype=torch.bool)
    s_self = torch.diagonal(s_q, dim1=-2, dim2=-1)
    f_key = torch.full((Bn, V), math.inf)
    r_key = torch.full((Bn, V), -math.inf)
    front = torch.full((Bn, V), -1, dtype=torch.int64)
    rear = torch.full((Bn, V), -1, dtype=torch.int64)
    for rank in range(-(-V // RANK_SLOTS)):
        for w in range(RANK_WORDS):
            for bit in range(32):
                j = rank * RANK_SLOTS + 32 * w + bit
                if j >= V:
                    continue
                on, sc = on_q[..., j], s_q[..., j]
                take_f = on & (s_self <= sc) & (sc <= f_key)
                take_r = on & (sc < s_self) & (sc > r_key)
                f_key = torch.where(take_f, sc, f_key)
                front = torch.where(take_f, j, front)
                r_key = torch.where(take_r, sc, r_key)
                rear = torch.where(take_r, j, rear)
    return front, rear


def test_rank_walks_keep_the_tie_rules_across_the_boundary():
    env = ht.make("exit-v0", {"vehicles_count": 150}, device="cpu")
    veh = _twins(env)
    s, lat = lane_ops.projection_table(env.geo, veh.pos)
    elig = behavior.eligible_on_lane(env.geo, veh, s, lat)
    want_f, want_r = behavior.neighbours(veh, veh.lane, s, elig)
    got_f, got_r = _rank_walk_neighbours(veh.lane, s, elig)
    assert torch.equal(got_f, want_f.to(torch.int64))
    assert torch.equal(got_r, want_r.to(torch.int64))
    # a twin below the boundary takes its twin above as its front: the
    # later slot of a tie at its own s
    twins = torch.arange(1, 24)
    assert bool((got_f[:, twins] == twins + RANK_SLOTS - 1).any())


def _max_partner_collisions(state, dt: float, seed: int):
    """The cluster kernel's collision pass: each pair of handle_collisions'
    (lower, upper) rows evaluated once, in a shuffled order; crash and hit
    set as slot flags (the owner's words), each slot's impact partner the
    highest, an atomicMax of partner + 1, its translation taken again from
    the pair's SAT."""
    Bn, V = state.kind.shape
    px, py = state.pos[..., 0], state.pos[..., 1]
    velx = state.speed * torch.cos(state.heading)
    vely = state.speed * torch.sin(state.heading)

    def rows(x):
        return x[..., :, None]

    def cols(x):
        return x[..., None, :]

    inter, will, tx, ty = rects_intersecting_xy_folded(
        rows(px), rows(py), rows(state.length), rows(state.width), rows(state.heading),
        cols(px), cols(py), cols(state.length), cols(state.width), cols(state.heading),
        relx=(rows(velx) - cols(velx)) * dt, rely=(rows(vely) - cols(vely)) * dt,
    )
    diag = state.diagonal
    solid, obst = state.solid, state.kind == KIND_OBSTACLE
    ok_all = (cols(state.active) & rows(state.active)
              & (rows(state.is_vehicle) | cols(state.is_vehicle))
              & (rows(state.check_collisions) | cols(state.check_collisions))
              & rows(state.collidable) & cols(state.collidable))
    crashed, hit = state.crashed.clone(), state.hit.clone()
    partner = torch.zeros((Bn, V), dtype=torch.int64)  # partner + 1, 0 = none
    # the pairs eligible and within reach in some row: every other pair
    # leaves every flag and partner as it is, wherever it falls in the order
    dx_all = px[:, :, None] - px[:, None, :]
    dy_all = py[:, :, None] - py[:, None, :]
    reach_all = (diag[:, :, None] + diag[:, None, :]) / 2 + state.speed[:, :, None] * dt
    near = ok_all & (dx_all * dx_all + dy_all * dy_all <= reach_all * reach_all)
    pairs = torch.nonzero(torch.triu(near.any(0), 1)).tolist()
    for k in np.random.default_rng(seed).permutation(len(pairs)):
        a, b = pairs[k]
        dx, dy = px[:, a] - px[:, b], py[:, a] - py[:, b]
        reach = (diag[:, a] + diag[:, b]) / 2 + state.speed[:, a] * dt
        ok = ok_all[:, a, b] & (dx * dx + dy * dy <= reach * reach)
        i_ab, w_ab = inter[:, a, b] & ok, will[:, a, b] & ok
        both = solid[:, a] & solid[:, b]
        crashed[:, a] |= i_ab & both
        crashed[:, b] |= i_ab & both
        hit[:, a] |= i_ab & ~both & ~solid[:, a]
        hit[:, b] |= i_ab & ~both & ~solid[:, b]
        partner[:, a] = torch.where(w_ab & both & ~obst[:, a],
                                    torch.clamp(partner[:, a], min=b + 1), partner[:, a])
        partner[:, b] = torch.where(w_ab & both & ~obst[:, b],
                                    torch.clamp(partner[:, b], min=a + 1), partner[:, b])
    slots = torch.arange(V)
    j = (partner - 1).clamp(min=0)
    lo, hi = torch.minimum(slots, j), torch.maximum(slots, j)
    t_x = torch.gather(tx.flatten(1), 1, lo * V + hi)
    t_y = torch.gather(ty.flatten(1), 1, lo * V + hi)
    coef = torch.where(torch.gather(obst, 1, j), 1.0, torch.where(j > slots, 0.5, -0.5))
    has = partner > 0
    impact = torch.stack([torch.where(has, coef * t_x, state.impact[..., 0]),
                          torch.where(has, coef * t_y, state.impact[..., 1])], dim=-1)
    return state.replace(crashed=crashed, hit=hit, impact=impact,
                         impact_pending=state.impact_pending | has), has


def test_highest_partner_impacts_match_handle_collisions_across_the_boundary():
    env = ht.make("exit-v0", {"vehicles_count": 150}, device="cpu")
    veh = _twins(env)
    want = collision.handle_collisions(veh, env.dt)
    got, has = _max_partner_collisions(veh, env.dt, seed=7)
    for name in ("crashed", "hit", "impact_pending", "impact"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    # twins crash across the boundary, and some impacts cross it
    assert bool(want.crashed[:, RANK_SLOTS:].any()) and bool(has[:, :RANK_SLOTS].any())


def test_rank_walks_keep_the_tie_rules_across_sixteen_ranks():
    """The walks of a 16-block cluster (exit-v0 with 2047 vehicles,
    V=2048): slots 1 .. 23 copied to the first slots of every rank, so that
    up to 16 vehicles share an s on a lane, one a rank; the rank-after-rank
    walk keeps the dense loop's ties (the front the last slot, the rear the
    first)."""
    env = ht.make("exit-v0", {"vehicles_count": 2047}, device="cpu")
    assert -(-env.num_slots // RANK_SLOTS) == 16
    veh = _twins(env, every_rank=True, rows=1)
    s, lat = lane_ops.projection_table(env.geo, veh.pos)
    elig = behavior.eligible_on_lane(env.geo, veh, s, lat)
    want_f, want_r = behavior.neighbours(veh, veh.lane, s, elig)
    got_f, got_r = _rank_walk_neighbours(veh.lane, s, elig)
    assert torch.equal(got_f, want_f.to(torch.int64))
    assert torch.equal(got_r, want_r.to(torch.int64))
    # slot k and its copies on ranks 1 .. 14 take the last rank's copy as
    # their front: the last slot of the tie, 15 ranks up the walk
    twins = torch.arange(1, 24)
    last = 15 * RANK_SLOTS + twins - 1
    assert bool((got_f[:, twins] == last).any())
    for rank in range(1, 15):
        assert bool((got_f[:, rank * RANK_SLOTS + twins - 1] == last).any()), rank


def test_highest_partner_impacts_match_handle_collisions_across_sixteen_ranks():
    env = ht.make("exit-v0", {"vehicles_count": 2047}, device="cpu")
    veh = _twins(env, every_rank=True, rows=1)
    want = collision.handle_collisions(veh, env.dt)
    got, has = _max_partner_collisions(veh, env.dt, seed=9)
    for name in ("crashed", "hit", "impact_pending", "impact"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    # the copies crash on every rank, and their partners lie on other ranks
    ranks = torch.arange(env.num_slots) // RANK_SLOTS
    for rank in range(16):
        assert bool(want.crashed[:, ranks == rank].any()), rank
    assert bool(has[:, ranks == 15].any())
