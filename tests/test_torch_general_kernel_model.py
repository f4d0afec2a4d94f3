"""The general frame kernels' search and merge orders, modelled in plain torch.

``csrc/general_frames.cu`` (K4, K5) spreads a frame over more threads than
slots and merges their results through shared memory with integer
operations whose outcome does not depend on the order of arrival.  These
tests model each of those reductions in plain torch, as the kernel runs it,
and hold the model to the plain version the kernel is held to on the card
(``frames_general_plain``'s pieces: ``lane.closest_lane_from_table``,
``behavior.neighbours``, ``collision.handle_collisions``,
``regulation.enforce_road_rules``), at V = 5 (roundabout-v0), 6 (merge-v0),
16, 25 and 32 (intersection-v0 with ``duration`` 4, 13 and 20), and for the
wide kernels (one env a block, every slot mask W = ceil(V / 32) words, slot
s at bit s % 32 of word s / 32) at V = 33, 42, 51 and 128 (``duration`` 21,
30, 39 and 116), B = 4:

  (a) the closest lane as the minimum of a packed key over the lanes (the
      order of the distance, -0 as +0, then the lane index; NaN on lane 0
      keeps lane 0, a later NaN never wins): the first minimum of the lane
      loop, on tables with ties, -0.0, NaN and infinities;
  (b) the neighbour searches as walks of a per-lane bitmask of eligible
      slots, word after word and each word's bits in ascending order, with
      the dense loop's comparisons: front = smallest s >= own, the last
      slot among ties; rear = largest s < own, the first among ties;
  (c) the collision pass with each pair evaluated once, crash and hit
      flags merged as slot bits into their words, the impact from the
      highest partner bit, scanned from the top word down;
  (d) the right-of-way pass with each pair of vehicles evaluated once and
      the yielder's bit merged, at equal and unequal priority;
  (e) the connected-lane search (``kConnected``) as a walk of the query
      lane's candidate lanes in column order, each slot taken on the first
      candidate whose eligibility bit it has (the bits seen masked off),
      its key its s there plus the candidate's offset, the keys merged in a
      shuffled order with the explicit tie rules (front: the highest slot
      among equal keys, rear: the lowest), held to the plain
      ``behavior.neighbours_connected`` at V = 5, 6, 21 and 26
      (roundabout-v1, merge-v1, exit-v1, intersection-multi-agent-v2), and
      with the seen mask in words at V = 42 and 51 (intersection-v2 with
      duration 30, exit-v1 with 50 vehicles).

The pairs are merged in a shuffled order: the result must not depend on it.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import highwayenv_tpu_torch as ht
from highwayenv_tpu_torch.ops import collision
from highwayenv_tpu_torch.road import lane as lane_ops
from highwayenv_tpu_torch.road import regulation
from highwayenv_tpu_torch.utils.math import rects_intersecting_xy_folded
from highwayenv_tpu_torch.vehicle import behavior
from highwayenv_tpu_torch.vehicle.state import KIND_IDM, KIND_LINEAR, KIND_OBSTACLE

torch.set_num_threads(1)

B = 4
SIZES = (5, 6, 16, 25, 32, 33, 42, 51, 128)


def _n_words(V: int) -> int:
    """Words of a slot mask: 1 in the narrow kernels (V <= 32), V / 32
    rounded up in the wide ones."""
    return -(-V // 32)


def _to_words(flags: torch.Tensor) -> torch.Tensor:
    """A (..., V) bool of slots as the kernels' (..., W) words of 32 bits
    (int64 holding each word's unsigned value): slot s at bit s % 32 of
    word s / 32."""
    V = flags.shape[-1]
    W = _n_words(V)
    pad = torch.zeros(flags.shape[:-1] + (32 * W - V,), dtype=torch.bool)
    bits = torch.cat([flags, pad], dim=-1).reshape(flags.shape[:-1] + (W, 32))
    return (bits.to(torch.int64) << torch.arange(32)).sum(dim=-1)


def _slot_bit(s: int) -> tuple[int, int]:
    """(word, bit value) of slot s in a mask."""
    return s // 32, 1 << (s % 32)


def _has(words: torch.Tensor, s: int) -> torch.Tensor:
    """Whether slot s is set in the (..., W) words."""
    w, bit = _slot_bit(s)
    return (words[..., w] & bit) != 0


def _env(V: int):
    """An env with V slots: roundabout-v0 (5), merge-v0 (6) or
    intersection-v0 with duration V - 12 (16, 25, 32, 33, 42, 51, 128)."""
    if V == 5:
        return ht.make("roundabout-v0", device="cpu")
    if V == 6:
        return ht.make("merge-v0", device="cpu")
    return ht.make("intersection-v0", {"duration": V - 12}, device="cpu")


def _reset(V: int):
    env = _env(V)
    assert env.num_slots == V
    _, states = env.reset(B, env.generator(V))
    return env, states.vehicles


def _pile_up(veh, step: float = 1.5):
    """Every vehicle of an env in a row ``step`` apart along slot 0's
    heading: collisions in every env."""
    V = veh.kind.shape[1]
    h = veh.heading[:, 0]
    u = torch.stack([torch.cos(h), torch.sin(h)], dim=-1)
    k = torch.arange(V, dtype=torch.float32)
    row = veh.pos[:, :1] + step * k[None, :, None] * u[:, None, :]
    is_veh = veh.is_vehicle
    return veh.replace(
        pos=torch.where(is_veh[..., None], row, veh.pos),
        heading=torch.where(is_veh, h[:, None], veh.heading),
    )


def _shuffled_pairs(V: int, seed: int):
    pairs = [(a, b) for a in range(V) for b in range(a + 1, V)]
    order = np.random.default_rng(seed).permutation(len(pairs))
    return [pairs[k] for k in order]


# --------------------------------------------------------------------------- #
# (a) the closest lane: the minimum of a packed key
# --------------------------------------------------------------------------- #


def _float_order(x: torch.Tensor) -> torch.Tensor:
    """The kernel's order of a float32 as an int64 in [0, 2^32): -0 as +0,
    monotonic in the value for non-NaN x."""
    b = (x + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = (b & 0x80000000) != 0
    return torch.where(neg, (~b) & 0xFFFFFFFF, b | 0x80000000)


def _key_min(dl: torch.Tensor) -> torch.Tensor:
    """``lane_key`` of every entry of a (..., L, V) table of distances, (order
    << 32 | lane) shifted into int64's range with NaN on lane 0 the smallest
    key and on a later lane the largest, and the atomicMin of each slot's
    keys, whatever their order: the lane is the minimum's low word."""
    L = dl.shape[-2]
    lanes = torch.arange(L, dtype=torch.int64)[:, None].expand(dl.shape)
    key = (_float_order(dl) - 2**31) * 2**32 + lanes
    nan = torch.isnan(dl)
    key = torch.where(nan & (lanes == 0), torch.iinfo(torch.int64).min, key)
    key = torch.where(nan & (lanes > 0), torch.iinfo(torch.int64).max, key)
    return key.amin(dim=-2) & 0xFFFFFFFF


def _serial_first_minimum(dl: torch.Tensor) -> torch.Tensor:
    """The lane loop ``if (l == 0 || dl < best)`` over a (..., L, V) table."""
    best = dl[..., 0, :]
    best_l = torch.zeros(best.shape, dtype=torch.int64)
    for l in range(1, dl.shape[-2]):
        take = dl[..., l, :] < best
        best = torch.where(take, dl[..., l, :], best)
        best_l = torch.where(take, l, best_l)
    return best_l


@pytest.mark.parametrize("V", SIZES)
def test_closest_lane_key_min_is_the_first_minimum(V):
    env, veh = _reset(V)
    geo = env.geo
    s, lat = lane_ops.projection_table(geo, veh.pos)
    dl = lane_ops._heading_distance(geo, s, lat, veh.heading)
    # on the plain version's own distances: its argmin
    plain = lane_ops.closest_lane_from_table(geo, s, lat, veh.heading).to(torch.int64)
    assert torch.equal(_key_min(dl), plain)
    assert torch.equal(_serial_first_minimum(dl), plain)
    # ties, -0.0 against +0.0, infinities and NaN where the loop sees them
    rng = np.random.default_rng(V)
    L = geo.num_lanes
    grid = torch.from_numpy(rng.integers(0, 3, (B, L, V)).astype(np.float32))
    grid[:, 1::3, ::2] = 0.0
    grid[:, 2::3, ::2] = -0.0
    grid[:, 0, 1::4] = -0.0
    grid[:, 0, 2::5] = math.nan  # lane 0 NaN: lane 0 whatever follows
    grid[:, 1:, 3::4] = math.nan  # a later NaN: never taken
    grid[:, 3::5, 1::3] = math.inf
    grid[:, :, V - 1] = math.inf  # every lane at +inf: lane 0
    assert torch.equal(_key_min(grid), _serial_first_minimum(grid))
    assert bool((_key_min(grid)[:, 2::5] == 0).all())


# --------------------------------------------------------------------------- #
# (b) neighbour searches: walks of the lane's eligibility bits
# --------------------------------------------------------------------------- #


def _bit_walk_neighbours(query, table_s, elig):
    """The kernel's search: for each slot i and its query lane, the set bits
    of the lane's eligibility mask but i, word after word and each word's
    bits ascending, with the dense loop's comparisons.  query (B, V) lanes;
    returns (front, rear), -1 = none."""
    Bn, L, V = table_s.shape
    W = _n_words(V)
    q = query.clamp(0, L - 1).long()
    words = _to_words(elig)  # (B, L, W)
    qwords = torch.gather(words, 1, q[..., None].expand(Bn, V, W)).clone()  # (B, V, W)
    for i in range(V):  # no self: the bit of slot i cleared in its word
        w, bit = _slot_bit(i)
        qwords[:, i, w] &= ~bit
    s_q = torch.gather(table_s, 1, q[..., None].expand(Bn, V, V))  # [b, i, j]
    s_self = torch.diagonal(s_q, dim1=-2, dim2=-1)
    f_key = torch.full((Bn, V), math.inf)
    r_key = torch.full((Bn, V), -math.inf)
    front = torch.full((Bn, V), -1, dtype=torch.int64)
    rear = torch.full((Bn, V), -1, dtype=torch.int64)
    for j in range(V):  # word after word, bits ascending: the walk's order
        on = _has(qwords, j)
        sc = s_q[..., j]
        take_f = on & (s_self <= sc) & (sc <= f_key)
        take_r = on & (sc < s_self) & (sc > r_key)
        f_key = torch.where(take_f, sc, f_key)
        front = torch.where(take_f, j, front)
        r_key = torch.where(take_r, sc, r_key)
        rear = torch.where(take_r, j, rear)
    return front, rear


@pytest.mark.parametrize("V", SIZES)
def test_neighbour_bit_walks_keep_the_tie_rules(V):
    env, veh = _reset(V)
    geo = env.geo
    s, lat = lane_ops.projection_table(geo, veh.pos)
    # s on a 2.5 m grid (ties on every lane), -0.0 against 0.0, and some
    # slots pulled onto a shared lateral offset so that lanes fill up
    rng = np.random.default_rng(V)
    s = torch.round(s / 2.5) * 2.5
    zero = torch.from_numpy(rng.random(s.shape) < 0.1)
    s = torch.where(zero, torch.where(torch.from_numpy(rng.random(s.shape) < 0.5), -0.0, 0.0), s)
    lat = torch.where(torch.from_numpy(rng.random(lat.shape) < 0.5), lat * 0.0, lat)
    elig = behavior.eligible_on_lane(geo, veh, s, lat)
    found = 0
    for lane in range(geo.num_lanes):
        query = torch.full((B, V), lane, dtype=torch.int32)
        want_f, want_r = behavior.neighbours(veh, query, s, elig)
        got_f, got_r = _bit_walk_neighbours(query, s, elig)
        assert torch.equal(got_f, want_f.to(torch.int64)), lane
        assert torch.equal(got_r, want_r.to(torch.int64)), lane
        found += int((want_f >= 0).sum() + (want_r >= 0).sum())
    # and on each slot's own lane
    want_f, want_r = behavior.neighbours(veh, veh.lane, s, elig)
    got_f, got_r = _bit_walk_neighbours(veh.lane, s, elig)
    assert torch.equal(got_f, want_f.to(torch.int64))
    assert torch.equal(got_r, want_r.to(torch.int64))
    assert found > 0


# --------------------------------------------------------------------------- #
# (c) collisions: each pair once, slot bits, the highest partner's impact
# --------------------------------------------------------------------------- #


def _pair_once_collisions(state, dt: float, seed: int):
    """The kernel's collision pass: the pair tests of handle_collisions
    (the same (lower, upper) rows), read once per pair in a shuffled order
    and merged as slot bits into their words; the impact of the highest
    partner bit, from the top word down."""
    Bn, V = state.kind.shape
    px, py = state.pos[..., 0], state.pos[..., 1]

    def rows(x):
        return x[..., :, None]

    def cols(x):
        return x[..., None, :]

    velx = state.speed * torch.cos(state.heading)
    vely = state.speed * torch.sin(state.heading)
    inter, will, tx, ty = rects_intersecting_xy_folded(
        rows(px), rows(py), rows(state.length), rows(state.width), rows(state.heading),
        cols(px), cols(py), cols(state.length), cols(state.width), cols(state.heading),
        relx=(rows(velx) - cols(velx)) * dt, rely=(rows(vely) - cols(vely)) * dt,
    )
    diag = state.diagonal
    active, veh_, chk, coll = (state.active, state.is_vehicle, state.check_collisions,
                               state.collidable)
    solid, obst = state.solid, state.kind == KIND_OBSTACLE
    W = _n_words(V)
    crash = torch.zeros((Bn, W), dtype=torch.int64)
    hit = torch.zeros((Bn, W), dtype=torch.int64)
    imp = torch.zeros((Bn, V, W), dtype=torch.int64)
    for a, b in _shuffled_pairs(V, seed):
        ok = (active[:, a] & active[:, b] & (veh_[:, a] | veh_[:, b]) & (chk[:, a] | chk[:, b])
              & coll[:, a] & coll[:, b])
        dx, dy = px[:, a] - px[:, b], py[:, a] - py[:, b]
        reach = (diag[:, a] + diag[:, b]) / 2 + state.speed[:, a] * dt
        ok = ok & (dx * dx + dy * dy <= reach * reach)
        i_ab, w_ab = inter[:, a, b] & ok, will[:, a, b] & ok
        both = solid[:, a] & solid[:, b]
        (wa, ba), (wb, bb) = _slot_bit(a), _slot_bit(b)
        crash[:, wa] |= torch.where(i_ab & both, ba, 0)
        crash[:, wb] |= torch.where(i_ab & both, bb, 0)
        hit[:, wa] |= torch.where(i_ab & ~solid[:, a], ba, 0)
        hit[:, wb] |= torch.where(i_ab & ~solid[:, b], bb, 0)
        imp[:, a, wb] |= torch.where(w_ab & both & ~obst[:, a], bb, 0)
        imp[:, b, wa] |= torch.where(w_ab & both & ~obst[:, b], ba, 0)
    slots = torch.arange(V)
    # the highest set bit of each slot's partner words, from the top word down
    top = torch.full((Bn, V), -1, dtype=torch.int64)
    for w in reversed(range(W)):
        word = imp[..., w]
        hi = 32 * w + torch.floor(torch.log2(word.double().clamp(min=1))).long()
        top = torch.where((top < 0) & (word > 0), hi, top)
    j = top.clamp(min=0)
    lo, hi = torch.minimum(slots, j), torch.maximum(slots, j)
    t_x = torch.gather(tx.flatten(1), 1, lo * V + hi)
    t_y = torch.gather(ty.flatten(1), 1, lo * V + hi)
    other_obst = torch.gather(obst, 1, j)
    coef = torch.where(other_obst, 1.0, torch.where(j > slots, 0.5, -0.5))
    has = top >= 0
    impact = torch.stack([torch.where(has, coef * t_x, state.impact[..., 0]),
                          torch.where(has, coef * t_y, state.impact[..., 1])], dim=-1)
    def bit(words):
        return torch.stack([_has(words, s) for s in range(V)], dim=1)

    return state.replace(
        crashed=state.crashed | bit(crash), hit=state.hit | bit(hit), impact=impact,
        impact_pending=state.impact_pending | has,
    ), int(has.sum())


@pytest.mark.parametrize("V", SIZES)
def test_pair_once_collision_merge_keeps_last_write_impacts(V):
    env, veh = _reset(V)
    dt = env.dt
    scene = _pile_up(veh, step=1.5)
    # the odd envs closer, with a second row crossing the first
    half = _pile_up(veh, step=0.9)
    scene = scene.replace(pos=torch.where((torch.arange(B) % 2 == 1)[:, None, None],
                                          half.pos, scene.pos))
    want = collision.handle_collisions(scene, dt)
    got, n_impacts = _pair_once_collisions(scene, dt, seed=V)
    for name in ("crashed", "hit", "impact_pending"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(got.impact, want.impact)
    assert n_impacts > 0 and int(want.crashed.sum()) > 0


# --------------------------------------------------------------------------- #
# (d) the right-of-way pass: each pair of vehicles once, the yielder's bit
# --------------------------------------------------------------------------- #


def _conflict_scene(V: int):
    """intersection-v0's state with its first V slots, every slot an IDM
    vehicle approaching the box from corner (k - 1) % 4 (slot 0 on corner 0
    too; priorities 1 and 3, so both equal- and unequal-priority pairs
    conflict), 2 m behind the slot before it on its corner, bound for
    another corner; the last slot empty."""
    import dataclasses

    from highwayenv_tpu_torch.vehicle.state import VehicleState

    env = ht.make("intersection-v0", {"duration": max(20, V - 12)}, device="cpu")
    _, states = env.reset(B, env.generator(V))
    full = states.vehicles
    veh = VehicleState(**{f.name: getattr(full, f.name)[:, :V].clone()
                          for f in dataclasses.fields(VehicleState)})
    rb, rn, rid, rlen = env._routes
    off = torch.arange(B, dtype=torch.float32)
    for k in range(V - 1):
        corner = max(k - 1, 0) % 4  # slots 0 and 1 share corner 0
        row = (k - 1) // 4 + 1 if k >= 1 else 0
        dest = (corner + 1 + row % 3) % 4
        lane = env._spawn_lane[corner].expand(B)
        s = 92.0 - 2.0 * row - 0.75 * off
        veh.pos[:, k] = lane_ops.position(env.geo, lane, s, torch.zeros_like(s))
        veh.heading[:, k] = lane_ops.heading_at(env.geo, lane, s)
        for name, value in (("lane", lane), ("target_lane", lane), ("speed", 8.0),
                            ("target_speed", 8.0), ("kind", KIND_IDM), ("crashed", False),
                            ("route_ptr", 0), ("route_len", rlen[corner, dest])):
            getattr(veh, name)[:, k] = value
        for name, table in (("route_base", rb), ("route_n", rn), ("route_id", rid)):
            getattr(veh, name)[:, k] = table[corner, dest]
    veh.kind[:, V - 1] = 0
    # some slots already yielding, with timers on both sides of the release
    veh.is_yielding[:, 1::3] = True
    veh.yield_timer[:, 1::6] = 1
    return env, veh


def _pair_once_yields(geo, state, seed: int):
    """The kernel's right-of-way pass: the plain predictions, each pair of
    vehicles tested once (lower, upper) in a shuffled order, the yielder's
    slot bit merged into its word; then each slot's release and new
    yield."""
    Bn, V = state.kind.shape
    pos, heading = regulation.predict_route_positions(geo, state)
    px, py = pos[..., 0], pos[..., 1]
    c, s = torch.cos(heading), torch.sin(heading)
    li = lane_ops._gather(geo, state.lane)
    prio = geo.priority[li]
    cos0, sin0 = torch.cos(state.heading), torch.sin(state.heading)
    vh = state.is_vehicle
    yields = torch.zeros((Bn, _n_words(V)), dtype=torch.int64)
    kinds = {"equal": 0, "unequal": 0}
    for a, b in _shuffled_pairs(V, seed):
        both = vh[:, a] & vh[:, b]
        la, wa = 1.5 * state.length[:, a, None], 0.9 * state.width[:, a, None]
        lb, wb = 1.5 * state.length[:, b, None], 0.9 * state.width[:, b, None]
        dx, dy = px[:, b] - px[:, a], py[:, b] - py[:, a]
        close = dx * dx + dy * dy <= state.length[:, a, None] ** 2
        ra = (px[:, a], py[:, a], la, wa, c[:, a], s[:, a])
        rb_ = (px[:, b], py[:, b], lb, wb, c[:, b], s[:, b])
        conflict = both & (close & (regulation._one_way(ra, rb_)
                                    | regulation._one_way(rb_, ra))).any(dim=-1)
        d0x = state.pos[:, b, 0] - state.pos[:, a, 0]
        d0y = state.pos[:, b, 1] - state.pos[:, a, 1]
        front_ab = d0x * cos0[:, a] + d0y * sin0[:, a]
        front_ba = (-d0x) * cos0[:, b] + (-d0y) * sin0[:, b]
        pa, pb = prio[:, a], prio[:, b]
        a_yields = torch.where(pa != pb, pa < pb, front_ab > front_ba)
        for y, mine in ((a, a_yields), (b, ~a_yields)):
            w, bit = _slot_bit(y)
            yields[:, w] |= torch.where(conflict & mine, bit, 0)
        kinds["equal"] += int((conflict & (pa == pb)).sum())
        kinds["unequal"] += int((conflict & (pa != pb)).sum())
    bit = torch.stack([_has(yields, s) for s in range(V)], dim=1)
    new_yield = bit & ((state.kind == KIND_IDM) | (state.kind == KIND_LINEAR))
    expired = state.is_yielding & (state.yield_timer.float() >= 0.0)
    ts = torch.where(expired, geo.speed_limit[li], state.target_speed)
    yt = torch.where(state.is_yielding & ~expired, state.yield_timer + 1, state.yield_timer)
    yld = state.is_yielding & ~expired
    return state.replace(
        target_speed=torch.where(new_yield, 0.0, ts),
        yield_timer=torch.where(new_yield, 0, yt).to(torch.int32),
        is_yielding=yld | new_yield,
    ), kinds


@pytest.mark.parametrize("V", SIZES)
def test_pair_once_yield_merge_matches_enforce_road_rules(V):
    env, veh = _conflict_scene(V)
    want = regulation.enforce_road_rules(env.geo, veh)
    got, kinds = _pair_once_yields(env.geo, veh, seed=V)
    for name in ("target_speed", "is_yielding", "yield_timer"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert kinds["equal"] > 0 and kinds["unequal"] > 0, kinds
    assert bool((want.is_yielding & ~veh.is_yielding).any())


# --------------------------------------------------------------------------- #
# (e) the connected-lane search: candidate walks, explicit tie rules
# --------------------------------------------------------------------------- #

CONNECTED_SIZES = {5: ("roundabout-v1", None), 6: ("merge-v1", None), 21: ("exit-v1", None),
                   26: ("intersection-multi-agent-v2", None),
                   42: ("intersection-v2", {"duration": 30}),
                   51: ("exit-v1", {"vehicles_count": 50})}


def _connected_walk(geo, veh, query, table_s, elig, seed: int):
    """The kernel's ``Ctx::neighbours`` under kConnected, one (env, slot) at
    a time: the candidate lanes of the query lane in column order (pads
    skipped), on each the slots newly seen, word after word (its
    eligibility words but the slots seen and the slot itself), key = s
    there + the offset; the keys fed to the front / rear selection in a
    shuffled order with the explicit tie rules.  Returns (front, rear), -1
    = none."""
    Bn, L, V = table_s.shape
    W = _n_words(V)
    rng = np.random.default_rng(seed)
    lanes, offsets = geo.conn_lanes.tolist(), geo.conn_offsets.tolist()
    words = _to_words(elig).tolist()  # (B, L, W)
    s = table_s.tolist()
    front = np.full((Bn, V), -1)
    rear = np.full((Bn, V), -1)
    f32 = np.float32
    for b in range(Bn):
        for i in range(V):
            q = min(max(int(query[b, i]), 0), L - 1)
            s_self = f32(s[b][q][i])
            seen = [0] * W
            seen[i // 32] = 1 << (i % 32)
            items = []
            for c, off in zip(lanes[q], offsets[q]):
                if c < 0:
                    continue
                for w in range(W):
                    new = words[b][c][w] & ~seen[w]
                    seen[w] |= new
                    items += [(32 * w + k, f32(s[b][c][32 * w + k]) + f32(off))
                              for k in range(32) if new >> k & 1]
            f_key, r_key, f, r = f32(np.inf), f32(-np.inf), -1, -1
            for k in rng.permutation(len(items)):
                j, key = items[k]
                if s_self <= key and (key < f_key or (key == f_key and j > f)):
                    f_key, f = key, j
                if key < s_self and (key > r_key or (key == r_key and j < r)):
                    r_key, r = key, j
            front[b, i], rear[b, i] = f, r
    return torch.from_numpy(front), torch.from_numpy(rear)


@pytest.mark.parametrize("V", sorted(CONNECTED_SIZES))
def test_connected_candidate_walks_keep_the_tie_rules(V):
    env = ht.make(*CONNECTED_SIZES[V], device="cpu")
    assert env.num_slots == V and env._general.connected
    _, states = env.reset(B, env.generator(V))
    veh = states.vehicles
    geo = env.geo
    s, lat = lane_ops.projection_table(geo, veh.pos)
    # the reset tables, then s on a 2.5 m grid with lat 0 on most entries:
    # equal keys across slots and slots on several candidate lanes
    rng = np.random.default_rng(V)
    grid = torch.round(s / 2.5) * 2.5
    flat = torch.where(torch.from_numpy(rng.random(lat.shape) < 0.7), lat * 0.0, lat)
    found = 0
    for table_s, table_lat in ((s, lat), (grid, flat)):
        elig = behavior.eligible_on_lane(geo, veh, table_s, table_lat)
        queries = [veh.lane, veh.target_lane] + [
            torch.full((B, V), lane, dtype=torch.int32) for lane in range(geo.num_lanes)]
        for k, query in enumerate(queries):
            want_f, want_r = behavior.neighbours_connected(geo, veh, query, table_s, table_lat)
            got_f, got_r = _connected_walk(geo, veh, query, table_s, elig, seed=V + k)
            assert torch.equal(got_f, want_f.to(torch.int64)), k
            assert torch.equal(got_r, want_r.to(torch.int64)), k
            found += int((want_f >= 0).sum() + (want_r >= 0).sum())
    assert found > 0
