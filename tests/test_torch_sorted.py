"""The port's s-sorted straight step against the JAX package, on the CPU.

On CPU tensors the wrappers of the sorted path run their plain versions:
``sort_plain`` (K2a), ``frames_sorted_plain`` (K3), ``unsort_plain`` (K2b)
and, for the envs whose band flags fire, ``frames_plain`` (K1).  They are
held against the JAX package's own Pallas kernels in interpret mode with
``block=8`` (``highwayenv_tpu/ops/straight_pallas_bm.py``), on scenes built
with numpy from a seeded JAX reset:

  (a) the sort and unsort against ``build_sort_kernels``: ``idx`` and every
      permuted field bit-exact, and unsort after sort the identity;
  (b) the banded frames against ``build_pallas_frame(sorted_mode=True)``,
      the one-frame kernel applied frame after frame, which is what its
      ``frames=F`` build loops over (it compiles several times faster in
      interpret mode): discrete fields and per-env flags exact;
  (c) the whole sorted step against the port's dense step, against the JAX
      banded kernel's flags, and over one frame against JAX
      ``pallas_simulate_bm_sorted`` itself (whose fallback takes its patch
      path for one firing env and its whole-batch path for all);
  (d) a neighbour-crossing scene: a member of a deciding row's query lane
      starts more than ``NEIGH_WINDOW`` ranks away and crosses the row in s
      within the step.

The scenes keep every pair beyond the collision band far from the reach
bound R, so the JAX flag, whose R is the max over its 8-env tile, and the
port's, whose R is per env, agree on them.  A last scene shows where they
part, and that both are exact (``test_collision_reach_is_the_envs_own``).

Tolerances: discrete fields exact; against JAX pos 2e-4 m and other
continuous fields 1e-4 of their magnitude (test_torch_straight_frames.py:
two CPU libms and XLA's contraction of a*b+c); sorted against dense in the
port, a few ulp at the field's magnitude, as tests/test_batched_step.py
holds the JAX sorted path to its dense one (the banded pass puts the lower
rank first in a pair's SAT where the dense pass puts the lower slot).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import highwayenv_tpu as hj
import highwayenv_tpu_torch as ht
from highwayenv_tpu.ops.straight_pallas_bm import (
    BM_FIELDS,
    BM_MUT_FIELDS,
    build_pallas_frame,
    build_sort_kernels,
    pack_bm,
    pallas_simulate_bm_sorted,
)
from highwayenv_tpu_torch.bridge import from_numpy_state
from highwayenv_tpu_torch.envs import base as t_base
from highwayenv_tpu_torch.ops import _build
from highwayenv_tpu_torch.ops import straight_frames as sf
from highwayenv_tpu_torch.ops import straight_sorted as ss
from highwayenv_tpu_torch.vehicle.state import KIND_EGO, VehicleState

torch.set_num_threads(1)

BLOCK = 8
BATCH = {"highway-fast-v0": 16, "highway-v0": 8}
SCENES = ("normal", "compressed", "pileup", "pileup_all")
# highway-fast-v0 runs every scene, highway-v0 (V=51, 15 frames) one
CASES = [("highway-fast-v0", s) for s in SCENES] + [("highway-v0", "pileup")]
DISCRETE = ("lane", "target_lane", "crashed", "impact_pending")
CONTINUOUS = ("pos", "heading", "speed", "timer", "impact", "steering", "accel")
# port field -> JAX batch-minor fields
_BM = {"pos": ("px", "py"), "impact": ("impact_x", "impact_y"),
       "accel_params": ("accel_p0", "accel_p1", "accel_p2"),
       "steer_params": ("steer_p0", "steer_p1")}

_SETUP: dict = {}
_BANDED: dict = {}


def _setup(env_id):
    """JAX env, port env, a JAX reset batch and the jitted JAX kernels,
    built once per env so each compiles once per test process."""
    if env_id not in _SETUP:
        ej = hj.make(env_id)
        et = ht.make(env_id, device="cpu")
        B = BATCH[env_id]
        _, states = jax.jit(jax.vmap(ej._reset))(
            jax.random.split(jax.random.PRNGKey(5), B)
        )
        sort_fn, unsort_fn = build_sort_kernels(ej, block=BLOCK, interpret=True)
        frame_fn = build_pallas_frame(
            ej, block=BLOCK, interpret=True, frames=1, sorted_mode=True
        )
        _SETUP[env_id] = (
            ej, et, states.vehicles, jax.jit(sort_fn), jax.jit(unsort_fn),
            jax.jit(frame_fn),
        )
    return _SETUP[env_id]


def _scene(veh, name):
    """Positions of a JAX VehicleState batch rewritten as
    tests/test_batched_step.py does: normal, compressed (x * 0.2: immediate
    collisions), a 20-vehicle pile-up in 6 m in env 0, and in every env."""
    pos = np.asarray(veh.pos).copy()
    if name == "compressed":
        pos[..., 0] *= 0.2
    elif name == "pileup":
        pos[0, :20, 0] = 100.0 + np.linspace(0, 6, 20)
    elif name == "pileup_all":
        pos[:, :20, 0] = 100.0 + np.linspace(0, 6, 20)
    return veh.replace(pos=jnp.asarray(pos))


def _to_torch(veh) -> VehicleState:
    return from_numpy_state({
        "vehicles": {
            f.name: np.asarray(getattr(veh, f.name))
            for f in dataclasses.fields(VehicleState)
        },
        "time": np.zeros(veh.kind.shape[0], np.float32),
        "steps": np.zeros(veh.kind.shape[0], np.int32),
    }).vehicles


def _jax_field(arrays: dict, name: str) -> np.ndarray:
    """A port field from JAX (V, B) f32 arrays, as (B, V[, 2]) f32."""
    if name in _BM:
        return np.stack([np.asarray(arrays[n]).T for n in _BM[name]], axis=-1)
    return np.asarray(arrays[name]).T


def _assert_vs_jax(port: VehicleState, arrays: dict, fields, where: str):
    """Port state against JAX arrays: discrete exact, continuous within
    the stated tolerances."""
    for name in fields:
        a = getattr(port, name).numpy().astype(np.float64)
        b = _jax_field(arrays, name).astype(np.float64)
        if name in DISCRETE:
            np.testing.assert_array_equal(a, b, err_msg=f"{where}: {name}")
        else:
            tol = 2e-4 if name == "pos" else 1e-4 * max(1.0, float(np.abs(b).max()))
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=f"{where}: {name}")


def _assert_vs_dense(sorted_: VehicleState, dense: VehicleState, where: str):
    for name in DISCRETE:
        np.testing.assert_array_equal(
            getattr(sorted_, name).numpy(), getattr(dense, name).numpy(),
            err_msg=f"{where}: {name}",
        )
    for name in CONTINUOUS:
        a = getattr(dense, name).numpy().astype(np.float64)
        b = getattr(sorted_, name).numpy().astype(np.float64)
        tol = 32.0 * np.finfo(np.float32).eps * max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg=f"{where}: {name}")


def _jax_banded(env_id, veh_j, key, frames=None):
    """JAX's sort, then its banded frame kernel over ``frames`` frames (the
    step's by default): (sorted arrays, frame arrays after them, per-env
    flag), cached under ``key``."""
    if key not in _BANDED:
        ej, _, _, sort_fn, _, frame_fn = _setup(env_id)
        srt = sort_fn(pack_bm(veh_j))
        n = len(BM_MUT_FIELDS)
        arrays = (
            list(srt[:n]) + [jnp.zeros_like(srt[0])]
            + list(srt[n:len(BM_FIELDS)]) + [srt[-1]]
        )
        for _ in range(frames or ej.frames_per_step):
            arrays = frame_fn(arrays)
        flag = np.asarray(jnp.max(arrays[n], axis=0) > 0.5)
        _BANDED[key] = (srt, arrays, flag)
    return _BANDED[key]


def _slot_actions(env_id, seed):
    ej, et, veh_j, *_ = _setup(env_id)
    acts = np.random.default_rng(seed).integers(0, et.action_type.n, veh_j.kind.shape[0])
    acts = acts.astype(np.int32)
    return jax.vmap(ej._action_to_slots)(jnp.asarray(acts)), et._action_to_slots(
        torch.from_numpy(acts)
    )


# --------------------------------------------------------------------------- #
# (a) sort / unsort
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("env_id", list(BATCH))
def test_sort_and_unsort_match_jax(env_id):
    """Both packages rank by ascending s with ties in slot order; the scene
    has exact ties, and -0.0 against 0.0, which the count rule ties."""
    ej, et, veh_j, sort_fn, unsort_fn, _ = _setup(env_id)
    pos = np.asarray(veh_j.pos).copy()
    pos[:, 3] = (-0.0, -2.0)  # s = -0.0 ...
    pos[:, 2] = (0.0, 4.0)  # ... ties s = 0.0 in slot order
    pos[:, 5:8, 0] = pos[:, 4:5, 0]  # three more exact ties
    veh_j = veh_j.replace(pos=jnp.asarray(pos))
    veh_t = _to_torch(veh_j)
    assert np.signbit(ss.s_coordinate(veh_t.pos, et._straight)[:, 3].numpy()).all()

    srt_j = sort_fn(pack_bm(veh_j))
    srt_t, idx_t = ss.sort_plain(veh_t, et._straight)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(srt_j[-1]).T)
    # the two smallest s, tied: slot 2 (0.0) ranks before slot 3 (-0.0)
    assert (idx_t[:, 0] == 2).all() and (idx_t[:, 1] == 3).all()
    arrays = dict(zip(BM_FIELDS, srt_j))
    for name, _, _ in ss.SORT_FIELDS:
        np.testing.assert_array_equal(
            getattr(srt_t, name).numpy().astype(np.float32),
            _jax_field(arrays, name), err_msg=name,
        )

    # unsort: JAX's inverse permutation of its mutated fields
    mut_j = unsort_fn(srt_j[: len(BM_MUT_FIELDS)], srt_j[-1])
    back_t = ss.unsort_plain(srt_t, idx_t, veh_t)
    mut_arrays = dict(zip(BM_MUT_FIELDS, mut_j))
    for name, _, _ in ss.MUT_FIELDS:
        np.testing.assert_array_equal(
            getattr(back_t, name).numpy().astype(np.float32),
            _jax_field(mut_arrays, name), err_msg=name,
        )
        assert torch.equal(getattr(back_t, name), getattr(veh_t, name)), name


# --------------------------------------------------------------------------- #
# (b) banded frames
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("env_id,scene", CASES)
def test_frames_sorted_plain_matches_jax(env_id, scene):
    ej, et, veh_j, *_ = _setup(env_id)
    veh_j = _scene(veh_j, scene)
    _, arrays, flag_j = _jax_banded(env_id, veh_j, (env_id, scene, None))
    srt_t, idx_t = ss.sort_plain(_to_torch(veh_j), et._straight)
    out_t, flags_t = ss.frames_sorted_plain(
        srt_t, idx_t, et._straight, et.idm_params, et.dt, et.frames_per_step
    )
    _assert_vs_jax(
        out_t, dict(zip(BM_MUT_FIELDS, arrays)), DISCRETE + CONTINUOUS, scene
    )
    np.testing.assert_array_equal(flags_t.any(dim=1).numpy(), flag_j)
    if scene.startswith("pileup"):
        # more than SORT_WINDOW vehicles within reach: the collision band
        # fires, in env 0 only or everywhere
        expect = np.ones(len(flag_j), bool) if scene == "pileup_all" else (
            np.arange(len(flag_j)) == 0
        )
        np.testing.assert_array_equal(flags_t[:, 0].numpy(), expect)


# --------------------------------------------------------------------------- #
# (c) the whole sorted step
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("env_id,scene", CASES)
def test_simulate_bm_sorted_matches_dense_and_jax_flags(env_id, scene):
    ej, et, veh_j, *_ = _setup(env_id)
    veh_j = _scene(veh_j, scene)
    sa_j, sa_t = _slot_actions(env_id, 11)
    veh_t = _to_torch(veh_j)
    out, flags = ss.simulate_bm_sorted(
        et, veh_t, sa_t, et.frames_per_step, return_flags=True
    )
    dense = sf.simulate_bm(et, veh_t, sa_t, et.frames_per_step)
    _assert_vs_dense(out, dense, scene)
    # the flags JAX's banded kernel raises from the same post-action state
    applied = ej.action_type.apply(ej.geo, veh_j, veh_j.kind == KIND_EGO, sa_j)
    _, _, flag_j = _jax_banded(env_id, applied, (env_id, scene, 11))
    np.testing.assert_array_equal(flags.any(dim=1).numpy(), flag_j)
    if scene.startswith("pileup"):
        np.testing.assert_array_equal(flags[:, 0].numpy(), flag_j)
        assert flag_j.any()
    if scene == "compressed":
        assert out.crashed.any()  # collisions exercised


@pytest.mark.parametrize("scene", SCENES)
def test_one_frame_step_matches_jax_pallas_simulate_bm_sorted(scene):
    """``pallas_simulate_bm_sorted`` itself, over one frame (its ``frames``
    argument compiles a loop that takes minutes in interpret mode): with 16
    envs and 8-env blocks its fallback re-runs one firing env through its
    patch buffer and all of them through the whole-batch path, where the
    port launches K1 once with the flag mask either way."""
    env_id = "highway-fast-v0"
    ej, et, veh_j, *_ = _setup(env_id)
    key = ("step", env_id)
    if key not in _SETUP:
        _SETUP[key] = jax.jit(lambda v, sa: pallas_simulate_bm_sorted(
            ej, v, sa, 1, block=BLOCK, interpret=True, return_viol=True
        ))
    veh_j = _scene(veh_j, scene)
    sa_j, sa_t = _slot_actions(env_id, 13)
    out_j, n_viol = _SETUP[key](veh_j, sa_j)
    out_t, flags = ss.simulate_bm_sorted(et, _to_torch(veh_j), sa_t, 1, return_flags=True)
    for name in DISCRETE + CONTINUOUS:
        a = getattr(out_t, name).numpy().astype(np.float64)
        b = np.asarray(getattr(out_j, name)).astype(np.float64)
        if name in DISCRETE:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            tol = 2e-4 if name == "pos" else 1e-4 * max(1.0, float(np.abs(b).max()))
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)
    assert int(flags.any(dim=1).sum()) == int(n_viol)
    expect = {"normal": 0, "compressed": 0, "pileup": 1, "pileup_all": 16}[scene]
    assert int(n_viol) == expect


# --------------------------------------------------------------------------- #
# (d) a neighbour crossing the band cannot see
# --------------------------------------------------------------------------- #
def _crossing_scene(veh_j):
    """Env 0 of highway-v0 (lanes at y = 0, 4, 8, 12): IDM car Q on lane 1
    at 38 m/s, its MOBIL timer set so that it decides at frame 8; eight
    slow cars on lanes 0 and 3 rank between Q and X, a slow car on lane 2
    16.5 m ahead, so X starts 9 ranks ahead of Q; Q passes X before it
    decides.  A slow car ahead on lane 1 makes lane 2 attractive.  The other
    slots are far ahead; the other envs keep their reset scenes."""
    f = {n: np.asarray(getattr(veh_j, n)).copy()
         for n in ("pos", "lane", "speed", "target_speed", "timer", "delta")}

    def put(slot, x, lane, speed, timer=0.0):
        f["pos"][0, slot] = (x, 4.0 * lane)
        f["lane"][0, slot] = lane
        f["speed"][0, slot] = f["target_speed"][0, slot] = speed
        f["timer"][0, slot] = timer

    V = f["pos"].shape[1]
    put(0, 0.0, 0, 25.0)  # the ego, far behind
    put(1, 100.0, 1, 38.0, timer=0.5)  # Q
    f["delta"][0, 1] = 4.0
    slot = 2
    for x in (100.0, 105.5, 111.0, 116.5):
        for lane in (0, 3):
            put(slot, x, lane, 2.0)
            slot += 1
    put(slot, 116.5, 2, 2.0)  # X, ranked after the eight at its s
    put(slot + 1, 160.0, 1, 15.0)  # Q's slow front
    for k, s in enumerate(range(slot + 2, V)):
        put(s, 400.0 + 20.0 * k, int(f["lane"][0, s]), float(f["speed"][0, s]))
    return veh_j.replace(
        target_lane=jnp.asarray(f["lane"]),
        **{n: jnp.asarray(v) for n, v in f.items()},
    )


def test_neighbour_crossing_raises_the_flag_and_the_fallback_restores_dense():
    env_id = "highway-v0"
    ej, et, veh_j, *_ = _setup(env_id)
    veh_j = _crossing_scene(veh_j)
    veh_t = _to_torch(veh_j)
    fs, p, dt, F = et._straight, et.idm_params, et.dt, et.frames_per_step
    srt, idx = ss.sort_plain(veh_t, fs)
    q_rank = int((idx[0] == 1).nonzero())
    x_rank = int((idx[0] == 10).nonzero())
    assert x_rank - q_rank > ss.NEIGH_WINDOW

    banded, flags = ss.frames_sorted_plain(srt, idx, fs, p, dt, F)
    expect = np.zeros((len(flags), 2), bool)
    expect[0, 1] = True  # the neighbour flag of env 0 only
    np.testing.assert_array_equal(flags.numpy(), expect)
    _, _, flag_j = _jax_banded(env_id, veh_j, (env_id, "crossing", None))
    np.testing.assert_array_equal(flag_j, expect.any(axis=1))

    # the step: the fallback makes env 0 the dense result
    idle = et._action_to_slots(torch.ones(len(flags), dtype=torch.int32))
    out = ss.simulate_bm_sorted(et, veh_t, idle, F)
    dense = sf.simulate_bm(et, veh_t, idle, F)
    _assert_vs_dense(out, dense, "crossing")
    # without it, env 0's banded state is wrong: Q misses X behind it on
    # lane 2 and changes lanes in front of it; the other envs are exact
    banded = ss.unsort_plain(banded, idx, veh_t)
    assert banded.target_lane[0, 1] == 2 and dense.target_lane[0, 1] == 1
    assert float((banded.pos[0] - dense.pos[0]).abs().max()) > 0.5
    for name in DISCRETE:
        assert torch.equal(getattr(banded, name)[1:], getattr(dense, name)[1:]), name


def test_collision_reach_is_the_envs_own():
    """The collision flag's R = max diag + max speed * dt is taken over the
    env's slots, where the JAX kernel takes it over its 8-env tile.  Env 0's
    ego at 40 m/s raises the tile's R by (40 - 25) / 15 = 1 m over env 1's;
    env 1 has a pair 13 ranks apart 7.5 m apart in s, between its own R and
    the tile's: JAX flags env 1, the port does not, and env 1's banded frame
    is exact all the same (the dense frame's, up to the SAT order)."""
    env_id = "highway-v0"
    ej, et, veh_j, *_ = _setup(env_id)
    f = {n: np.asarray(getattr(veh_j, n)).copy()
         for n in ("pos", "lane", "speed", "target_speed")}
    f["speed"][0, 0] = f["target_speed"][0, 0] = 40.0
    f["pos"][1, 0, 0] = 0.0  # env 1's ego out of the way
    for k in range(14):  # slots 1..14 of env 1: ranks 1..14 over 7.5 m
        f["pos"][1, k + 1] = (100.0 + 7.5 * k / 13, 4.0 * (k % 4))
        f["lane"][1, k + 1] = k % 4
        f["speed"][1, k + 1] = f["target_speed"][1, k + 1] = 20.0
    veh_j = veh_j.replace(
        target_lane=jnp.asarray(f["lane"]), **{n: jnp.asarray(v) for n, v in f.items()}
    )
    _, _, flag_j = _jax_banded(env_id, veh_j, (env_id, "reach", None), frames=1)
    veh_t = _to_torch(veh_j)
    fs, p, dt = et._straight, et.idm_params, et.dt
    srt, idx = ss.sort_plain(veh_t, fs)
    band, flags = ss.frames_sorted_plain(srt, idx, fs, p, dt, 1)
    assert flag_j[1] and not flags[1].any()
    np.testing.assert_array_equal(np.delete(flag_j, 1), np.delete(flags.any(dim=1).numpy(), 1))
    dense = sf.frames_plain(veh_t, fs, p, dt, 1)
    _assert_vs_dense(ss.unsort_plain(band, idx, veh_t), dense, "reach")


# --------------------------------------------------------------------------- #
# (e) the CUDA kernels' search orders, modelled in plain torch
# --------------------------------------------------------------------------- #
def _warp_scan(key, rank, lower_wins: bool):
    """The kernels' in-warp inclusive scan of (key, rank) pairs over the last
    dim (a multiple of 32): Hillis-Steele rounds k = 1, 2, .., 16 within each
    32-wide chunk, the pair k ranks up joining a suffix argmin (``lower_wins``
    False: it wins ties, the larger rank) or the pair k ranks down joining a
    prefix argmax (``lower_wins``: it wins ties, the smaller rank).  rank -1
    is no pair."""
    lane = torch.arange(key.shape[-1]) % 32
    k = 1
    while k < 32:
        if lower_wins:
            k2 = torch.cat([torch.full_like(key[..., :k], -np.inf), key[..., :-k]], -1)
            r2 = torch.cat([torch.full_like(rank[..., :k], -1), rank[..., :-k]], -1)
            take = (lane >= k) & (r2 >= 0) & ((rank < 0) | (k2 >= key))
        else:
            k2 = torch.cat([key[..., k:], torch.full_like(key[..., :k], np.inf)], -1)
            r2 = torch.cat([rank[..., k:], torch.full_like(rank[..., :k], -1)], -1)
            take = (lane + k < 32) & (r2 >= 0) & ((rank < 0) | (k2 <= key))
        key, rank = torch.where(take, k2, key), torch.where(take, r2, rank)
        k *= 2
    return rank


def _key_scan(s, member, ahead: bool):
    """K3's in-warp scan as it runs: one 64-bit key per rank, the order of s
    (``float_order``: the float's bits made monotonic, -0.0 read as 0.0) over
    ~rank, joined by a plain min (ahead) or max (behind) with the key k
    ranks up or down, a lane past the warp's end reading its own.  Modelled
    as (high, low) pairs compared in turn; returns the winners' ranks."""
    N = s.shape[-1]
    bits = (s + 0.0).view(torch.int32).long() & 0xFFFFFFFF
    hi = torch.where(bits >= 1 << 31, 0xFFFFFFFF - bits, bits | 1 << 31)
    lo = (0xFFFFFFFF - torch.arange(N)).expand_as(hi)
    fill = 0xFFFFFFFF if ahead else 0
    hi, lo = torch.where(member, hi, fill), torch.where(member, lo, fill)
    lane = torch.arange(N) % 32
    k = 1
    while k < 32:
        src = torch.arange(N) + (k if ahead else -k)
        src = torch.where((lane + k < 32) if ahead else (lane >= k), src, torch.arange(N))
        h2, l2 = hi[..., src], lo[..., src]
        less = (h2 < hi) | ((h2 == hi) & (l2 < lo))
        more = (h2 > hi) | ((h2 == hi) & (l2 > lo))
        take = less if ahead else more
        hi, lo = torch.where(take, h2, hi), torch.where(take, l2, lo)
        k *= 2
    none = (hi == fill) & (lo == fill)
    return torch.where(none, -1, 0xFFFFFFFF - lo)


def _join(scan, pos, s, ahead: bool) -> int:
    """A query of the two-level scan: the in-warp result at ``pos`` joined
    with the totals of the warps beyond it (lane 0 of each later warp ahead,
    lane 31 of each earlier warp behind), nearest first."""
    w = int(scan[pos])
    others = range((pos >> 5) + 1, len(scan) // 32) if ahead else range((pos >> 5) - 1, -1, -1)
    for c in others:
        w2 = int(scan[32 * c if ahead else 32 * c + 31])
        if w2 >= 0 and (w < 0 or (s[w2] <= s[w] if ahead else s[w2] >= s[w])):
            w = w2
    return w


def _ballot_words(bits):
    """(..., V) bool -> (..., NW) 32-bit words, bit j of word w = slot 32 w + j."""
    V = bits.shape[-1]
    pad = torch.zeros(bits.shape[:-1] + (-V % 32,), dtype=torch.bool)
    b = torch.cat([bits, pad], -1).unflatten(-1, (-1, 32)).long()
    return (b << torch.arange(32)).sum(-1)


def _visit(words, lo: int, hi: int, self_: int):
    """The slots of the set bits within lo..hi but self_, in ascending
    order: the kernels' walk (``visit_bits``)."""
    for w in range(lo >> 5, (hi >> 5) + 1):
        bits = int(words[w])
        for j in range(32):
            col = 32 * w + j
            if bits >> j & 1 and lo <= col <= hi and col != self_:
                yield col


@pytest.mark.parametrize("V", [1, 21, 32, 33, 51, 64, 101])
def test_kernel_scans_and_lane_walks_match_the_plain_searches(V):
    """K3's two-level scans (32-wide chunks, then across chunks; the combine
    rule and the packed keys the kernel runs it with) and K1 / K3's walks of
    the lane ballot words in ascending slot order, modelled in plain torch,
    give ``neigh_banded_plain``'s far winners, fronts, rears and
    crossings, the dense ``neighbours``, and ``collisions_banded_plain``'s
    suffix min / max of s and its flag, on tie-heavy scenes: s on a 2.5 m
    grid with -0.0 against 0.0, vehicles between two lanes, some off the
    road or inactive."""
    et = ht.make("highway-v0", config={"vehicles_count": V - 1}, device="cpu")
    fs, p, dt = et._straight, et.idm_params, et.dt
    _, states = et.reset(3, et.generator(V))
    rng = np.random.default_rng(V)
    B = 3
    x = 100.0 + 2.5 * rng.integers(0, 6, (B, V))
    x[:, ::7] = 0.0
    x[:, 3::7] = -0.0
    x[:, 5::11] = -50.0  # off the road: not occupiable
    y = 4.0 * rng.integers(0, 4, (B, V)) + rng.choice([-3.0, -2.0, 0.0, 2.0, 3.0], (B, V))
    kind = states.vehicles.kind.clone()
    kind[:, 4::9] = 0  # inactive slots
    veh = states.vehicles.replace(
        pos=torch.from_numpy(np.stack([x, y], -1).astype(np.float32)), kind=kind
    )
    srt, idx = ss.sort_plain(veh, fs)
    W, Wn = ss.windows(V)
    s, lat0, occ, _, _ = sf.project(srt, fs)
    L = len(fs.offsets)
    tol = fs.width / 2 + 1.0
    off = torch.tensor(fs.offsets, dtype=torch.float32)
    q_off = off[None, :, None].expand(B, L, V).contiguous()  # every lane a query
    front, rear, crossed = ss.neigh_banded_plain(s, lat0, occ, q_off, tol, Wn)
    d_front, d_rear = sf.neighbours(s, lat0, occ, q_off, tol)
    member = sf.lane_members(s, lat0, occ, q_off, tol)  # (B, L, V, V)
    gap = torch.arange(V)[None, :] - torch.arange(V)[:, None]
    s_c = s[:, None, None, :]
    far_a = sf.front_pick(member & (gap > Wn), s_c)
    far_b = sf.rear_pick(member & (gap < -Wn), s_c)

    # the model: ballot words and the in-warp scans of every lane
    N = -(-V // 32) * 32
    mem = (lat0[:, None, :] - off[None, :, None]).abs() <= tol
    mem = mem & occ[:, None, :]  # (B, L, V)
    words = _ballot_words(mem)
    pad = N - V
    s_pad = torch.cat([s, torch.zeros(B, pad)], -1)[:, None, :].expand(B, L, N)
    m_pad = torch.cat([mem, torch.zeros(B, L, pad, dtype=torch.bool)], -1)
    rank = torch.where(m_pad, torch.arange(N), -1)
    ahead = _warp_scan(torch.where(m_pad, s_pad, np.inf), rank, lower_wins=False)
    behind = _warp_scan(torch.where(m_pad, s_pad, -np.inf), rank, lower_wins=True)
    # the packed keys the kernel scans give the same winners
    assert torch.equal(_key_scan(s_pad, m_pad, ahead=True), ahead)
    assert torch.equal(_key_scan(s_pad, m_pad, ahead=False), behind)
    for b in range(B):
        sb = s[b].tolist()
        for lane in range(L):
            for i in range(V):
                a = _join(ahead[b, lane], i + Wn + 1, sb, True) if i + Wn + 1 < V else -1
                r_ = _join(behind[b, lane], i - Wn - 1, sb, False) if i - Wn - 1 >= 0 else -1
                assert (a, r_) == (int(far_a[b, lane, i]), int(far_b[b, lane, i])), (b, lane, i)
                si = sb[i]
                cross = (a >= 0 and sb[a] < si) or (r_ >= 0 and sb[r_] >= si)
                f_key, r_key, f_idx, r_idx = np.inf, -np.inf, -1, -1
                if r_ >= 0 and sb[r_] < si:
                    r_key, r_idx = sb[r_], r_
                band = _visit(words[b, lane], max(i - Wn, 0), min(i + Wn, V - 1), i)
                for col in band:
                    if si <= sb[col] <= f_key:
                        f_key, f_idx = sb[col], col
                    if sb[col] < si and sb[col] > r_key:
                        r_key, r_idx = sb[col], col
                if a >= 0 and si <= sb[a] <= f_key:
                    f_idx = a
                assert (f_idx, r_idx, cross) == (
                    int(front[b, lane, i]), int(rear[b, lane, i]), bool(crossed[b, lane, i])
                ), (b, lane, i)
                # the dense walk: every member of the lane
                f_key, r_key, f_idx, r_idx = np.inf, -np.inf, -1, -1
                for col in _visit(words[b, lane], 0, V - 1, i):
                    if si <= sb[col] <= f_key:
                        f_key, f_idx = sb[col], col
                    if sb[col] < si and sb[col] > r_key:
                        r_key, r_idx = sb[col], col
                assert (f_idx, r_idx) == (int(d_front[b, lane, i]), int(d_rear[b, lane, i]))

    # the collision band: in-warp suffix min / max of s joined across warps,
    # and the env's max diag and speed, against collisions_banded_plain
    _, flag = ss.collisions_banded_plain(srt, idx, fs, dt, W)
    act = srt.active
    sa = torch.cat([torch.where(act, s, np.inf), torch.full((B, pad), np.inf)], -1)
    sx = torch.cat([torch.where(act, s, -np.inf), torch.full((B, pad), -np.inf)], -1)
    lane_ = torch.arange(N) % 32
    k = 1
    while k < 32:
        ok = lane_ + k < 32
        sa = torch.where(ok, torch.minimum(sa, torch.cat([sa[:, k:], sa[:, :k]], -1)), sa)
        sx = torch.where(ok, torch.maximum(sx, torch.cat([sx[:, k:], sx[:, :k]], -1)), sx)
        k *= 2
    far_min = torch.cummin(torch.where(act, s, np.inf).flip(-1), -1).values.flip(-1)
    far_max = torch.cummax(torch.where(act, s, -np.inf).flip(-1), -1).values.flip(-1)

    def warp_max(x):  # each warp's max, then the max over the warps
        x = torch.cat([torch.where(act, x, 0.0), torch.full((B, pad), -np.inf)], -1)
        return x.unflatten(-1, (-1, 32)).amax(-1).amax(-1)

    R = (warp_max(srt.diagonal) + warp_max(srt.speed) * dt)[:, None]
    up, down = s + R, s - R  # float32, as the kernel adds them
    for b in range(B):
        fired = False
        for i in range(V):
            lo, hi = float(sa[b, i]), float(sx[b, i])
            for c in range((i >> 5) + 1, N // 32):
                lo, hi = min(lo, float(sa[b, 32 * c])), max(hi, float(sx[b, 32 * c]))
            assert (lo, hi) == (float(far_min[b, i]), float(far_max[b, i])), (b, i)
            q = i - W - 1  # the rank whose band ends before i
            if q >= 0 and bool(act[b, q]):
                fired |= lo <= float(up[b, q]) and hi >= float(down[b, q])
        assert fired == bool(flag[b]), b


# --------------------------------------------------------------------------- #
# dispatch, wrappers, build
# --------------------------------------------------------------------------- #
def test_make_steps_sorted_by_default_and_dense_on_request(monkeypatch):
    calls = []
    for name in ("simulate_bm_sorted", "simulate_bm"):
        real = getattr(t_base, name)
        monkeypatch.setattr(
            t_base, name,
            lambda *a, _real=real, _name=name, **k: calls.append(_name) or _real(*a, **k),
        )
    gen = torch.Generator().manual_seed(0)
    for sorted_frames, expect in ((None, "simulate_bm_sorted"), (False, "simulate_bm")):
        kwargs = {} if sorted_frames is None else {"sorted_frames": sorted_frames}
        env = ht.make("highway-fast-v0", device="cpu", **kwargs)
        _, states = env.reset(4, gen)
        env.step_autoreset_batched(states, torch.ones(4, dtype=torch.int32), gen)
        assert calls[-1] == expect


def test_wrappers_run_plain_on_the_cpu_and_count_no_launch():
    et = ht.make("highway-fast-v0", device="cpu")
    _, states = et.reset(4, et.generator(0))
    before = [k.launches for k in (ss.sort_kernel, ss.frames_sorted_kernel,
                                   ss.unsort_kernel, sf.frames_kernel)]
    veh = states.vehicles
    srt, idx = ss.sort_kernel(veh, et._straight)
    out, flags = ss.frames_sorted_kernel(
        srt, idx, et._straight, et.idm_params, et.dt, et.frames_per_step
    )
    back = ss.unsort_kernel(out, idx, veh)
    mask = torch.tensor([True, False, True, False])
    fixed = sf.frames_kernel(
        veh, et._straight, et.idm_params, et.dt, et.frames_per_step,
        mask=mask, out=back,
    )
    assert fixed is back  # rows written in place
    dense = sf.frames_plain(veh, et._straight, et.idm_params, et.dt, et.frames_per_step)
    for name, _, _ in ss.MUT_FIELDS:
        assert torch.equal(getattr(fixed, name)[mask], getattr(dense, name)[mask]), name
    after = [k.launches for k in (ss.sort_kernel, ss.frames_sorted_kernel,
                                  ss.unsort_kernel, sf.frames_kernel)]
    assert after == before
    with pytest.raises(ValueError, match="together"):
        sf.frames_kernel(veh, et._straight, et.idm_params, et.dt, 1, mask=mask)


def test_library_path_hashes_the_included_headers(tmp_path, monkeypatch):
    """A kernel's cached library is keyed on the ``csrc/`` headers it
    includes: an edit to the shared header rebuilds both frame kernels and
    leaves the sort kernel, which does not include it, as it was."""
    src = tmp_path / "csrc"
    src.mkdir()
    for path in _build.SOURCE_DIR.iterdir():
        (src / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "SOURCE_DIR", src)
    names = ("straight_frames", "straight_frames_sorted", "straight_sort")
    before = {n: _build.library_path(n) for n in names}
    with open(src / "straight_common.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.library_path(n) for n in names}
    assert after["straight_frames"] != before["straight_frames"]
    assert after["straight_frames_sorted"] != before["straight_frames_sorted"]
    assert after["straight_sort"] == before["straight_sort"]
