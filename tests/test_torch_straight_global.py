"""The global layout of the straight kernels, on the CPU: which scenes take it, and their steps against JAX.

A straight scene one block cannot hold (over ``MAX_SLOTS`` = 1024 slots,
one thread a slot, or a block of K1 or K3 over the H100's 227 KB of shared
memory, ``launch_smem``) takes the global wrappers of K1 and K3
(``csrc/straight_frames_global.cu``, ``straight_frames_sorted_global.cu``:
one env a cluster of blocks with its rows in a slab of global memory, up
to ``STRAIGHT_GLOBAL_SLOTS`` = 8192 slots), which ``frames_kernel_for``
and ``frames_sorted_kernel_for`` pick; K2a and K2b (``straight_sort.cu``,
one block an env, each thread looping over its slots) take every scene
up to the cap.  Here

  - ``straight_layout_for`` keeps every registered straight id and every
    straight scene chip_smoke.py drove before this layout (17 lanes,
    V = 1024 among them) in the block layout, and puts V = 1025, 2048 and
    8192 and 32 lanes at 1024 slots in the global one; ``make`` takes 8191
    vehicles and refuses 8192, naming the cap;
  - the cap, the threads a block (``global_threads``) and the slab's words
    an env (``global_words``) are named;
  - on CPU tensors the global wrappers, and the block wrappers on a global
    scene, run their plain versions and count no launch; on the card a
    block wrapper refuses a global scene;
  - ``step_batched`` of the port (its plain versions on the CPU, what the
    global kernels are held to bit for bit on the card by chip_smoke.py)
    against the JAX package's (its XLA frames) from a port reset batch, the
    state carried across by ``bridge.py``: highway-v0 with 1100 vehicles
    (B=2, 2 steps, each from the JAX state of the step before) and with 32
    lanes and 1023 vehicles (B=1, 1 step).  Tolerances those of
    ``tests/test_torch_sorted.py``: discrete fields exact, pos 2e-4 m, the
    other continuous fields 1e-4 of their magnitude; obs and reward 1e-5.
    The road of 1100 vehicles runs to about 3.6 km, where one float32 ulp
    of a position is 2.44e-4 m: there a position is held to one ulp of its
    magnitude, the least two libms can differ by;
  - ``sort_plain`` against JAX ``build_sort_kernels`` in interpret mode at
    V = 1100, bit-exact, with exact ties and -0.0 against 0.0.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import highwayenv_tpu as hj
from highwayenv_tpu.envs.base import EnvState as JaxEnvState
from highwayenv_tpu.ops.straight_pallas_bm import BM_FIELDS, build_sort_kernels, pack_bm
from highwayenv_tpu.vehicle.state import VehicleState as JaxVehicleState
import highwayenv_tpu_torch as ht
from highwayenv_tpu_torch.bridge import from_numpy_state, to_numpy_state
from highwayenv_tpu_torch.ops import straight_frames as sf
from highwayenv_tpu_torch.ops import straight_sorted as ss
from highwayenv_tpu_torch.parallel.rollout import random_actions
from highwayenv_tpu_torch.vehicle.state import VehicleState

torch.set_num_threads(1)

DISCRETE = ("lane", "target_lane", "crashed", "impact_pending", "kind")
CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer", "impact", "steering",
              "accel")
NPC = "highway_env.vehicle.behavior."

#: the straight scenes chip_smoke.py drove on the block kernels before the
#: global layout: (env id, config)
BLOCK_SCENES = [
    ("highway-fast-v0", None),
    *[("highway-v0", {"vehicles_count": n}) for n in (31, 32, 63, 100)],
    ("highway-v0", {"action": {"type": "ContinuousAction"}}),
    ("highway-v0", {"other_vehicles_type": NPC + "LinearVehicle"}),
    ("highway-v0", {"other_vehicles_type": NPC + "AggressiveVehicle"}),
    ("highway-v0", {"controlled_vehicles": 2}),
    ("highway-v0", {"lanes_count": 17}),
    ("highway-v0", {"vehicles_count": 1023}),
    ("highway-v0", {"observation": {"type": "LidarObservation"}}),
]

#: the scenes one block cannot hold: (env id, config, V, L)
GLOBAL_SCENES = [
    ("highway-fast-v0", {"vehicles_count": 1024}, 1025, 3),
    ("highway-v0", {"vehicles_count": 2047}, 2048, 4),
    ("highway-v0", {"vehicles_count": 8191}, 8192, 4),
    ("highway-v0", {"lanes_count": 32, "vehicles_count": 1023}, 1024, 32),
    ("highway-v0", {"controlled_vehicles": 4, "vehicles_count": 1200}, 1204, 4),
]


def _layout(env):
    return sf.straight_layout_for(env.num_slots, len(env._straight.offsets))


def test_block_scenes_keep_the_block_layout():
    """Every registered straight id and every straight scene the block
    kernels took before keeps them: its layout "block", its slots within
    one block, no limit broken."""
    seen = 0
    for env_id in ht.registered_ids():
        env = ht.make(env_id, device="cpu")
        if env._straight is None:
            continue
        assert _layout(env) == "block", env_id
        seen += 1
    assert seen >= 2
    for env_id, config in BLOCK_SCENES:
        env = ht.make(env_id, config, device="cpu")
        V, L = env.num_slots, len(env._straight.offsets)
        assert _layout(env) == "block", (env_id, config)
        assert V <= sf.MAX_SLOTS and max(sf.launch_smem(V, L)) <= sf.SMEM_LIMIT
        assert sf.kernel_limits(V, env._straight) == []
        assert sf.frames_kernel_for(V, L) is sf.frames_kernel
        assert ss.frames_sorted_kernel_for(V, L) is ss.frames_sorted_kernel


@pytest.mark.parametrize("env_id,config,V,L", GLOBAL_SCENES,
                         ids=["fast-1025-slots", "2048-slots", "8192-slots", "32-lanes",
                              "4-egos"])
def test_scene_past_a_block_takes_the_global_layout(env_id, config, V, L):
    env = ht.make(env_id, config, device="cpu")
    assert (env.num_slots, len(env._straight.offsets)) == (V, L)
    assert _layout(env) == "global"
    assert sf.kernel_limits(V, env._straight) == []
    assert sf.frames_kernel_for(V, L) is sf.frames_global_kernel
    assert ss.frames_sorted_kernel_for(V, L) is ss.frames_sorted_global_kernel
    blocks, threads = sf.global_blocks(V), sf.global_threads(V)
    assert 1 <= blocks <= 16 and threads % 32 == 0 and threads <= sf.GLOBAL_THREADS
    assert blocks * threads >= V > (blocks - 1) * sf.GLOBAL_THREADS


def test_global_slots_threads_and_words_are_named():
    cap = sf.STRAIGHT_GLOBAL_SLOTS
    assert cap == 8192 == 16 * sf.GLOBAL_THREADS
    assert [(sf.global_blocks(V), sf.global_threads(V)) for V in (1, 51, 1024, 1025, 2048,
                                                                  8192)] == [
        (1, 32), (1, 64), (2, 512), (3, 352), (4, 512), (16, 512)]
    # K1: the rows, a word of pre-check bits per warp per thread and the
    # ballot words; K3: the rows, the band's s, the far-band winners, the
    # pre-check bits, the ballot words, the warp maxima and two flag words a
    # block; a block's launch_smem without the lane offsets, where one block
    # holds the slots
    k1, k3 = sf.global_words(1024, 4)
    smem1, smem3 = sf.launch_smem(1024, 4)
    assert 4 * k1 == smem1 - 4 * 4 and 4 * k3 == smem3 - 4 * 4 + 4 * 2 * 2
    assert sf.global_words(8192, 4) == (2280448, 241184)
    assert all(w % 4 == 0 for V in (33, 1100, 8191) for w in sf.global_words(V, 5))
    # only the slots past the cap are a limit, whatever the lanes
    fs = ht.make("highway-v0", {"lanes_count": 64}, device="cpu")._straight
    assert sf.kernel_limits(cap, fs) == []
    assert sf.kernel_limits(cap + 1, fs) == [f"{cap + 1} slots > {cap}"]
    ht.make("highway-fast-v0", {"vehicles_count": cap - 1}, device="cpu")
    with pytest.raises(NotImplementedError, match=f"{cap + 1} slots > {cap}.*not ported"):
        ht.make("highway-fast-v0", {"vehicles_count": cap}, device="cpu")


def test_wrappers_run_the_plain_versions_on_the_cpu():
    """The global wrappers, and the block wrappers on a global scene, run
    their plain versions on CPU tensors and count no launch, as K2a and K2b
    do; a block wrapper refuses a global scene on the card (``check_layout``);
    the slab's words and the cluster question ask a global wrapper only."""
    env = ht.make("highway-fast-v0", {"lanes_count": 32, "vehicles_count": 200},
                  device="cpu")
    env2 = ht.make("highway-fast-v0", {"vehicles_count": 1100}, device="cpu")
    fs, p, dt = env._straight, env.idm_params, env.dt
    _, st = env.reset(1, env.generator(1))
    veh = st.vehicles
    pairs = {"K1": (sf.frames_kernel, sf.frames_global_kernel),
             "K2a": (ss.sort_kernel,),
             "K3": (ss.frames_sorted_kernel, ss.frames_sorted_global_kernel),
             "K2b": (ss.unsort_kernel,)}
    for name in ("K1", "K3"):
        block, glob = pairs[name]
        assert glob.glob and not block.glob and glob.source == block.source + "_global"
    assert ss.sort_kernel.source == ss.unsort_kernel.source == "straight_sort"
    counts = [k.launches for pair in pairs.values() for k in pair]
    srt_p, idx_p = ss.sort_plain(veh, fs)
    for k in pairs["K2a"]:
        srt, idx = k(veh, fs)
        assert torch.equal(idx, idx_p)
    band_p, flags_p = ss.frames_sorted_plain(srt_p, idx_p, fs, p, dt, 1)
    for k in pairs["K3"]:
        band, flags = k(srt_p, idx_p, fs, p, dt, 1)
        assert torch.equal(flags, flags_p) and torch.equal(band.pos, band_p.pos)
    back_p = ss.unsort_plain(band_p, idx_p, veh)
    for k in pairs["K2b"]:
        assert torch.equal(k(band_p, idx_p, veh).pos, back_p.pos)
    dense_p = sf.frames_plain(veh, fs, p, dt, 1)
    for k in pairs["K1"]:
        got = k(veh, fs, p, dt, 1)
        for f in dataclasses.fields(VehicleState):
            assert torch.equal(getattr(got, f.name), getattr(dense_p, f.name)), f.name
    assert [k.launches for pair in pairs.values() for k in pair] == counts
    # the sort of a 1101-slot scene: its plain version, no launch
    _, st2 = env2.reset(1, env2.generator(1))
    assert torch.equal(ss.sort_kernel(st2.vehicles, env2._straight)[1],
                       ss.sort_plain(st2.vehicles, env2._straight)[1])
    with pytest.raises(ValueError, match="global library"):
        sf.frames_kernel.global_words(2048, 4)
    with pytest.raises(ValueError, match="global library"):
        ss.frames_sorted_kernel.cluster_fit(16, 512, 4)
    with pytest.raises(ValueError, match="blocks of 32 to 512 threads"):
        sf.frames_global_kernel.cluster_fit(16, 1024, 4)
    # on the card a block wrapper refuses a global scene, a global one takes it
    for block, glob in (pairs["K1"], pairs["K3"]):
        with pytest.raises(ValueError, match="take the global layout"):
            sf.check_layout(block, 2048, 4)
        sf.check_layout(glob, 2048, 4)
        sf.check_layout(block, 1024, 4)


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


@pytest.mark.parametrize("config,batch,steps", [
    ({"vehicles_count": 1100}, 2, 2),
    ({"lanes_count": 32, "vehicles_count": 1023}, 1, 1),
], ids=["1101-slots", "32-lanes"])
def test_global_scene_steps_as_jax(config, batch, steps):
    et, ej = ht.make("highway-v0", config, device="cpu"), hj.make("highway-v0", config)
    assert ej.num_slots == et.num_slots and _layout(et) == "global"
    step_j = jax.jit(ej.step_batched)
    gen = et.generator(7)
    _, st = et.reset(batch, gen)
    sj = _jax_state(st, 7)
    for step in range(steps):
        acts = random_actions(et, batch, gen)
        obs_j, sj, rew_j, term_j, trunc_j, _ = step_j(sj, jnp.asarray(acts.numpy()))
        obs_t, st_t, rew_t, term_t, trunc_t, _ = et.step_batched(
            st, acts, et.generator(100 + step))
        where = f"highway-v0 {config} step {step}"
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
            a, b = getattr(vt, name).numpy(), np.asarray(getattr(vj, name))
            if name == "pos":
                # 2e-4 m, or one float32 ulp where the road is long enough
                # for an ulp to exceed it (past 2048 m: 1100 vehicles reach
                # ~3.6 km)
                tol = np.maximum(2e-4, np.spacing(np.abs(b).astype(np.float32)))
                bad = np.abs(a.astype(np.float64) - b) > tol
                assert not bad.any(), f"{where} pos: {int(bad.sum())} entries past {tol.max()}"
                continue
            tol = 1e-4 * max(1.0, float(np.abs(b).max()))
            _close(a, b, tol, f"{where} {name}")
        st = _port_state(sj)  # the next step from the JAX state


def test_sort_of_1100_slots_matches_jax():
    """Both packages rank by ascending s with ties in slot order at V =
    1100, past one slot a thread of the port's sort; the scene has exact
    ties, and -0.0 against 0.0, which the count rule ties."""
    config = {"vehicles_count": 1099}
    et, ej = ht.make("highway-fast-v0", config, device="cpu"), hj.make("highway-fast-v0",
                                                                         config)
    assert et.num_slots == 1100
    _, st = et.reset(8, et.generator(3))
    pos = st.vehicles.pos.clone()
    pos[:, 3] = torch.tensor([-0.0, -2.0])  # s = -0.0 ...
    pos[:, 2] = torch.tensor([0.0, 4.0])  # ... ties s = 0.0 in slot order
    pos[:, 700:704, 0] = pos[:, 699:700, 0]  # four more exact ties
    veh_t = st.vehicles.replace(pos=pos)
    veh_j = _jax_state(st.replace(vehicles=veh_t), 3).vehicles
    assert np.signbit(ss.s_coordinate(veh_t.pos, et._straight)[:, 3].numpy()).all()
    sort_fn, _ = build_sort_kernels(ej, block=8, interpret=True)
    srt_j = jax.jit(sort_fn)(pack_bm(veh_j))
    srt_t, idx_t = ss.sort_kernel(veh_t, et._straight)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(srt_j[-1]).T)
    assert (idx_t[:, 0] == 2).all() and (idx_t[:, 1] == 3).all()
    arrays = dict(zip(BM_FIELDS, srt_j))
    split = {"pos": ("px", "py"), "impact": ("impact_x", "impact_y"),
             "accel_params": ("accel_p0", "accel_p1", "accel_p2"),
             "steer_params": ("steer_p0", "steer_p1")}
    for name, _, _ in ss.SORT_FIELDS:
        want = (np.stack([np.asarray(arrays[n]).T for n in split[name]], axis=-1)
                if name in split else np.asarray(arrays[name]).T)
        np.testing.assert_array_equal(getattr(srt_t, name).numpy().astype(np.float32), want,
                                      err_msg=name)
