"""Linear-family NPCs (LinearVehicle, AggressiveVehicle, DefensiveVehicle)
in the port against the JAX package, on the CPU.

The presets at reset, through the full and the compact autoreset; policy
steps of straight roads through the sorted path (K2a, K3, K2b, masked K1)
and the dense one (K1), and of the general path (K4 at roundabout-v0, K5 at
intersection-v0), each on CPU tensors running the kernels' plain versions,
against the JAX package's XLA frames; two hand-built scenes for the rule
that the acceleration law and its parameters are the deciding row's; the
unclipped target speed of the linear law; intersection-v0's warm-up and
spawns under a preset; intersection-v0 under a ContinuousAction (K5's
raw-control branch); and the JAX package's own difference between its
Pallas kernel, which takes the linear law only when the config names a
preset, and its XLA frame, which decides per row.

Tolerances are the port's: discrete fields exact; on straight roads pos
2e-4 m over 3 policy steps and the other continuous fields 1e-4 of their
magnitude; on the general path pos, speed and heading 5e-4; obs and reward
1e-5.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import highwayenv_tpu as hj
import highwayenv_tpu_torch as ht
from highwayenv_tpu.ops import straight_fast as j_straight_fast
from highwayenv_tpu.ops.straight_pallas_bm import pallas_simulate_bm
from highwayenv_tpu.vehicle.state import VehicleState as JaxVehicleState
from highwayenv_tpu_torch.bridge import from_numpy_state, to_numpy_state
from highwayenv_tpu_torch.envs.base import NPC_PRESETS, EnvState
from highwayenv_tpu_torch.envs.intersection import SpawnDraws
from highwayenv_tpu_torch.ops import general_frames, straight_frames, straight_sorted
from highwayenv_tpu_torch.vehicle.controller import MAX_STEERING_ANGLE
from highwayenv_tpu_torch.vehicle.state import (
    KIND_EGO,
    KIND_IDM,
    KIND_LINEAR,
    KIND_PAD,
    VehicleState,
)

torch.set_num_threads(1)

B = 8
STEPS = 3
PRESETS = ("LinearVehicle", "AggressiveVehicle", "DefensiveVehicle")
DISCRETE = ("lane", "target_lane", "crashed", "hit", "impact_pending", "speed_index",
            "kind")
CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer", "impact",
              "steering", "accel")
GENERAL_ATOL = {"pos": 5e-4, "speed": 5e-4, "heading": 5e-4, "target_speed": 5e-4}
HEAD_ATOL = 1e-5


def npc(name: str) -> dict:
    return {"other_vehicles_type": f"highway_env.vehicle.behavior.{name}"}


def numpy_state(states) -> dict:
    """A JAX EnvState -> the bridge's numpy dict."""
    return {
        "vehicles": {f.name: np.asarray(getattr(states.vehicles, f.name))
                     for f in dataclasses.fields(VehicleState)},
        "time": np.asarray(states.time),
        "steps": np.asarray(states.steps),
    }


def jax_vehicles(veh: VehicleState) -> JaxVehicleState:
    """A port VehicleState -> the JAX one, batched."""
    return JaxVehicleState(**{f.name: jnp.asarray(getattr(veh, f.name).numpy())
                              for f in dataclasses.fields(VehicleState)})


def port_state(states) -> EnvState:
    return from_numpy_state(numpy_state(states))


def assert_state(port, ref, where, atol=None, clip_ego_steering=False, rows=None):
    """Discrete fields exact, continuous ones within ``atol`` (default: pos
    2e-4, the rest 1e-4 of the field's magnitude), over ``rows``."""
    rows = slice(None) if rows is None else rows
    atol = atol or {"pos": 2e-4}
    for name in DISCRETE:
        np.testing.assert_array_equal(getattr(port, name).numpy()[rows],
                                      np.asarray(getattr(ref, name))[rows],
                                      err_msg=f"{where}: {name}")
    for name in CONTINUOUS:
        a = getattr(port, name).numpy().astype(np.float64)[rows]
        b = np.asarray(getattr(ref, name)).astype(np.float64)[rows]
        if name == "steering" and clip_ego_steering:
            # the XLA straight frame stores the ego's P-cascade steering
            # unclipped (highwayenv_tpu/ops/straight_fast.py:436-438)
            b = np.clip(b, -MAX_STEERING_ANGLE, MAX_STEERING_ANGLE)
        tol = atol.get(name, 1e-4 * max(1.0, float(np.abs(b).max(initial=0.0))))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=f"{where}: {name}")


def assert_preset_fields(port: VehicleState, ref: JaxVehicleState, where):
    for name in ("kind", "accel_params", "mobil_gain", "steer_params"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=f"{where}: {name}")


# --------------------------------------------------------------------------- #
# the presets at reset
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("preset", PRESETS)
def test_presets_at_reset_match_jax(preset):
    """The preset env's reset is the IDM env's scene with JAX's
    ``_apply_npc_type`` on it, and so are the rows of both autoresets."""
    env_id = "highway-fast-v0"
    et = ht.make(env_id, npc(preset), device="cpu")
    e_idm = ht.make(env_id, device="cpu")
    ej = hj.make(env_id, npc(preset))
    apply_j = jax.vmap(ej._apply_npc_type)

    _, st = et.reset(B, et.generator(0))
    _, st_idm = e_idm.reset(B, e_idm.generator(0))
    assert_preset_fields(st.vehicles, apply_j(jax_vehicles(st_idm.vehicles)), "reset")
    assert bool((st.vehicles.kind == KIND_LINEAR).any())
    assert not bool((st.vehicles.kind == KIND_IDM).any())
    for f in dataclasses.fields(VehicleState):
        if f.name not in ("kind", "accel_params", "mobil_gain"):
            assert torch.equal(getattr(st.vehicles, f.name),
                               getattr(st_idm.vehicles, f.name)), f.name

    # rows 0, 2, 4, 6 end this step; their new scenes come from the step's
    # generator, the IDM env's from a clone of it
    crashed = st.vehicles.crashed.clone()
    crashed[::2, 0] = True
    st = st.replace(vehicles=st.vehicles.replace(crashed=crashed))
    acts = torch.ones(B, dtype=torch.int32)
    fresh = e_idm._reset_state(B, e_idm.generator(5)).vehicles
    ref = apply_j(jax_vehicles(fresh))
    done = np.arange(B) % 2 == 0
    for slots in (None, 2):
        out = et.step_autoreset_batched(st, acts, et.generator(5), reset_slots=slots)
        veh = out[1].vehicles
        for name in ("kind", "accel_params", "mobil_gain", "steer_params"):
            np.testing.assert_array_equal(getattr(veh, name).numpy()[done],
                                          np.asarray(getattr(ref, name))[done],
                                          err_msg=f"reset_slots={slots}: {name}")
        assert (out[3] | out[4]).numpy()[done].all()


def test_bridge_carries_the_linear_parameters_bitwise():
    """accel_params, steer_params and mobil_gain of a preset reset go across
    and back bit for bit."""
    ej = hj.make("highway-fast-v0", npc("AggressiveVehicle"))
    _, states = jax.vmap(ej._reset)(jax.random.split(jax.random.PRNGKey(0), 4))
    d = numpy_state(states)
    back = to_numpy_state(from_numpy_state(d))["vehicles"]
    assert (d["vehicles"]["kind"] == KIND_LINEAR).any()
    for name in ("accel_params", "steer_params", "mobil_gain", "kind"):
        a, b = d["vehicles"][name], back[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("env_id", ["highway-fast-v0", "roundabout-v0"])
def test_linear_rows_need_the_env_flag(env_id):
    """A Linear row is never stepped by the kernels' IDM code: on an
    IDM-config env, whose frames call the kernels with ``linear=False``, a
    state with Linear rows raises (on the card the launch traps), until
    ``change_vehicles`` sets the env's flag; a preset env has it set."""
    et = ht.make(env_id, device="cpu")
    assert not et.linear_rows and ht.make(env_id, npc("LinearVehicle"), device="cpu").linear_rows
    _, st = ht.make(env_id, npc("DefensiveVehicle"), device="cpu").reset(4, et.generator(0))
    acts = torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="linear=False"):
        et.step_batched(st, acts, et.generator(1))
    from highwayenv_tpu_torch.envs import preprocessors

    _, st_idm = et.reset(4, et.generator(0))
    st_lin = preprocessors.change_vehicles(et, st_idm, "highway_env.vehicle.behavior.LinearVehicle")
    assert et.linear_rows
    et.step_batched(st_lin, acts, et.generator(1))
    et.step_batched(st, acts, et.generator(1))


def test_presets_are_the_jax_table():
    assert set(NPC_PRESETS) == set(hj.make("highway-v0")._NPC_PRESETS)
    for name, (params, gain) in hj.make("highway-v0")._NPC_PRESETS.items():
        np.testing.assert_array_equal(np.float32(NPC_PRESETS[name][0]), np.float32(params))
        assert NPC_PRESETS[name][1] == gain


# --------------------------------------------------------------------------- #
# straight roads: 3 policy steps of the sorted and the dense path
# --------------------------------------------------------------------------- #

_SETUP: dict = {}


def _straight_setup(env_id):
    """The JAX LinearVehicle env's jitted ``step_batched`` (its XLA frame
    decides the law per row, so it steps every preset's scene) and the JAX
    IDM env's reset batch; one compile each per env and test process."""
    if env_id not in _SETUP:
        ej = hj.make(env_id, npc("LinearVehicle"))
        e_idm = hj.make(env_id)
        keys = jax.random.split(jax.random.PRNGKey(3), B)
        _, states = jax.jit(jax.vmap(e_idm._reset))(keys)
        _SETUP[env_id] = (ej, states, jax.jit(ej.step_batched))
    return _SETUP[env_id]


def _preset_scene(env_id, preset):
    ej, states, step = _straight_setup(env_id)
    veh = jax.vmap(hj.make(env_id, npc(preset))._apply_npc_type)(states.vehicles)
    return states.replace(vehicles=veh), step


def _step_both(et, sj, step, seed):
    """Yield (t, port outputs, JAX outputs) over STEPS ``step_batched``
    calls from the same scene and actions."""
    st = port_state(sj)
    rng = np.random.default_rng(seed)
    gen = et.generator(0)
    for t in range(STEPS):
        acts = rng.integers(0, et.action_type.n, B).astype(np.int32)
        out_t = et.step_batched(st, torch.from_numpy(acts), gen)
        out_j = step(sj, jnp.asarray(acts))
        st, sj = out_t[1], out_j[1]
        yield t, out_t, out_j


def _assert_step(out_t, out_j, where, **kw):
    obs_t, st_t, rew_t, term_t, trunc_t, _ = out_t
    obs_j, st_j, rew_j, term_j, trunc_j, _ = out_j
    np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j), err_msg=where)
    np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j), err_msg=where)
    np.testing.assert_allclose(rew_t.numpy(), np.asarray(rew_j), rtol=0, atol=HEAD_ATOL,
                               err_msg=f"{where}: reward")
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), rtol=0, atol=HEAD_ATOL,
                               err_msg=f"{where}: obs")
    assert_state(st_t.vehicles, st_j.vehicles, where, **kw)


@pytest.mark.parametrize("sorted_frames", [True, False], ids=["sorted", "dense"])
@pytest.mark.parametrize("preset", ["LinearVehicle", "AggressiveVehicle"])
@pytest.mark.parametrize("env_id", ["highway-fast-v0", "highway-v0"])
def test_straight_steps_match_jax(env_id, preset, sorted_frames):
    sj, step = _preset_scene(env_id, preset)
    et = ht.make(env_id, npc(preset), device="cpu", sorted_frames=sorted_frames)
    k = (straight_frames.frames_kernel, straight_sorted.sort_kernel,
         straight_sorted.frames_sorted_kernel, straight_sorted.unsort_kernel)
    before = [w.launches for w in k]
    lane_changes = 0
    for t, out_t, out_j in _step_both(et, sj, step, seed=11):
        _assert_step(out_t, out_j, f"{env_id} {preset} step {t}", clip_ego_steering=True)
        veh = out_t[1].vehicles
        lane_changes += int((veh.target_lane != veh.lane).sum())
    assert [w.launches for w in k] == before  # CPU tensors: the plain versions
    assert lane_changes > 0  # the Linear NPCs decide lane changes


# --------------------------------------------------------------------------- #
# the general path: roundabout-v0 (K4) and intersection-v0 (K5)
# --------------------------------------------------------------------------- #

_GENERAL: dict = {}
GENERAL_CASES = {"roundabout-v0": "AggressiveVehicle", "intersection-v0": "DefensiveVehicle"}


def _general_setup(env_id, config):
    """A JAX reset batch of the preset env and one jitted JAX policy step
    of its XLA frames (``jax.vmap(env._simulate)``), per env and process."""
    key = (env_id, repr(config))
    if key not in _GENERAL:
        ej = hj.make(env_id, config)
        keys = jax.random.split(jax.random.PRNGKey(5), B)
        _, states = jax.jit(jax.vmap(ej._reset))(keys)

        def sim(st, acts):
            return jax.vmap(ej._simulate)(st, jax.vmap(ej._action_to_slots)(acts))

        _GENERAL[key] = (ej, states, jax.jit(sim))
    return _GENERAL[key]


def _general_steps(env_id, config, acts_of):
    """3 policy steps of the port's general frames (K4 or K5's plain
    version, with the envs' frame counters on a regulated road) and the
    JAX XLA frames from the same states; yields (t, port, JAX) vehicles."""
    ej, sj, sim = _general_setup(env_id, config)
    et = ht.make(env_id, config, device="cpu")
    rng = np.random.default_rng(4)
    steps = np.asarray(sj.steps)
    if et.regulated:  # rows at all 7 tick phases
        steps = steps + np.arange(B, dtype=np.int32) * et.frames_per_step
    for t in range(STEPS):
        acts = acts_of(rng, et)
        sj = sj.replace(steps=jnp.asarray(steps))
        veh_t = port_state(sj).vehicles
        kw = {"steps0": torch.from_numpy(steps)} if et.regulated else {}
        out_t = general_frames.simulate_general(
            et, veh_t, et._action_to_slots(torch.from_numpy(acts)), et.frames_per_step, **kw
        )
        sj = sim(sj, jnp.asarray(acts))
        yield t, out_t, sj.vehicles
        steps = steps + et.frames_per_step


def _moving_actions(rng, et):
    """Random meta-actions but SLOWER: the egos stay off a standstill, where
    the steering law's division by the speed grows a one-ulp libm
    difference about 4x a frame (tests/test_torch_general.py holds that
    regime frame by frame)."""
    at = et.action_type
    choices = [k for k, name in at.actions.items() if name != "SLOWER"]
    return rng.choice(choices, B).astype(np.int32)


@pytest.mark.parametrize("env_id", GENERAL_CASES)
def test_general_steps_match_jax(env_id):
    preset = GENERAL_CASES[env_id]
    k4, k5 = general_frames.frames_general_kernel, general_frames.frames_regulated_kernel
    before = (k4.launches, k5.launches)
    linear_rows = 0
    for t, veh_t, veh_j in _general_steps(env_id, npc(preset), _moving_actions):
        assert_state(veh_t, veh_j, f"{env_id} {preset} step {t}", atol=GENERAL_ATOL)
        linear_rows += int((veh_t.kind == KIND_LINEAR).sum())
    assert (k4.launches, k5.launches) == before
    assert linear_rows > 0


def test_intersection_continuous_steps_match_jax():
    """intersection-v0 under a non-dynamical ContinuousAction: the JAX
    package steps it on its XLA frame and the port on K5's raw-control
    branch (its plain version here): the ego keeps the stored controls."""
    config = {"action": {"type": "ContinuousAction"}}
    for t, veh_t, veh_j in _general_steps(
        "intersection-v0", config,
        lambda rng, et: rng.uniform(-1.2, 1.2, (B, 2)).astype(np.float32),
    ):
        assert_state(veh_t, veh_j, f"intersection-v0 continuous step {t}",
                     atol=GENERAL_ATOL)
    et = ht.make("intersection-v0", config, device="cpu")
    assert et.action_type.stores_raw_controls and et.regulated


def test_intersection_continuous_reset_matches_jax():
    """The reset under a ContinuousAction: the warm-up with zero float
    actions is the meta-action env's warm-up (held to JAX in
    test_torch_regulated.py), and the ego gets no target speed, speed index
    or route, as in the JAX package's reset."""
    config = {"action": {"type": "ContinuousAction"}}
    _, sj, _ = _general_setup("intersection-v0", config)
    et = ht.make("intersection-v0", config, device="cpu")
    e_meta = ht.make("intersection-v0", device="cpu")
    draws = et._reset_draws(B, et.generator(1))
    spawn = et._place_initial(SpawnDraws(*(draws[k] for k in SpawnDraws._fields)))
    warm_t, warm_m = et._warm_up(spawn), e_meta._warm_up(spawn)
    for f in dataclasses.fields(VehicleState):
        assert torch.equal(getattr(warm_t, f.name), getattr(warm_m, f.name)), f.name
    obs, st = et.reset(B, et.generator(1))
    v, ego = st.vehicles, et.ego_slots[0]
    ref = numpy_state(sj)["vehicles"]
    for name in ("kind", "speed", "target_speed", "speed_index", "route_base", "route_n",
                 "route_id", "route_len", "route_ptr"):
        np.testing.assert_array_equal(getattr(v, name).numpy()[:, ego], ref[name][:, ego],
                                      err_msg=name)
    assert (v.kind[:, ego] == KIND_EGO).all() and np.isfinite(obs.numpy()).all()


# --------------------------------------------------------------------------- #
# intersection-v0: the warm-up before the preset, spawns as IDM
# --------------------------------------------------------------------------- #


def test_intersection_warm_up_is_idm_and_spawns_are_idm(monkeypatch):
    """Under a preset the reset's warm-up launch sees IDM rows only and the
    episode's spawns place IDM vehicles, in the port and in the JAX
    package; the placed scene's NPCs are Linear."""
    config = npc("DefensiveVehicle")
    et = ht.make("intersection-v0", config, device="cpu")
    seen = []
    real = general_frames.simulate_general

    def spy(env, veh, *a, **kw):
        seen.append(veh.kind.clone())
        return real(env, veh, *a, **kw)

    monkeypatch.setattr(general_frames, "simulate_general", spy)
    gen = et.generator(2)
    _, st = et.reset(B, gen)
    monkeypatch.setattr(general_frames, "simulate_general", real)
    (warm_kinds,) = seen
    assert set(warm_kinds.unique().tolist()) <= {KIND_PAD, KIND_IDM}
    assert bool((warm_kinds == KIND_IDM).any())
    npcs = st.vehicles.kind[:, : et._n_npc]
    assert set(npcs.unique().tolist()) <= {KIND_PAD, KIND_LINEAR}
    # a spawn into a freed slot: an IDM vehicle, and the slot keeps the
    # parameters of the Linear NPC that held it
    veh = st.vehicles.replace(kind=torch.where(
        torch.arange(et.num_slots) == 0, KIND_PAD, st.vehicles.kind))
    draws = et.spawn_draws((B,), gen)._replace(accept=torch.zeros(B))
    out = et.place_spawn(veh, 0, draws, 0.0, spawn_probability=1.0)
    placed = out.kind[:, 0] != KIND_PAD
    assert bool(placed.any())
    assert (out.kind[placed, 0] == KIND_IDM).all()
    assert torch.equal(out.mobil_gain, veh.mobil_gain)

    ej, sj, _ = _general_setup("intersection-v0", config)
    veh_j, _ = ej._spawn_initial(jax.random.PRNGKey(0))
    assert set(np.unique(np.asarray(veh_j.kind)).tolist()) <= {KIND_PAD, KIND_IDM}
    spawned = ej._spawn_into_slot(
        veh_j.replace(kind=veh_j.kind.at[0].set(KIND_PAD)), 0, jax.random.PRNGKey(1),
        jnp.float32(0.0), spawn_probability=1.0)
    assert int(spawned.kind[0]) in (KIND_IDM, KIND_PAD)
    kinds = np.asarray(sj.vehicles.kind)[:, : et._n_npc]
    assert set(np.unique(kinds).tolist()) <= {KIND_PAD, KIND_LINEAR}


# --------------------------------------------------------------------------- #
# hand-built straight scenes: the decider's law, the raw target speed
# --------------------------------------------------------------------------- #


def _hand_scene(et, rows):
    """A highway-fast-v0 state of B envs with the ego far behind and the
    rows ``rows`` ((slot, x, lane, speed, kind) per slot, a callable of the
    env index b) placed on the road; the deciders' MOBIL timers are due."""
    V = et.num_slots
    _, st = et.reset(B, et.generator(0))
    v = {f.name: getattr(st.vehicles, f.name).numpy().copy()
         for f in dataclasses.fields(VehicleState)}
    offsets = np.asarray(et._straight.offsets)
    v["kind"][:, 1:] = KIND_PAD
    v["pos"][:, 0] = (0.0, offsets[0])
    v["lane"][:, 0] = v["target_lane"][:, 0] = 0
    v["crashed"][:] = False
    for b in range(B):
        for slot, x, lane, speed, kind in rows(b):
            v["pos"][b, slot] = (x, offsets[lane])
            v["heading"][b, slot] = 0.0
            v["lane"][b, slot] = v["target_lane"][b, slot] = lane
            v["speed"][b, slot] = speed
            v["target_speed"][b, slot] = 30.0
            v["kind"][b, slot] = kind
            v["timer"][b, slot] = 2.0
            v["mobil_gain"][b, slot] = 0.2
            v["accel_params"][b, slot] = NPC_PRESETS["AggressiveVehicle"][0]
    assert V > 3
    return VehicleState(**{k: torch.from_numpy(a) for k, a in v.items()})


def _one_frame(et, ej, veh):
    """One frame of the port's dense plain frame and of the JAX XLA
    straight frame (per env), from the same state."""
    out_t = straight_frames.frames_plain(veh, et._straight, et.idm_params, et.dt, 1)
    frame = jax.vmap(lambda v, a: j_straight_fast.straight_frame(
        ej, ej._straight, v, a, jnp.bool_(False)))
    out_j = frame(jax_vehicles(veh), jnp.ones((B, et.num_slots), jnp.int32))
    return out_t, out_j


@pytest.mark.parametrize("decider", ["linear_decider", "idm_decider"])
def test_the_law_and_its_parameters_are_the_deciders(decider):
    """Slot 1 on lane 0, 12 m behind a slow front (slot 2), weighs lane 1,
    where slot 3 would become its new follower, 30 + 6 b m behind in env b.
    The decider is Linear (AggressiveVehicle's parameters) and the follower
    IDM, or the other way round.  The braking imposed on the follower is
    the decider's law with the decider's parameters: IDM allows the change
    from 44 m, the linear law from 68 m.  The port's target lanes and
    accelerations equal JAX's, and the outcome differs from the same scene
    with the two kinds swapped, which a law taken from the neighbour's kind
    or parameters would not tell apart."""
    et = ht.make("highway-fast-v0", device="cpu")
    ej = hj.make("highway-fast-v0")
    lin, idm = KIND_LINEAR, KIND_IDM
    kinds = (lin, idm) if decider == "linear_decider" else (idm, lin)

    def rows(kd, kf):
        return lambda b: [(1, 100.0, 0, 25.0, kd), (2, 112.0, 0, 10.0, kf),
                          (3, 100.0 - (30.0 + 6.0 * b), 1, 25.0, kf)]

    outcomes = []
    for kd, kf in (kinds, kinds[::-1]):
        veh = _hand_scene(et, rows(kd, kf))
        out_t, out_j = _one_frame(et, ej, veh)
        np.testing.assert_array_equal(out_t.target_lane.numpy(),
                                      np.asarray(out_j.target_lane))
        np.testing.assert_allclose(out_t.accel.numpy(), np.asarray(out_j.accel),
                                   rtol=0, atol=1e-4)
        changed = out_t.target_lane[:, 1].tolist()
        assert 0 in changed and 1 in changed  # the gap decides within the batch
        outcomes.append(changed)
    assert outcomes[0] != outcomes[1]


def test_linear_law_takes_the_unclipped_target_speed():
    """A Linear row with target speed 40 on a road limited to 30: its free
    acceleration is theta_0 (40 - v), where IDM clips the target to 30."""
    et = ht.make("highway-fast-v0", device="cpu")
    ej = hj.make("highway-fast-v0")
    veh = _hand_scene(et, lambda b: [(1, 100.0 + 50 * b, 1, 20.0 + b, KIND_LINEAR)])
    veh = veh.replace(target_speed=torch.where(veh.kind == KIND_LINEAR, 40.0,
                                               veh.target_speed))
    assert et._straight.speed_limit == 30.0
    out_t, out_j = _one_frame(et, ej, veh)
    th0 = np.float32(NPC_PRESETS["AggressiveVehicle"][0][0])
    expect = th0 * (np.float32(40.0) - veh.speed[:, 1].numpy())
    np.testing.assert_allclose(np.asarray(out_j.accel)[:, 1], expect, rtol=1e-6)
    np.testing.assert_allclose(out_t.accel[:, 1].numpy(), expect, rtol=1e-6)


# --------------------------------------------------------------------------- #
# the JAX package's Pallas elision against its XLA frame's per-row rule
# --------------------------------------------------------------------------- #


def test_jax_pallas_elides_the_linear_law_on_an_idm_config():
    """Linear rows on an IDM-config env: the JAX Pallas kernel (built with
    ``has_linear`` off, interpret mode, 1 frame) steps them as IDM rows,
    the JAX XLA frame by the linear law, and the port as the XLA frame."""
    env_id = "highway-fast-v0"
    ej = hj.make(env_id)
    et = ht.make(env_id, device="cpu")
    _, states = jax.jit(jax.vmap(ej._reset))(jax.random.split(jax.random.PRNGKey(3), B))
    lin = jax.vmap(hj.make(env_id, npc("AggressiveVehicle"))._apply_npc_type)(states.vehicles)
    as_idm = lin.replace(kind=states.vehicles.kind)
    sa = jnp.ones((B, et.num_slots), jnp.int32)

    pal = jax.jit(lambda v: pallas_simulate_bm(ej, v, sa, 1, block=B, interpret=True))
    frame = jax.jit(jax.vmap(lambda v: j_straight_fast.straight_frame(
        ej, ej._straight, v, sa[0], jnp.bool_(True))))
    pal_lin, pal_idm = pal(lin), pal(as_idm)
    xla_lin = frame(lin)
    np.testing.assert_array_equal(np.asarray(pal_lin.accel), np.asarray(pal_idm.accel))
    npc_rows = np.asarray(lin.kind) == KIND_LINEAR
    assert not np.allclose(np.asarray(xla_lin.accel)[npc_rows],
                           np.asarray(pal_lin.accel)[npc_rows], atol=1e-3)
    veh_t = straight_frames.frames_plain(
        et.action_type.apply(et.geo, port_state(states.replace(vehicles=lin)).vehicles,
                             torch.from_numpy(np.asarray(lin.kind) == KIND_EGO),
                             torch.ones((B, et.num_slots), dtype=torch.int32)),
        et._straight, et.idm_params, et.dt, 1)
    np.testing.assert_allclose(veh_t.accel.numpy(), np.asarray(xla_lin.accel), rtol=0,
                               atol=1e-4)
