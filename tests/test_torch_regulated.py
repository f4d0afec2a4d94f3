"""The port's regulated road (intersection-v0's right-of-way pass) against the JAX package, on the CPU.

``road/regulation.py`` (the route-walk predictions and one regulation
pass) on built scenes; the regulated frames of ``ops/general_frames.py``
over 3 policy steps whose rows start at distinct tick phases; and the
reset's 45-frame warm-up.  On CPU tensors the K5 wrapper runs
``frames_general_plain`` with the envs' frame counters, the plain version of
the CUDA kernel (held to it on the card by chip_smoke.py); it is held to the
JAX XLA path: ``jax.vmap(env._simulate)`` with traced frame counters (the
JAX package's ``_simulate_regulated_frames``) and ``_run_frames_static`` for
the warm-up, as tests/test_general_pallas.py holds the JAX package's own
K5 to them.

Tolerances: the discrete fields and the yielding state (``is_yielding``,
``yield_timer``) exact, since one flipped yield moves a scene by metres;
pos, speed, heading and target speed 5e-4 (the JAX package's bound for its
own K5); the other continuous fields 1e-4 of their magnitude; predicted
positions and headings 1e-5.
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
from highwayenv_tpu.road import regulation as j_regulation
from highwayenv_tpu_torch.bridge import from_numpy_state
from highwayenv_tpu_torch.ops import general_frames
from highwayenv_tpu_torch.road import lane as t_lane
from highwayenv_tpu_torch.road import regulation as t_regulation
from highwayenv_tpu_torch.vehicle.state import KIND_IDM, KIND_PAD, VehicleState

torch.set_num_threads(1)

B = 8
STEPS = 3
DISCRETE = ("lane", "target_lane", "route_ptr", "crashed", "hit",
            "impact_pending", "speed_index", "is_yielding", "yield_timer")
CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer", "impact",
              "steering", "accel")
STEP_ATOL = {"pos": 5e-4, "speed": 5e-4, "heading": 5e-4, "target_speed": 5e-4}
PRED_ATOL = 1e-5
SCENES = ("reset", "converge_equal", "converge_unequal", "routes_end")

_SETUP: dict = {}


def _setup():
    """JAX env, port env, and per test process one jitted JAX reset split
    into its phases (spawns; the warm-up on the first W slots; the
    challenger and the ego) and one jitted JAX policy step of regulated
    frames with traced frame counters."""
    if not _SETUP:
        ej = hj.make("intersection-v0")
        et = ht.make("intersection-v0", device="cpu")
        W = et._warmup_slots

        def reset_parts(key):
            veh, keys = ej._spawn_initial(key)
            sub = jax.tree.map(lambda x: x[:W], veh)
            warm = ej._run_frames_static(
                sub, jnp.zeros((W,), jnp.int32), ej._warmup_frames, steps0=0
            )
            full = jax.tree.map(lambda s, f: jnp.concatenate([s, f[W:]]), warm, veh)
            return sub, warm, ej._finish_reset_vehicles(full, keys)

        def sim(st, acts):
            return jax.vmap(ej._simulate)(st, jax.vmap(ej._action_to_slots)(acts))

        def rules(veh):
            pos, heading = j_regulation.predict_route_positions(
                ej.geo, veh, t_regulation.TIMES
            )
            return j_regulation.enforce_road_rules(ej.geo, veh), pos, heading

        keys = jax.random.split(jax.random.PRNGKey(7), B)
        sub, warm, veh = jax.jit(jax.vmap(reset_parts))(keys)
        states = JaxEnvState(
            vehicles=veh, time=jnp.zeros((B,), jnp.float32),
            steps=jnp.full((B,), et._initial_steps, jnp.int32), key=keys,
        )
        _SETUP.update(ej=ej, et=et, sub=sub, warm=warm, states=states,
                      sim=jax.jit(sim), rules=jax.jit(jax.vmap(rules)))
    return _SETUP


def _numpy_vehicles(veh) -> dict:
    return {f.name: np.array(getattr(veh, f.name)) for f in dataclasses.fields(VehicleState)}


def _port_vehicles(veh) -> VehicleState:
    return from_numpy_state({"vehicles": _numpy_vehicles(veh), "time": np.zeros(1),
                             "steps": np.zeros(1)}).vehicles


def _scene(name):
    """The reset batch's vehicles, with vehicles placed for the named scene:
    two IDM vehicles converging on the box, one from each side, at equal
    priority (both vertical approaches, priority 1: one goes straight, one
    turns left across it) or at unequal priority (a vertical and a
    horizontal approach, both straight), at distances that vary by row, with
    a yielding vehicle in some rows; or vehicles at the end of their routes,
    past them and with none."""
    s = _setup()
    et = s["et"]
    v = _numpy_vehicles(s["states"].vehicles)
    rb, rn, rid, rlen = (x.numpy() for x in et._routes)

    def put(b, slot, lane_index, st, route, speed=8.0):
        g = et.net.global_lane_index(lane_index)
        lane = torch.tensor([g], dtype=torch.int32)
        s_t = torch.tensor([float(st)])
        pos = t_lane.position(et.geo, lane, s_t, torch.zeros(1))[0]
        v["pos"][b, slot] = pos.numpy()
        v["heading"][b, slot] = float(t_lane.heading_at(et.geo, lane, s_t)[0])
        v["lane"][b, slot] = v["target_lane"][b, slot] = g
        v["speed"][b, slot] = v["target_speed"][b, slot] = speed
        v["kind"][b, slot] = KIND_IDM
        v["crashed"][b, slot] = False
        v["is_yielding"][b, slot] = False
        v["yield_timer"][b, slot] = 0
        v["route_ptr"][b, slot] = 0
        c, dest = route  # the route from corner c to corner dest
        v["route_base"][b, slot] = rb[c, dest]
        v["route_n"][b, slot] = rn[c, dest]
        v["route_id"][b, slot] = rid[c, dest]
        v["route_len"][b, slot] = rlen[c, dest]

    if name == "reset":
        return v
    if name.startswith("converge"):
        v["kind"][:, 2:et._n_npc] = KIND_PAD  # the pair and the ego alone
    for b in range(B):
        if name == "converge_equal":
            put(b, 0, ("o0", "ir0", 0), 96.0 - 1.5 * b, (0, 2))
            put(b, 1, ("o2", "ir2", 0), 95.0 - 0.5 * b, (2, 3), speed=7.0)
            if b % 2:
                v["is_yielding"][b, 1] = True
                v["yield_timer"][b, 1] = b
        elif name == "converge_unequal":
            put(b, 0, ("o0", "ir0", 0), 96.0 - 1.5 * b, (0, 2))
            put(b, 1, ("o1", "ir1", 0), 94.0 - 0.5 * b, (1, 3), speed=9.0)
        elif name == "routes_end":
            # no route; past the route's end; on its last segment
            put(b, 0, ("o3", "ir3", 0), 90.0 + b, (3, 1))
            v["route_len"][b, 0] = 0
            put(b, 1, ("ir1", "il3", 0), 3.0 + b, (1, 3))
            v["route_ptr"][b, 1] = v["route_len"][b, 1]
            put(b, 2, ("il0", "o0", 0), 1.0 + b, (1, 0))
            v["route_ptr"][b, 2] = 2
            put(b, 3, ("o2", "ir2", 0), 97.0 - b, (2, 1))
        else:
            raise ValueError(name)
    return v


def _jax_vehicles(v: dict):
    return _setup()["states"].vehicles.replace(**{k: jnp.asarray(a) for k, a in v.items()})


def _assert_state(port, ref, where):
    for name in DISCRETE:
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=f"{where}: {name}")
    for name in CONTINUOUS:
        a = getattr(port, name).numpy().astype(np.float64)
        b = np.asarray(getattr(ref, name)).astype(np.float64)
        tol = STEP_ATOL.get(name, 1e-4 * max(1.0, float(np.abs(b).max())))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=f"{where}: {name}")


@pytest.mark.parametrize("scene", SCENES)
def test_road_rules_and_predictions_match_jax(scene):
    s = _setup()
    et = s["et"]
    v = _scene(scene)
    ruled_j, pos_j, heading_j = s["rules"](_jax_vehicles(v))
    veh_t = _port_vehicles(_jax_vehicles(v))
    pos_t, heading_t = t_regulation.predict_route_positions(et.geo, veh_t)
    live = v["kind"] != KIND_PAD
    np.testing.assert_allclose(pos_t.numpy()[live], np.asarray(pos_j)[live], rtol=0,
                               atol=PRED_ATOL)
    np.testing.assert_allclose(heading_t.numpy()[live], np.asarray(heading_j)[live],
                               rtol=0, atol=PRED_ATOL)
    ruled_t = t_regulation.enforce_road_rules(et.geo, veh_t)
    for name in ("target_speed", "is_yielding", "yield_timer"):
        np.testing.assert_array_equal(getattr(ruled_t, name).numpy(),
                                      np.asarray(getattr(ruled_j, name)), err_msg=name)
    for f in dataclasses.fields(VehicleState):
        if f.name not in ("target_speed", "is_yielding", "yield_timer"):
            assert torch.equal(getattr(ruled_t, f.name), getattr(veh_t, f.name)), f.name
    yields = ruled_t.is_yielding
    if scene.startswith("converge"):
        assert bool(yields[:, :2].any())  # the converging pair conflicts somewhere
    if scene == "converge_unequal":
        # the vertical approach (priority 1) yields to the horizontal one (3)
        assert not bool(yields[:, 1].any()) and bool(yields[:, 0].any())
    if scene == "converge_equal":
        # a yielder is released to the lane's limit, 10, or yields anew
        was = veh_t.is_yielding[:, 1]
        assert bool(was[1::2].all())
        again = yields[:, 1] & (ruled_t.yield_timer[:, 1] == 0)
        assert bool((again | (ruled_t.target_speed[:, 1] == 10.0))[was].all())


@pytest.mark.parametrize("scene", ["reset", "converge_equal"])
def test_regulated_frames_match_jax_at_mixed_phases(scene):
    """3 policy steps, each taken by both from the same JAX state; row b
    starts at frame counter 45 + 15 b, so the batch spans all 7 tick
    phases of the 7-frame period."""
    s = _setup()
    et, sim = s["et"], s["sim"]
    sj = s["states"].replace(vehicles=_jax_vehicles(_scene(scene)))
    steps = np.asarray(sj.steps) + np.arange(B, dtype=np.int32) * et.frames_per_step
    assert len(set(steps % et._regulation_period)) == 7
    rng = np.random.default_rng(4)
    yielded = 0
    for t in range(STEPS):
        acts = rng.integers(0, et.action_type.n, B).astype(np.int32)
        sj = sj.replace(steps=jnp.asarray(steps))
        veh_t = _port_vehicles(sj.vehicles)
        out_t = general_frames.simulate_general(
            et, veh_t, et._action_to_slots(torch.from_numpy(acts)), et.frames_per_step,
            steps0=torch.from_numpy(steps),
        )
        sj = sim(sj, jnp.asarray(acts))
        _assert_state(out_t, sj.vehicles, f"{scene} step {t}")
        yielded += int(out_t.is_yielding.sum())
        steps = steps + et.frames_per_step
    assert yielded > 0  # the scenes make vehicles yield


def test_reset_warm_up_matches_jax():
    """The 45 frames of the reset's warm-up from JAX's own spawns, on the
    first W = 16 slots from frame counter 0, against _run_frames_static."""
    s = _setup()
    et = s["et"]
    sub_t = _port_vehicles(s["sub"])
    W = et._warmup_slots
    assert W == 16 and sub_t.kind.shape == (B, W)
    out_t = general_frames.frames_regulated_kernel(
        sub_t, et._general, torch.zeros((B, W), dtype=torch.int32),
        et._warmup_frames, torch.zeros(B, dtype=torch.int32),
    )
    _assert_state(out_t, s["warm"], "warm-up")
    assert int(sub_t.kind.ne(KIND_PAD).sum()) >= 3 * B  # traffic to regulate


def test_tick_schedule_of_the_plain_frames(monkeypatch):
    """Frame i of an env is a tick when (steps0 + i + 1) % 7 == 0: the
    right-of-way pass runs on exactly those frames, each env on its own,
    and is computed only on frames where some env ticks."""
    s = _setup()
    et = s["et"]
    veh = _port_vehicles(_jax_vehicles(_scene("converge_equal")))
    passes, ticks = [], []
    real_rules, real_frame = t_regulation.enforce_road_rules, general_frames.frame_general_plain

    def rules(geo, state):
        passes.append(True)
        return real_rules(geo, state)

    def frame(veh, spec, table, sa, tick=None, **kw):
        ticks.append(tick.clone())
        return real_frame(veh, spec, table, sa, tick, **kw)

    monkeypatch.setattr(t_regulation, "enforce_road_rules", rules)
    monkeypatch.setattr(general_frames, "frame_general_plain", frame)
    # one env ticks on no frame of the first 5; the last counter is far
    # past 2^24, where a float32 counter would no longer be exact
    steps0 = torch.tensor([45, 46, 47, 48, 49, 50, 51, 10 ** 9], dtype=torch.int32)
    general_frames.frames_general_plain(
        veh, et._general, torch.zeros((B, et.num_slots), dtype=torch.int32), 15, steps0
    )
    tick = torch.stack(ticks)  # (frames, B)
    expect = (steps0[None, :].long() + torch.arange(15)[:, None] + 1) % 7 == 0
    assert torch.equal(tick, expect)
    assert len(passes) == int(expect.any(dim=1).sum())


def test_k5_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    s = _setup()
    et = s["et"]
    veh = _port_vehicles(s["states"].vehicles)
    sa = et._action_to_slots(torch.full((B,), 2, dtype=torch.int32))
    steps0 = torch.arange(B, dtype=torch.int32) * 15 + 45
    k4, k5 = general_frames.frames_general_kernel, general_frames.frames_regulated_kernel
    before = (k4.launches, k5.launches)
    out_k = k5(veh, et._general, sa, 3, steps0)
    out_p = general_frames.frames_general_plain(veh, et._general, sa, 3, steps0)
    assert (k4.launches, k5.launches) == before
    for name, _, _ in general_frames.OUT_FIELDS + general_frames.REG_FIELDS:
        assert torch.equal(getattr(out_k, name), getattr(out_p, name)), name
    # the frame counters go with K5 on a regulated road, and only there
    with pytest.raises(ValueError, match="steps0"):
        k4(veh, et._general, sa, 3, steps0)
    with pytest.raises(ValueError, match="steps0"):
        k5(veh, et._general, sa, 3)
    with pytest.raises(ValueError, match="steps0"):
        general_frames.frames_general_plain(veh, et._general, sa, 1)
    rb = ht.make("roundabout-v0", device="cpu")
    with pytest.raises(ValueError, match="steps0"):
        general_frames.frames_general_plain(veh, rb._general, sa, 1, steps0)


def test_kernel_lane_tables_carry_the_priority():
    et = _setup()["et"]
    _, li = general_frames.lane_tables(et.geo, "cpu")
    assert torch.equal(li[:, general_frames.LANE_I_PRIORITY], et.geo.priority)
    assert sorted(set(et.geo.priority.tolist())) == [0, 1, 2, 3]


def report():
    """Print the largest |port - JAX| of each continuous field over the
    3-step runs of test_regulated_frames_match_jax_at_mixed_phases and the
    warm-up, and the yielding slots each run ends a step with."""
    s = _setup()
    et, sim = s["et"], s["sim"]
    worst = {n: 0.0 for n in CONTINUOUS}

    def fold(port, ref):
        for n in CONTINUOUS:
            err = np.abs(getattr(port, n).numpy().astype(np.float64)
                         - np.asarray(getattr(ref, n), np.float64)).max()
            worst[n] = max(worst[n], float(err))

    for scene in ("reset", "converge_equal"):
        sj = s["states"].replace(vehicles=_jax_vehicles(_scene(scene)))
        steps = np.asarray(sj.steps) + np.arange(B, dtype=np.int32) * et.frames_per_step
        rng = np.random.default_rng(4)
        for t in range(STEPS):
            acts = rng.integers(0, et.action_type.n, B).astype(np.int32)
            sj = sj.replace(steps=jnp.asarray(steps))
            out_t = general_frames.simulate_general(
                et, _port_vehicles(sj.vehicles), et._action_to_slots(torch.from_numpy(acts)),
                et.frames_per_step, steps0=torch.from_numpy(steps),
            )
            sj = sim(sj, jnp.asarray(acts))
            fold(out_t, sj.vehicles)
            print(f"{scene} step {t}: yielding slots {int(out_t.is_yielding.sum())}")
            steps = steps + et.frames_per_step
    W = et._warmup_slots
    out_t = general_frames.frames_regulated_kernel(
        _port_vehicles(s["sub"]), et._general, torch.zeros((B, W), dtype=torch.int32),
        et._warmup_frames, torch.zeros(B, dtype=torch.int32),
    )
    fold(out_t, s["warm"])
    print(f"warm-up: yielding slots {int(out_t.is_yielding.sum())}")
    for n, err in worst.items():
        print(f"max |port - JAX XLA| {n}: {err:.3e}")


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_regulated.py (JAX on the CPU)
    jax.config.update("jax_platforms", "cpu")
    report()
