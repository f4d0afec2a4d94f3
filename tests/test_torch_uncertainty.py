"""The port's interval observers (``ops/uncertainty.py``) against the JAX
package's (``highwayenv_tpu/ops/uncertainty.py``), on the CPU.

- ``IntervalObserver`` in its three modes (``observer_step``,
  ``partial_step``, ``predictor_step``) over 20 steps of dt=0.1, on a
  straight lane (highway-v0) and on roundabout-v0's circular lanes, with and
  without a front vehicle: every bound within 1e-5 of its magnitude of the
  JAX one;
- ``observer_step_batch`` at B=16 against the JAX batch and against the
  port's own host loop;
- ``worst_case_collision`` on a seeded sweep of 200 pose pairs: ``collides``
  and ``projection`` equal;
- the interval contains the true state of a LinearVehicle row stepped on
  the port's CPU frames (the port's form of the JAX package's
  ``tests/vehicle/test_uncertainty.py`` inclusion test).

The JAX side runs with x64 off, as the suite runs it.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import highwayenv_tpu as hj
import highwayenv_tpu_torch as ht
from highwayenv_tpu.ops import uncertainty as j_unc
from highwayenv_tpu_torch.envs import preprocessors
from highwayenv_tpu_torch.ops import uncertainty as t_unc
from highwayenv_tpu_torch.vehicle.state import KIND_LINEAR

torch.set_num_threads(1)

DT = 0.1
STEPS = 20
TOL = 1e-5
B = 16
MODES = ["observer", "partial", "predictor"]


@pytest.fixture(autouse=True)
def _x64_off():
    assert not jax.config.jax_enable_x64, (
        "jax_enable_x64 is on: the JAX package's host interval code rounds through "
        "float32 only with x64 off, as the suite runs it")


_ENVS: dict = {}


def _envs(env_id):
    if env_id not in _ENVS:
        _ENVS[env_id] = (hj.make(env_id), ht.make(env_id, device="cpu"))
    return _ENVS[env_id]


def _close(got, want, where):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())), err_msg=where)


def _scene(env_id):
    """(target lane, its host spec, s0, speed): a lane and a start on it."""
    et = _envs(env_id)[1]
    if env_id == "highway-v0":
        index = ("0", "1", 1)
        s0 = 40.0
    else:  # a circular lane of the ring
        index = ("se", "ex", 0)
        s0 = 2.0
    return et.net.global_lane_index(index), et.net.get_lane(index), s0, 12.0


def _observers(env_id, front: bool):
    ej, et = _envs(env_id)
    lane, spec, s0, v = _scene(env_id)
    pos = spec.position(s0, 0.3)
    heading = spec.heading_at(s0) + 0.02
    f = None
    if front:
        p = spec.position(s0 + 18.0, 0.0)
        f = (np.array([p - [0.5, 0.3], p + [0.5, 0.3]]), np.array([8.0, 9.0]))
    made = []
    for mod, geo in ((t_unc, et.geo), (j_unc, ej.geo)):
        ob = mod.IntervalObserver(geo=geo, target_lane=lane, target_speed=15.0)
        ob.interval = mod.VehicleInterval(
            position=np.array([pos - 0.2, pos + 0.2]), speed=np.array([v - 0.5, v + 0.5]),
            heading=np.array([heading - 0.01, heading + 0.01]))
        fr = None if f is None else mod.VehicleInterval(
            position=f[0].copy(), speed=f[1].copy(), heading=np.zeros(2))
        made.append((ob, fr))
    return made, spec, s0, v


@pytest.mark.parametrize("front", [False, True], ids=["alone", "front"])
@pytest.mark.parametrize("env_id", ["highway-v0", "roundabout-v0"])
@pytest.mark.parametrize("mode", MODES)
def test_observer_modes_match_jax(mode, env_id, front):
    ((ours, f_t), (theirs, f_j)), spec, s0, v = _observers(env_id, front)
    for t in range(STEPS):
        measured = spec.position(s0 + v * DT * (t + 1), 0.3)
        for ob, fr in ((ours, f_t), (theirs, f_j)):
            if mode == "observer":
                ob.observer_step(DT, measured, v, fr)
            elif mode == "partial":
                ob.partial_step(DT, measured, v, fr)
            else:
                ob.predictor_step(DT, measured, v, fr)
        where = f"{mode} {env_id} step {t}"
        _close(ours.interval.position, theirs.interval.position, where + " position")
        _close(ours.interval.speed, theirs.interval.speed, where + " speed")
        _close(ours.interval.heading, theirs.interval.heading, where + " heading")
    o = ours.interval
    assert np.all(o.position[0] <= o.position[1]) and o.speed[0] <= o.speed[1]
    if mode == "predictor":
        for name in ("longitudinal_lpv", "lateral_lpv"):
            _close(getattr(ours, name).x_i_t, getattr(theirs, name).x_i_t, f"{name} x_i_t")


def _fleet(rng, geo_mod):
    hosts = []
    for i in range(B):
        ob = geo_mod[0].IntervalObserver(geo=geo_mod[1], target_lane=i % 3,
                                         target_speed=20.0 + i)
        p = np.array([10.0 * i + 5.0, 4.0 * (i % 3) + rng.uniform(-1, 1)])
        ob.interval = geo_mod[0].VehicleInterval(
            position=np.array([p - 0.2, p + 0.2]), speed=np.array([18.0, 19.0]) + 0.5 * i,
            heading=np.array([-0.05, 0.05]) + 0.01 * (i % 4))
        hosts.append(ob)
    return hosts


@pytest.mark.parametrize("env_id", ["highway-v0", "roundabout-v0"])
def test_observer_step_batch_matches_jax_and_host(env_id):
    ej, et = _envs(env_id)
    if env_id == "roundabout-v0":
        lane0, spec, s0, _ = _scene(env_id)
    hosts = _fleet(np.random.default_rng(3), (t_unc, et.geo))
    if env_id == "roundabout-v0":  # every observer on a ring lane instead
        for i, h in enumerate(hosts):
            p = spec.position(s0 + 0.5 * i, 0.2)
            h.target_lane = lane0
            h.interval.position = np.array([p - 0.2, p + 0.2])
    front = np.array([[400.0, -0.1], [401.0, 0.1]]) if env_id == "highway-v0" else None
    if front is None:
        p = spec.position(s0 + 20.0, 0.0)
        front = np.array([p - 0.5, p + 0.5])
    fspd = np.array([15.0, 16.0])
    args = dict(
        target_lane=np.array([h.target_lane for h in hosts], np.int32),
        target_speed=np.array([h.target_speed for h in hosts], np.float32),
        theta_a_i=np.stack([h.theta_a_i for h in hosts]).astype(np.float32),
        theta_b_i=np.stack([h.theta_b_i for h in hosts]).astype(np.float32),
        position_i=np.stack([h.interval.position for h in hosts]).astype(np.float32),
        speed_i=np.stack([h.interval.speed for h in hosts]).astype(np.float32),
        heading_i=np.stack([h.interval.heading for h in hosts]).astype(np.float32),
        position=np.stack([h.interval.position.mean(0) for h in hosts]).astype(np.float32),
    )
    fmask = np.arange(B) % 2 == 0
    for with_front in (False, True):
        extra_t, extra_j = {}, {}
        if with_front:
            extra = dict(front_position_i=np.broadcast_to(front, (B, 2, 2)).astype(np.float32),
                         front_speed_i=np.broadcast_to(fspd, (B, 2)).astype(np.float32),
                         front_mask=fmask)
            extra_t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in extra.items()}
            extra_j = {k: jnp.asarray(v) for k, v in extra.items()}
        got = t_unc.observer_step_batch(
            et.geo, **{k: torch.from_numpy(v) for k, v in args.items()}, dt=DT, **extra_t)
        want = j_unc.observer_step_batch(
            ej.geo, **{k: jnp.asarray(v) for k, v in args.items()}, dt=DT, **extra_j)
        for g, w, name in zip(got, want, ("position", "speed", "heading")):
            _close(g.numpy(), np.asarray(w), f"{env_id} front={with_front} batch {name}")
        for i, h in enumerate(hosts):
            hc = copy.deepcopy(h)
            f = None
            if with_front and fmask[i]:
                f = t_unc.VehicleInterval(position=front.copy(), speed=fspd.copy(),
                                          heading=np.zeros(2))
            hc.observer_step(DT, args["position"][i].astype(float), 18.5, f)
            for g, w, name in zip(got, (hc.interval.position, hc.interval.speed,
                                        hc.interval.heading), ("position", "speed", "heading")):
                _close(g[i].numpy(), w, f"{env_id} front={with_front} row {i} host {name}")


def test_worst_case_collision_matches_jax():
    """200 seeded pairs of an uncertainty box and a planned pose around it:
    ``collides`` equal and ``projection`` equal."""
    rng = np.random.default_rng(5)
    n_hit = n_far = 0
    for _ in range(200):
        c = rng.uniform(-20, 20, 2)
        half = rng.uniform(0.2, 4.0, 2)
        box = np.array([c - half, c + half])
        other = c + rng.uniform(-12, 12, 2)
        args = (rng.uniform(-np.pi, np.pi), other, rng.uniform(3, 6), rng.uniform(1.5, 2.5),
                rng.uniform(-np.pi, np.pi))
        got = t_unc.worst_case_collision(
            t_unc.VehicleInterval(position=box, speed=np.zeros(2), heading=np.zeros(2)), *args)
        want = j_unc.worst_case_collision(
            j_unc.VehicleInterval(position=box, speed=np.zeros(2), heading=np.zeros(2)), *args)
        assert got[0] == want[0], (box, args)
        if want[1] is None:
            assert got[1] is None
            n_far += 1
        else:
            np.testing.assert_array_equal(got[1], want[1])
        n_hit += got[0]
    assert n_hit > 0 and n_far > 0 and n_hit + n_far < 200


@pytest.mark.parametrize("mode", ["partial", "predictor"])
def test_interval_contains_a_linear_vehicle_stepped_on_the_frames(mode):
    """highway-v0 under LinearVehicle NPCs, one frame a policy step and lane
    changes off: the leading Linear NPC of a row, stepped 2 s on the port's
    CPU frames, stays inside its observer's interval."""
    cfg = {"other_vehicles_type": "highway_env.vehicle.behavior.LinearVehicle",
           "simulation_frequency": 15, "policy_frequency": 15, "vehicles_count": 10}
    env = ht.make("highway-v0", cfg, device="cpu")
    gen = env.generator(4)
    _, st = env.reset(2, gen)
    st = preprocessors.set_vehicle_field(env, st, "enable_lane_change", False)
    veh = st.vehicles
    lin = (veh.kind[0] == KIND_LINEAR).numpy()
    x = veh.pos[0, :, 0].numpy()
    # the Linear NPC that leads its lane: no front to brake for
    lanes = veh.lane[0].numpy()
    lead = [j for j in np.nonzero(lin)[0]
            if not any((lanes == lanes[j]) & (x > x[j]) & (np.arange(len(x)) != j))]
    slot = int(lead[0])
    ob = t_unc.observer_for_slot(env, st, slot, row=0)
    dt = env.dt
    for t in range(30):
        st = env.step_batched(st, torch.ones(2, dtype=torch.int32), gen)[1]
        h = t_unc.host_row(st, 0)
        pos, speed, heading = h.pos[slot].astype(float), float(h.speed[slot]), float(h.heading[slot])
        if mode == "partial":
            ob.partial_step(dt, pos, speed)
        else:
            ob.predictor_step(dt, pos, speed)
        o = ob.interval
        assert np.all(o.position[0] - 1e-4 <= pos) and np.all(pos <= o.position[1] + 1e-4), (
            f"step {t}: {pos} outside {o.position}")
        assert o.heading[0] - 1e-6 <= heading <= o.heading[1] + 1e-6, f"step {t}"
        assert o.speed[0] - 1e-4 <= speed <= o.speed[1] + 1e-4, f"step {t}"
