"""The port's state preprocessors (``envs/preprocessors.py``) against the
JAX package's (``highwayenv_tpu/envs/preprocessors.py``), on the CPU.

Each function on the same bridged batch of scenes, exactly: ``simplify``,
``change_vehicles`` for every class, ``set_preferred_lane``,
``set_vehicle_field`` and ``randomize_behavior`` with the JAX draws fed in;
the port's own draws of ``randomize_behavior`` by their law (ranges, one
draw per env and slot); and a ``change_vehicles``-made Linear state on an
IDM-config highway-fast-v0 stepped 3 policy steps through the sorted and
the dense plain paths against the JAX XLA step, which decides the law per
row (tolerances of test_torch_linear.py).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import highwayenv_tpu as hj
import highwayenv_tpu_torch as ht
from highwayenv_tpu.envs import preprocessors as j_pre
from highwayenv_tpu_torch.bridge import from_numpy_state
from highwayenv_tpu_torch.envs import preprocessors as t_pre
from highwayenv_tpu_torch.vehicle.controller import MAX_STEERING_ANGLE
from highwayenv_tpu_torch.vehicle.state import (
    KIND_EGO,
    KIND_IDM,
    KIND_LINEAR,
    KIND_OBSTACLE,
    KIND_PAD,
    VehicleState,
)

torch.set_num_threads(1)

B = 8
STEPS = 3
CLASSES = ("IDMVehicle", "LinearVehicle", "AggressiveVehicle", "DefensiveVehicle", "Vehicle")
DISCRETE = ("lane", "target_lane", "crashed", "hit", "impact_pending", "speed_index",
            "kind")
CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer", "impact",
              "steering", "accel")
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


def _assert_step(out_t, out_j, where):
    """A step's outputs: terminated and truncated and the discrete fields
    exact, obs and reward 1e-5, pos 2e-4 m and the other continuous fields
    1e-4 of their magnitude."""
    obs_t, st_t, rew_t, term_t, trunc_t, _ = out_t
    obs_j, st_j, rew_j, term_j, trunc_j, _ = out_j
    np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j), err_msg=where)
    np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j), err_msg=where)
    np.testing.assert_allclose(rew_t.numpy(), np.asarray(rew_j), rtol=0, atol=HEAD_ATOL,
                               err_msg=f"{where}: reward")
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), rtol=0, atol=HEAD_ATOL,
                               err_msg=f"{where}: obs")
    vt, vj = st_t.vehicles, st_j.vehicles
    for name in DISCRETE:
        np.testing.assert_array_equal(getattr(vt, name).numpy(),
                                      np.asarray(getattr(vj, name)), err_msg=f"{where}: {name}")
    for name in CONTINUOUS:
        a = getattr(vt, name).numpy().astype(np.float64)
        b = np.asarray(getattr(vj, name)).astype(np.float64)
        if name == "steering":
            # the XLA straight frame stores the ego's P-cascade steering
            # unclipped (highwayenv_tpu/ops/straight_fast.py:436-438)
            b = np.clip(b, -MAX_STEERING_ANGLE, MAX_STEERING_ANGLE)
        tol = 2e-4 if name == "pos" else 1e-4 * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=f"{where}: {name}")


_SETUP: dict = {}


def _reset(env_id, config=None):
    """A JAX env and a jitted JAX reset batch of it, once per process."""
    key = (env_id, repr(config))
    if key not in _SETUP:
        ej = hj.make(env_id, config)
        keys = jax.random.split(jax.random.PRNGKey(2), B)
        _SETUP[key] = (ej, jax.jit(jax.vmap(ej._reset))(keys)[1])
    return _SETUP[key]


def _assert_equal(port_state, jax_state, where=""):
    """Every vehicle field equal, bit for bit."""
    ref = numpy_state(jax_state)["vehicles"]
    for f in dataclasses.fields(VehicleState):
        a = getattr(port_state.vehicles, f.name).numpy()
        assert a.dtype == ref[f.name].dtype, f"{where} {f.name}"
        np.testing.assert_array_equal(a, ref[f.name], err_msg=f"{where} {f.name}")


def _both(env_id, config=None, edit=None):
    """(JAX env, port env, JAX states, port states) of a reset batch, with
    ``edit`` (a function of the numpy vehicle dict) applied to both."""
    ej, sj = _reset(env_id, config)
    et = ht.make(env_id, config, device="cpu")
    d = numpy_state(sj)
    d["vehicles"] = {k: a.copy() for k, a in d["vehicles"].items()}
    if edit is not None:
        edit(d["vehicles"])
        sj = sj.replace(vehicles=sj.vehicles.replace(
            **{k: jnp.asarray(a) for k, a in d["vehicles"].items()}))
    return ej, et, sj, from_numpy_state(d)


def test_simplify_matches_jax():
    def far(v):
        # slots 5..9 moved 150 to 250 m ahead of the ego: some in range
        v["pos"][:, 5:10, 0] = v["pos"][:, :1, 0] + np.linspace(150.0, 250.0, 5)

    ej, et, sj, st = _both("highway-v0", edit=far)
    out_t = t_pre.simplify(et, st)
    _assert_equal(out_t, jax.vmap(lambda s: j_pre.simplify(ej, s))(sj))
    dropped = (out_t.vehicles.kind == KIND_PAD) & (st.vehicles.kind != KIND_PAD)
    assert bool(dropped.any()) and bool((out_t.vehicles.kind[:, 5:10] != KIND_PAD).any())


@pytest.mark.parametrize("name", CLASSES)
def test_change_vehicles_matches_jax(name):
    """On merge-v0, whose obstacle is no vehicle and keeps its kind."""
    ej, et, sj, st = _both("merge-v0")
    path = f"highway_env.vehicle.behavior.{name}"
    out_t = t_pre.change_vehicles(et, st, path)
    _assert_equal(out_t, jax.vmap(lambda s: j_pre.change_vehicles(ej, s, path))(sj), name)
    kind = out_t.vehicles.kind
    assert (kind[:, 0] == KIND_EGO).all() and (kind == KIND_OBSTACLE).any()
    with pytest.raises(KeyError):
        t_pre.change_vehicles(et, st, "highway_env.vehicle.behavior.NoSuchVehicle")


@pytest.mark.parametrize("config", [None, npc("LinearVehicle")], ids=["idm", "linear"])
def test_set_preferred_lane_matches_jax(config):
    """On roundabout-v0, whose NPCs follow routes."""
    ej, et, sj, st = _both("roundabout-v0", config)
    out_t = t_pre.set_preferred_lane(et, st, 1)
    _assert_equal(out_t, jax.vmap(lambda s: j_pre.set_preferred_lane(ej, s, 1))(sj))
    assert bool((out_t.vehicles.route_id != st.vehicles.route_id).any())


@pytest.mark.parametrize("field, value", [
    ("enable_lane_change", False), ("mobil_gain", 0.5), ("route_ptr", 1),
])
def test_set_vehicle_field_matches_jax(field, value):
    ej, et, sj, st = _both("roundabout-v0")
    out_t = t_pre.set_vehicle_field(et, st, field, value)
    _assert_equal(out_t, jax.vmap(lambda s: j_pre.set_vehicle_field(ej, s, field, value))(sj))
    got = getattr(out_t.vehicles, field)
    assert (got[:, 1:] == value).all()
    assert torch.equal(got[:, 0], getattr(st.vehicles, field)[:, 0])


def _mixed(v):
    """Odd slots back to IDM: a batch of IDM and Linear rows."""
    lin = v["kind"] == KIND_LINEAR
    v["kind"][:, 1::2] = np.where(lin[:, 1::2], KIND_IDM, v["kind"][:, 1::2])


def test_randomize_behavior_matches_jax_on_its_draws():
    ej, et, sj, st = _both("highway-fast-v0", npc("LinearVehicle"), edit=_mixed)
    keys = jax.random.split(jax.random.PRNGKey(8), B)
    V = et.num_slots

    def draws(key):
        k_delta, k_a, k_s = jax.random.split(key, 3)
        return (jax.random.uniform(k_delta, (V,), minval=3.5, maxval=4.5),
                jax.random.uniform(k_a, (V, 3)), jax.random.uniform(k_s, (V, 2)))

    delta, ua, ub = (torch.from_numpy(np.array(x)) for x in jax.vmap(draws)(keys))
    out_t = t_pre.randomize_behavior(
        et, st, draws={"delta": delta, "accel_u": ua, "steer_u": ub})
    _assert_equal(out_t, jax.vmap(lambda s, k: j_pre.randomize_behavior(ej, s, k))(sj, keys))
    kinds = st.vehicles.kind
    assert bool((kinds == KIND_IDM).any()) and bool((kinds == KIND_LINEAR).any())


def test_randomize_behavior_draws_by_law():
    """The port's own draws: each in its range, one per env and slot (no
    env repeats another's), and the exponents uniform over [3.5, 4.5]."""
    et = ht.make("highway-fast-v0", npc("DefensiveVehicle"), device="cpu")
    _, st = et.reset(16, et.generator(0))
    out = t_pre.randomize_behavior(et, st, et.generator(3)).vehicles
    lin = st.vehicles.kind == KIND_LINEAR
    moved = lin | (st.vehicles.kind == KIND_IDM)
    delta = out.delta[moved]
    assert float(delta.min()) >= 3.5 and float(delta.max()) <= 4.5
    base = torch.tensor(t_pre.ACCEL_DEFAULT)
    a = out.accel_params[lin]
    assert bool((a >= 0.5 * base - 1e-6).all() and (a <= 1.5 * base + 1e-6).all())
    sp, spread = torch.tensor(t_pre.STEER_DEFAULT), torch.tensor(t_pre.STEER_SPREAD)
    s = out.steer_params[lin]
    assert bool((s >= sp - spread - 1e-6).all() and (s <= sp + spread + 1e-6).all())
    # the IDM exponents of the ego and the padding keep their values
    assert torch.equal(out.delta[~moved], st.vehicles.delta[~moved])
    rows = out.accel_params.reshape(16, -1)
    assert len({tuple(r.tolist()) for r in rows}) == 16
    from scipy import stats

    assert stats.kstest(((delta - 3.5) / 1.0).numpy(), "uniform").pvalue > 1e-3


@pytest.mark.parametrize("sorted_frames", [True, False], ids=["sorted", "dense"])
def test_change_vehicles_state_steps_by_the_linear_law(sorted_frames):
    """``change_vehicles(AggressiveVehicle)`` on an IDM-config
    highway-fast-v0: the port steps the Linear rows by the linear law, as
    the JAX XLA step does (its Pallas kernel would not: the config names
    no preset, see test_torch_linear.py)."""
    env_id = "highway-fast-v0"
    path = "highway_env.vehicle.behavior.AggressiveVehicle"
    ej, et, sj, st = _both(env_id)
    et = ht.make(env_id, device="cpu", sorted_frames=sorted_frames)
    sj = jax.vmap(lambda s: j_pre.change_vehicles(ej, s, path))(sj)
    st = t_pre.change_vehicles(et, st, path)
    assert bool((st.vehicles.kind == KIND_LINEAR).any())
    key = ("step", env_id)
    if key not in _SETUP:
        _SETUP[key] = jax.jit(ej.step_batched)
    step = _SETUP[key]
    rng = np.random.default_rng(11)
    gen = et.generator(0)
    for t in range(STEPS):
        acts = rng.integers(0, et.action_type.n, B).astype(np.int32)
        out_t = et.step_batched(st, torch.from_numpy(acts), gen)
        out_j = step(sj, jnp.asarray(acts))
        _assert_step(out_t, out_j, f"step {t}")
        st, sj = out_t[1], out_j[1]
    assert bool((st.vehicles.kind == KIND_LINEAR).any())
