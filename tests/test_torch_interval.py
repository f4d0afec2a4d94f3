"""The port's interval arithmetic and LPV predictors (``ops/interval.py``)
against the JAX package's (``highwayenv_tpu/ops/interval.py``), on the CPU.

- every box function and ``lpv_step`` (the Metzler and the naive branch) on
  seeded boxes, within 1e-6 of the value's magnitude;
- the host helpers, ``polytope`` and ``is_metzler``, the float32 ones
  (``integrator_interval``, ``vector_interval_section``, the local <->
  absolute boxes) included;
- ``LPV`` built from the interval observer's longitudinal (Metzler) and
  lateral (naive) structures, and from the lateral one over a box whose
  mean matrix has real eigenvalues (the eigenbasis coordinates), stepped 20
  times: ``x_i_t`` and ``x_t`` within 1e-9 of their magnitude, and its
  float32 ``params`` equal;
- the predicted interval contains the true trajectory of the same system
  under a parameter drawn in the box and a bounded disturbance.

The JAX side runs with x64 off, as the suite runs it: the JAX package's host
code rounds through float32 where x64 is off, and the port rounds there too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import highwayenv_tpu as hj
import highwayenv_tpu_torch as ht
from highwayenv_tpu.ops import interval as j_iv
from highwayenv_tpu_torch.ops import interval as t_iv
from highwayenv_tpu_torch.ops import uncertainty as t_unc

torch.set_num_threads(1)

SEEDS = [0, 1, 2]
TOL = 1e-6
B = 16
DT = 0.05
STEPS = 20


@pytest.fixture(autouse=True)
def _x64_off():
    assert not jax.config.jax_enable_x64, (
        "jax_enable_x64 is on: the JAX package's host interval code rounds through "
        "float32 only with x64 off, as the suite runs it")


def _close(got, want, tol=TOL, where=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, where
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())), err_msg=where)


def _boxes(rng, shape, n):
    """(..., 2, n) boxes, lower row below the upper."""
    a = rng.normal(size=shape + (2, n)) * 3
    return np.sort(a, axis=-2).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("seed", SEEDS)
def test_box_functions_match_jax(seed):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(B, 3, 4)).astype(np.float32)
    b = _boxes(rng, (B,), 4)
    _close(t_iv.box_scale(_t(m), _t(b)), j_iv.box_scale(m, b), where="box_scale")
    a = _boxes(rng, (B,), 3)
    c = _boxes(rng, (B,), 3)
    _close(t_iv.box_diff(_t(a), _t(c)), j_iv.box_diff(a, c), where="box_diff")
    _close(t_iv.box_negative_part(_t(a)), j_iv.box_negative_part(a), where="negative part")
    # the integrator over each sign case of x: >= 0, <= 0 and across 0
    x = np.concatenate([np.abs(_boxes(rng, (4,), 2)), -np.abs(_boxes(rng, (4,), 2))[..., ::-1],
                        _boxes(rng, (8,), 2)])[:, 0, :]
    x = np.sort(x, axis=-1)
    k = np.sort(rng.uniform(0.5, 3, size=(B, 2)), axis=-1).astype(np.float32)
    _close(t_iv.box_integrator(_t(x), _t(k)), j_iv.box_integrator(x, k), where="integrator")
    v = _boxes(rng, (B,), 2)
    d = rng.normal(size=(B, 2)).astype(np.float32)
    _close(t_iv.box_section(_t(v), _t(d)), j_iv.box_section(v, d), where="section")
    _close(t_iv.box_corners2(_t(v)), j_iv.box_corners2(v), where="corners")


@pytest.mark.parametrize("env_id", ["highway-v0", "roundabout-v0"])
def test_local_absolute_boxes_match_jax(env_id):
    """On straight and on circular lanes, batched and through the host
    helpers (float32 lane ops on both sides)."""
    ej, et = hj.make(env_id), ht.make(env_id, device="cpu")
    rng = np.random.default_rng(4)
    L = et.geo.num_lanes
    lane = rng.integers(0, L, size=B).astype(np.int32)
    s = rng.uniform(2.0, 20.0, size=B).astype(np.float32)
    pos = t_iv.box_local_to_absolute(
        et.geo, _t(lane), _t(np.stack([s, s + 1], -1)),
        _t(np.stack([np.full(B, -0.5, np.float32), np.full(B, 0.5, np.float32)], -1)))
    want = j_iv.box_local_to_absolute(
        ej.geo, jnp.asarray(lane), jnp.stack([s, s + 1], -1),
        jnp.stack([jnp.full(B, -0.5), jnp.full(B, 0.5)], -1))
    _close(pos, want, 1e-5, "local -> absolute")
    got_s, got_l = t_iv.box_absolute_to_local(et.geo, _t(lane), pos)
    want_s, want_l = j_iv.box_absolute_to_local(ej.geo, jnp.asarray(lane),
                                                jnp.asarray(pos.numpy()))
    _close(got_s, want_s, 1e-5, "absolute -> local s")
    _close(got_l, want_l, 1e-5, "absolute -> local lat")
    for i in range(4):
        box = pos[i].numpy().astype(np.float64)
        gs, gl = t_iv.interval_absolute_to_local(box, et.geo, int(lane[i]))
        ws, wl = j_iv.interval_absolute_to_local(box, ej.geo, int(lane[i]))
        assert gs.dtype == np.float32 == ws.dtype
        _close(gs, ws, 1e-5, "host absolute -> local")
        _close(gl, wl, 1e-5, "host absolute -> local")
        _close(t_iv.interval_local_to_absolute(gs, gl, et.geo, int(lane[i])),
               j_iv.interval_local_to_absolute(ws, wl, ej.geo, int(lane[i])), 1e-5,
               "host local -> absolute")


@pytest.mark.parametrize("seed", SEEDS)
def test_host_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(10):
        a = np.sort(rng.normal(size=(2, 3)), axis=0)
        b = np.sort(rng.normal(size=(2, 3)), axis=0)
        np.testing.assert_array_equal(t_iv.intervals_product(a, b), j_iv.intervals_product(a, b))
        m = rng.normal(size=(3, 3))
        np.testing.assert_array_equal(t_iv.intervals_scaling(m, b), j_iv.intervals_scaling(m, b))
        np.testing.assert_array_equal(t_iv.intervals_diff(a, b), j_iv.intervals_diff(a, b))
        np.testing.assert_array_equal(t_iv.interval_negative_part(a),
                                      j_iv.interval_negative_part(a))
        x = np.sort(rng.normal(size=2))
        k = np.sort(rng.uniform(0.5, 3, size=2))
        got, want = t_iv.integrator_interval(x, k), j_iv.integrator_interval(x, k)
        assert got.dtype == np.float32 == want.dtype
        np.testing.assert_array_equal(got, want)
        v = np.sort(rng.normal(size=(2, 2)) * 10, axis=0)
        d = rng.normal(size=2)
        got, want = t_iv.vector_interval_section(v, d), j_iv.vector_interval_section(v, d)
        assert got.dtype == np.float32 == want.dtype
        np.testing.assert_array_equal(got, want)
    f = lambda p: np.array([[-1.0, p[0]], [p[1], -2.0]])  # noqa: E731
    box = np.array([[0.0, -1.0], [1.0, 1.0]])
    a0, da = t_iv.polytope(f, box)
    ja0, jda = j_iv.polytope(f, box)
    np.testing.assert_array_equal(a0, ja0)
    assert len(da) == len(jda) == 4
    for g, w in zip(da, jda):
        np.testing.assert_array_equal(g, w)
    for mat in ([[-1, 0.5], [0.2, -2]], [[-1, -0.5], [0.2, -2]], [[0, -1e-10], [0, 0]]):
        assert t_iv.is_metzler(mat) == j_iv.is_metzler(mat)
    assert t_iv.is_metzler([[-1, 0.5], [0.2, -2]]) and not t_iv.is_metzler([[-1, -0.5], [0.2, -2]])


def _structures(front: bool):
    """The observer's longitudinal and lateral LPVs' constructor arguments
    (``IntervalObserver.predictor_init``), with a seeded initial box."""
    obs = t_unc.IntervalObserver(geo=None, target_lane=0, target_speed=25.0)
    a, phi = obs._longitudinal_structure(front_exists=front, at_safe_gap=False)
    a0, da = t_iv.polytope(lambda p: a + np.tensordot(phi, p, axes=[0, 0]), obs.theta_a_i)
    x0 = [10.0, 40.0 if front else 0.0, 20.0, 15.0 if front else 0.0]
    longi = dict(x0=x0, a0=a0, da=da, b=np.eye(4), d=np.array([[1], [0], [0], [0]]),
                 omega_i=np.array([[-1], [1]]) * 1.0, u=[[25.0], [25.0], [0], [0]],
                 center=[-10.0 - 25.0 * 2.5, 0, 25.0, 25.0],
                 x_i=[np.array(x0) - 0.2, np.array(x0) + 0.2])
    a, phi = obs._lateral_structure()
    a0, da = t_iv.polytope(lambda p: a + np.tensordot(phi, p, axes=[0, 0]), obs.theta_b_i)
    lat = dict(x0=[0.3, 0.02], a0=a0, da=da, b=np.identity(2), d=np.array([[1], [0]]),
               omega_i=np.array([[-1], [1]]) * 0.5, u=[[0], [0]], center=[0, 0],
               x_i=[[0.2, 0.0], [0.4, 0.04]])
    # the lateral structure over a box whose mean matrix has real
    # eigenvalues: the predictor runs in its eigenbasis
    eig_box = np.array([[6.0, 1.0], [8.0, 3.0]])
    a0, da = t_iv.polytope(lambda p: a + np.tensordot(phi, p, axes=[0, 0]), eig_box)
    eig = dict(lat, a0=a0, da=da)
    return {"longitudinal": longi, "lateral": lat, "eigenbasis": eig}


def _box_of(system):
    obs = t_unc.IntervalObserver(geo=None, target_lane=0, target_speed=25.0)
    return {"longitudinal": obs.theta_a_i, "lateral": obs.theta_b_i,
            "eigenbasis": np.array([[6.0, 1.0], [8.0, 3.0]])}[system]


SYSTEMS = ["longitudinal", "lateral", "eigenbasis"]


@pytest.mark.parametrize("front", [False, True], ids=["alone", "front"])
@pytest.mark.parametrize("system", SYSTEMS)
def test_lpv_matches_jax_over_20_steps(system, front):
    kw = _structures(front)[system]
    ours, theirs = t_iv.LPV(**kw), j_iv.LPV(**kw)
    # a0 in the eigenbasis is diagonal, so Metzler: the tight predictor
    metzler = system != "lateral"
    assert ours.params.metzler == theirs.params.metzler == metzler
    # the lateral mean matrix has complex eigenvalues (no coordinate
    # change), the eigenbasis one real ones
    assert (ours.coordinates is None) == (theirs.coordinates is None) == (system == "lateral")
    if ours.coordinates is not None:
        _close(ours.coordinates[0], theirs.coordinates[0], 1e-12)
        _close(ours.coordinates[1], theirs.coordinates[1], 1e-12)
    for name in ("a0", "da_pos", "da_neg", "b", "d"):
        got, want = getattr(ours.params, name), getattr(theirs.params, name)
        assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    for t in range(STEPS):
        ours.step(DT)
        theirs.step(DT)
        _close(ours.x_i_t, theirs.x_i_t, 1e-9, f"x_i_t step {t}")
        _close(ours.x_t, theirs.x_t, 1e-9, f"x_t step {t}")
    back = ours.change_coordinates(ours.x_i_t, back=True, interval=True)
    _close(back, theirs.change_coordinates(theirs.x_i_t, back=True, interval=True), 1e-9)


@pytest.mark.parametrize("system", SYSTEMS)
def test_lpv_step_matches_jax_both_branches(system):
    """``lpv_step`` on a batch of seeded boxes with each system's float32
    params: the Metzler branch (longitudinal; eigenbasis, whose a0 is
    diagonal there) and the naive one (lateral), 20 steps."""
    kw = _structures(True)[system]
    lpv = t_iv.LPV(**kw)
    jp = j_iv.LPV(**kw).params
    p = lpv.params
    N = p.a0.shape[0]
    rng = np.random.default_rng(7)
    x = _boxes(rng, (B,), N)
    u = rng.normal(size=(B, p.b.shape[1])).astype(np.float32)
    om = _boxes(rng, (B,), p.d.shape[1])
    xt, xj = _t(x), jnp.asarray(x)
    for t in range(STEPS):
        xt = t_iv.lpv_step_batch(p, xt, _t(u), _t(om), DT)
        xj = j_iv.lpv_step(jp, xj, jnp.asarray(u), jnp.asarray(om), DT)
        _close(xt, xj, TOL, f"{system} step {t}")
    assert bool((xt[:, 0] <= xt[:, 1]).all())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("system", SYSTEMS)
def test_predicted_interval_contains_true_trajectory(system, seed):
    """The true system in the predictor's coordinates, under a parameter
    drawn in the box (an affine map: inside the matrix polytope) and a
    disturbance drawn in ``omega_i`` each step, Euler-stepped as the
    predictor is: it stays inside the predicted interval."""
    rng = np.random.default_rng(seed)
    kw = _structures(True)[system]
    lpv = t_iv.LPV(**kw)
    obs = t_unc.IntervalObserver(geo=None, target_lane=0, target_speed=25.0)
    if system == "longitudinal":
        a, phi = obs._longitudinal_structure(front_exists=True, at_safe_gap=False)
    else:
        a, phi = obs._lateral_structure()
    box = _box_of(system)
    theta = box[0] + rng.uniform(size=box.shape[1]) * (box[1] - box[0])
    a_true = lpv.change_coordinates(a + np.tensordot(phi, theta, axes=[0, 0]), matrix=True)
    z = lpv.x_i_t[0] + rng.uniform(size=lpv.x_i_t.shape[1]) * (lpv.x_i_t[1] - lpv.x_i_t[0])
    u = np.atleast_1d(np.squeeze(lpv.u))
    for t in range(STEPS):
        w = lpv.omega_i[0] + rng.uniform(size=lpv.omega_i.shape[1]) * (
            lpv.omega_i[1] - lpv.omega_i[0])
        z = z + DT * (a_true @ z + lpv.b @ u + lpv.d @ w)
        lpv.step(DT)
        lo, hi = lpv.x_i_t
        assert np.all(lo <= z + 1e-9) and np.all(z <= hi + 1e-9), f"step {t}: {lo} {z} {hi}"
