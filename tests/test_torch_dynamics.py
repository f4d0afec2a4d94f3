"""The BicycleVehicle dynamics and the dynamical frames against the JAX package, on the CPU.

``highwayenv_tpu_torch/vehicle/dynamics.py`` against
``highwayenv_tpu/vehicle/dynamics.py`` on random 6-states (speeds on both
sides of 1 but not within 1e-4 of it, crashed rows, steering past +-pi/2,
yaw rates past +-2pi): ``derivative`` and one ``integrate_dynamic`` step
within 4 ulp at each field's magnitude (the two differ only where the CPU
libms' cos / sin round differently); the masked rows only written.  A
vehicle braking through |v| = 1, the low-speed damping branch's
discontinuity, is held to the JAX step frame by frame, each frame from the
JAX state of the frame before.

Then the plain frames with ``GeneralSpec.dynamical`` (the reference of the
kernels' ``kDynamical`` instantiations) against the JAX package's XLA frames
(``BaseEnv._simulate``, which overrides the ego rows with the RK4 step) at
lane-keeping-v0 and intersection-v1, three policy steps from a port reset
batch, each side stepping its own state: discrete fields equal, pos within
2e-4 m, heading, speed, lateral speed and yaw rate within 1e-4 of their
magnitude.
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
from highwayenv_tpu.vehicle import dynamics as jax_dynamics
from highwayenv_tpu.vehicle.state import VehicleState as JaxVehicleState
from highwayenv_tpu_torch.bridge import to_numpy_state
from highwayenv_tpu_torch.ops import general_frames
from highwayenv_tpu_torch.parallel.rollout import random_actions
from highwayenv_tpu_torch.vehicle import dynamics
from highwayenv_tpu_torch.vehicle.state import KIND_EGO, KIND_IDM, VehicleState, empty_state

torch.set_num_threads(1)

N = 2048  # rows of the random states
ULPS = 4
FIELDS = ("pos", "heading", "speed", "lateral_speed", "yaw_rate")
DISCRETE = ("lane", "target_lane", "route_ptr", "crashed", "hit", "impact_pending",
            "kind", "is_yielding", "yield_timer")
POS_ATOL = 2e-4
REL_TOL = 1e-4


def _jax_vehicles(veh: VehicleState) -> JaxVehicleState:
    return JaxVehicleState(**{f.name: jnp.asarray(getattr(veh, f.name).numpy())
                              for f in dataclasses.fields(VehicleState)})


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32))


def _random_rows(seed: int, n: int = N) -> VehicleState:
    """n ego rows of random 6-states and actions: a quarter of the speeds
    within 1.5 of 0, none within 1e-4 of |v| = 1, steering to +-2.5 rad,
    yaw rates to +-10 rad/s, a fifth of the rows crashed."""
    rng = np.random.default_rng(seed)
    speed = rng.uniform(-12.0, 12.0, n)
    speed[: n // 4] = rng.uniform(-1.5, 1.5, n // 4)
    speed = np.where(np.abs(np.abs(speed) - 1.0) < 1e-4, 1.25, speed)
    return empty_state(1, n).replace(
        pos=_f32(rng.uniform(-200.0, 200.0, (1, n, 2))),
        heading=_f32(rng.uniform(-7.0, 7.0, (1, n))),
        speed=_f32(speed[None]),
        lateral_speed=_f32(rng.normal(0.0, 3.0, (1, n))),
        yaw_rate=_f32(rng.uniform(-10.0, 10.0, (1, n))),
        steering=_f32(rng.uniform(-2.5, 2.5, (1, n))),
        accel=_f32(rng.uniform(-6.0, 6.0, (1, n))),
        crashed=torch.from_numpy(rng.random((1, n)) < 0.2),
        kind=torch.full((1, n), KIND_EGO, dtype=torch.int32),
    )


def _ulp_close(a, b, where: str) -> None:
    a, b = np.asarray(a), np.asarray(b)
    scale = np.spacing(np.float32(max(float(np.abs(b).max(initial=0.0)), 1e-30)))
    np.testing.assert_allclose(a, b, rtol=0, atol=ULPS * scale, err_msg=where)


def test_derivative_matches_jax():
    veh = _random_rows(0)
    assert bool((veh.speed.abs() < 1).any()) and bool((veh.speed.abs() > 1).any())
    d_t = dynamics.derivative(veh).numpy()
    d_j = np.asarray(jax_dynamics.derivative(_jax_vehicles(veh)))
    assert d_t.shape == (1, N, 6)
    for c, name in enumerate(("dx", "dy", "dpsi", "dv", "dv_lat", "dr")):
        _ulp_close(d_t[..., c], d_j[..., c], name)


@pytest.mark.parametrize("dt", [1 / 15, 1 / 10], ids=["intersection", "lane-keeping"])
def test_integrate_dynamic_matches_jax(dt):
    veh = _random_rows(1)
    mask = torch.from_numpy(np.random.default_rng(2).random((1, N)) < 0.7)
    out_t = dynamics.integrate_dynamic(veh, dt, mask)
    out_j = jax_dynamics.integrate_dynamic(_jax_vehicles(veh), dt, jnp.asarray(mask.numpy()))
    for name in FIELDS:
        a = getattr(out_t, name)
        _ulp_close(a.numpy(), getattr(out_j, name), name)
        # the rows off the mask are untouched
        m = mask if a.dim() == 2 else mask[..., None].expand_as(a)
        assert torch.equal(a[~m], getattr(veh, name)[~m]), name
    # nothing else is written
    for f in dataclasses.fields(VehicleState):
        if f.name not in FIELDS:
            assert getattr(out_t, f.name) is getattr(veh, f.name)


def test_clips_and_the_crashed_rows():
    """Steering past +-pi/2 integrates as +-pi/2 (after a crashed row's
    zero steering and braking), a yaw rate past +-2pi as +-2pi; the stored
    yaw rate is the RK4 result."""
    veh = _random_rows(3, 64)
    mask = torch.ones((1, 64), dtype=torch.bool)
    dt = 1 / 15
    clipped = veh.replace(
        steering=veh.steering.clamp(-np.pi / 2, np.pi / 2),
        yaw_rate=veh.yaw_rate.clamp(-2 * np.pi, 2 * np.pi),
    )
    a = dynamics.integrate_dynamic(veh, dt, mask)
    b = dynamics.integrate_dynamic(clipped, dt, mask)
    for name in FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert bool((veh.yaw_rate.abs() > 2 * np.pi).any())
    assert bool((veh.steering.abs() > np.pi / 2).any())
    # a crashed row: zero steering, braking to rest
    crashed = veh.replace(crashed=torch.ones_like(veh.crashed))
    c = dynamics.integrate_dynamic(crashed, dt, mask)
    zero = dynamics.integrate_dynamic(crashed.replace(steering=torch.zeros_like(veh.steering)),
                                      dt, mask)
    assert torch.equal(c.pos, zero.pos) and torch.equal(c.yaw_rate, zero.yaw_rate)
    moving = veh.speed.abs() > 0.1
    assert bool((c.speed.abs() < veh.speed.abs())[moving].all())


def test_braking_through_unit_speed_frame_by_frame():
    """Rows braking from 1.3 m/s (and -1.3) at -1 m/s^2 (+1) cross the
    low-speed branch's |v| = 1 in the fourth frame of 0.1 s; each frame,
    from the JAX state of the frame before, within 4 ulp."""
    n = 16
    rng = np.random.default_rng(4)
    sign = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    veh = empty_state(1, n).replace(
        pos=_f32(rng.uniform(-5.0, 5.0, (1, n, 2))),
        heading=_f32(rng.uniform(-3.0, 3.0, (1, n))),
        speed=_f32((1.3 + 0.01 * np.arange(n)) * sign)[None],
        lateral_speed=_f32(rng.normal(0.0, 0.5, (1, n))),
        yaw_rate=_f32(rng.normal(0.0, 1.0, (1, n))),
        steering=_f32(rng.uniform(-0.5, 0.5, (1, n))),
        accel=_f32(-sign)[None],
        kind=torch.full((1, n), KIND_EGO, dtype=torch.int32),
    )
    mask = torch.ones((1, n), dtype=torch.bool)
    crossed = torch.zeros((1, n), dtype=torch.bool)
    for frame in range(8):
        out_t = dynamics.integrate_dynamic(veh, 0.1, mask)
        out_j = jax_dynamics.integrate_dynamic(_jax_vehicles(veh), 0.1, jnp.asarray(mask.numpy()))
        for name in FIELDS:
            _ulp_close(getattr(out_t, name).numpy(), getattr(out_j, name), f"frame {frame} {name}")
        crossed |= (veh.speed.abs() >= 1.0) & (out_t.speed.abs() < 1.0)
        veh = veh.replace(**{name: torch.from_numpy(np.array(getattr(out_j, name)))
                             for name in FIELDS})
    assert bool(crossed.all())


# --------------------------------------------------------------------------- #
# the dynamical plain frames against the JAX package's XLA frames
# --------------------------------------------------------------------------- #


def _jax_state(states, seed: int) -> JaxEnvState:
    d = to_numpy_state(states)
    return JaxEnvState(
        vehicles=JaxVehicleState(**{k: jnp.asarray(v) for k, v in d["vehicles"].items()}),
        time=jnp.asarray(d["time"]), steps=jnp.asarray(d["steps"]),
        key=jax.random.split(jax.random.PRNGKey(seed), d["time"].shape[0]),
    )


def _close(a, b, atol, where):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=atol, err_msg=where)


@pytest.mark.parametrize("env_id,batch", [("lane-keeping-v0", 8), ("intersection-v1", 4)])
def test_dynamical_plain_frames_match_jax_frames(env_id, batch):
    et = ht.make(env_id, device="cpu")
    ej = hj.make(env_id)
    spec = et._general
    assert spec.dynamical and not spec.connected
    assert (spec.period is not None) == (env_id == "intersection-v1")
    gen = et.generator(5)
    _, st = et.reset(batch, gen)
    if env_id == "intersection-v1":
        # one NPC row next to the ego's: the mask is the ego's kind alone
        assert bool((st.vehicles.kind == KIND_IDM).any())
    sj = _jax_state(st, 5)

    @jax.jit
    def simulate_j(state, actions):
        return jax.vmap(ej._simulate)(state, jax.vmap(ej._action_to_slots)(actions))

    for step in range(3):
        acts = random_actions(et, batch, gen)
        st = et._simulate(st, acts)
        sj = simulate_j(sj, jnp.asarray(acts.numpy()))
        vt, vj = st.vehicles, sj.vehicles
        where = f"{env_id} step {step}"
        np.testing.assert_array_equal(st.steps.numpy(), np.asarray(sj.steps), err_msg=where)
        for name in DISCRETE:
            np.testing.assert_array_equal(getattr(vt, name).numpy(),
                                          np.asarray(getattr(vj, name)),
                                          err_msg=f"{where} {name}")
        for name in FIELDS:
            b = np.asarray(getattr(vj, name))
            tol = POS_ATOL if name == "pos" else REL_TOL * max(1.0, float(np.abs(b).max()))
            _close(getattr(vt, name).numpy(), b, tol, f"{where} {name}")
    # the egos moved by the tire-slip model
    ego = st.vehicles.kind == KIND_EGO
    assert bool((st.vehicles.yaw_rate[ego] != 0).all())


def test_frames_kernel_for_picks_the_dynamical_instantiations():
    et = ht.make("lane-keeping-v0", device="cpu")
    ei = ht.make("intersection-v1", device="cpu")
    assert general_frames.frames_kernel_for(et._general, False) is (
        general_frames.frames_general_dynamical_kernel)
    assert general_frames.frames_kernel_for(ei._general, True) is (
        general_frames.frames_regulated_dynamical_kernel)
    assert general_frames.frames_regulated_dynamical_kernel.entry == (
        "general_frames_regulated_dynamical")
    v0 = ht.make("intersection-v0", device="cpu")._general
    assert general_frames.frames_kernel_for(v0, True) is general_frames.frames_regulated_kernel
    # a dynamical wrapper refuses a spec without the flag, and the reverse
    _, st = ei.reset(2, ei.generator(0))
    with pytest.raises(ValueError, match="dynamical spec"):
        general_frames.frames_regulated_kernel(
            st.vehicles, ei._general, None, 1, st.steps, raw=True)
    with pytest.raises(ValueError, match="dynamical spec"):
        general_frames.frames_regulated_dynamical_kernel(
            st.vehicles, v0, None, 1, st.steps, raw=True)
    # both flags: the connected dynamical instantiation, its own entry
    both = general_frames.GeneralFramesKernel(connected=True, dynamical=True)
    assert both.entry == "general_frames_connected_dynamical"
