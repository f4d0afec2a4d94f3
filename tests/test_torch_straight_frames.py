"""The port's straight-road frames against the JAX package, on the CPU.

``simulate_bm`` on CPU tensors runs ``frames_plain``, the plain version of
the CUDA frame kernel (the kernel itself is held against it on the card by
chip_smoke.py).  It is compared over 3 policy steps with both JAX paths the
dense frame kernel K1 is held to: ``pallas_simulate_bm`` in interpret mode
and the XLA ``straight_frame`` scan of ``BaseEnv._simulate_batched``.

Tolerances: discrete fields exact; pos 2e-4 m absolute (as
tests/test_batched_step.py holds K1 to XLA); other continuous fields 1e-4
times the field's magnitude.  The JAX and torch CPU backends use different
libm pow/sin/cos/atan (~1 ulp apart) and contract a*b+c differently, and
the IDM acceleration cancels terms up to ~100x its size, so accel carries
a few tens of ulps; the bound leaves headroom above the ~30 ulps seen.
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
from highwayenv_tpu_torch.bridge import from_numpy_state
from highwayenv_tpu_torch.ops import straight_frames
from highwayenv_tpu_torch.vehicle.controller import MAX_STEERING_ANGLE
from highwayenv_tpu_torch.vehicle.state import VehicleState

torch.set_num_threads(1)

B = 8
STEPS = 3
DISCRETE = ("lane", "target_lane", "crashed", "hit", "impact_pending", "speed_index")
CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer", "impact",
              "steering", "accel")
SCENES = ("normal", "compressed", "pileup", "front_tie", "rear_tie")

_SETUP: dict = {}


def _setup(env_id):
    """JAX env, port env, the jitted JAX references and a reset batch; built
    once per env so each JAX program compiles once per test process."""
    if env_id not in _SETUP:
        ej = hj.make(env_id)
        et = ht.make(env_id, device="cpu")
        _, states = jax.vmap(ej._reset)(jax.random.split(jax.random.PRNGKey(1), B))
        frames = ej.frames_per_step

        def pal(veh, acts):
            sa = jax.vmap(ej._action_to_slots)(acts)
            return pallas_simulate_bm(ej, veh, sa, frames, block=B, interpret=True)

        _SETUP[env_id] = (
            ej, et, states, jax.jit(pal), jax.jit(ej._simulate_batched)
        )
    return _SETUP[env_id]


def _scene(states, name):
    """A JAX EnvState batch with positions (and for ties, lanes and speeds)
    rewritten; tests/test_batched_step.py builds the first three."""
    veh = states.vehicles
    pos = np.asarray(veh.pos).copy()
    if name == "compressed":  # immediate collisions
        pos[..., 0] *= 0.2
    elif name == "pileup":  # 20 vehicles in 6 m
        pos[:, :20, 0] = 100.0 + np.linspace(0, 6, 20)
    elif name in ("front_tie", "rear_tie"):
        # slots 1 and 2 at the same s on lane 1 (laterally apart, not
        # touching) ahead of / behind the NPC in slot 3; the rest from 400 m
        lane = np.asarray(veh.lane).copy()
        speed = np.asarray(veh.speed).copy()
        pos[:, 4:, 0] = 400.0 + 20.0 * np.arange(pos.shape[1] - 4)
        x_q, x_tie = (100.0, 130.0) if name == "front_tie" else (200.0, 170.0)
        pos[:, 0] = (60.0, 0.0)
        pos[:, 1] = (x_tie, 2.9)
        pos[:, 2] = (x_tie, 5.1)
        pos[:, 3] = (x_q, 4.0)
        lane[:, 0], lane[:, 1:4] = 0, 1
        speed[:, 1:4] = (10.0, 15.0, 20.0)
        veh = veh.replace(
            lane=jnp.asarray(lane), target_lane=jnp.asarray(lane),
            speed=jnp.asarray(speed), target_speed=jnp.asarray(speed),
        )
    return states.replace(vehicles=veh.replace(pos=jnp.asarray(pos)))


def _numpy_state(states) -> dict:
    return {
        "vehicles": {
            f.name: np.asarray(getattr(states.vehicles, f.name))
            for f in dataclasses.fields(VehicleState)
        },
        "time": np.asarray(states.time),
        "steps": np.asarray(states.steps),
    }


def _clip_steering(ref):
    # the XLA straight_frame stores the ego's P-cascade steering unclipped
    # (highwayenv_tpu/ops/straight_fast.py:410); K1 and the general path
    # clip it at the source (vehicle/controller.py:106), and so does the port
    return ref.replace(steering=jnp.clip(
        ref.steering, -MAX_STEERING_ANGLE, MAX_STEERING_ANGLE
    ))


def _assert_close(port, ref, where, clip_steering=False):
    if clip_steering:
        ref = _clip_steering(ref)
    for name in DISCRETE:
        np.testing.assert_array_equal(
            getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
            err_msg=f"{where}: {name}",
        )
    for name in CONTINUOUS:
        a = getattr(port, name).numpy().astype(np.float64)
        b = np.asarray(getattr(ref, name)).astype(np.float64)
        tol = 2e-4 if name == "pos" else 1e-4 * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=f"{where}: {name}")


def _steps(env_id, scene):
    """Yield (step, port, pallas-interpret, XLA) vehicle states over STEPS
    policy steps from the same scene and actions."""
    ej, et, states, pal, xla = _setup(env_id)
    sj = _scene(states, scene)
    veh_t = from_numpy_state(_numpy_state(sj)).vehicles
    veh_p, st_x = sj.vehicles, sj
    rng = np.random.default_rng(7)
    for t in range(STEPS):
        acts = rng.integers(0, et.action_type.n, B).astype(np.int32)
        veh_t = straight_frames.simulate_bm(
            et, veh_t, et._action_to_slots(torch.from_numpy(acts)),
            et.frames_per_step,
        )
        veh_p = pal(veh_p, jnp.asarray(acts))
        st_x = xla(st_x, jnp.asarray(acts))
        yield t, veh_t, veh_p, st_x.vehicles


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("env_id", ["highway-fast-v0", "highway-v0"])
def test_frames_plain_matches_pallas_interpret_and_xla(env_id, scene):
    crashed_any = False
    for t, veh_t, veh_p, veh_x in _steps(env_id, scene):
        _assert_close(veh_t, veh_p, f"{scene} step {t} vs pallas interpret")
        _assert_close(veh_t, veh_x, f"{scene} step {t} vs XLA", clip_steering=True)
        crashed_any |= bool(veh_t.crashed.any())
    if scene in ("compressed", "pileup"):
        assert crashed_any  # collisions exercised


def test_neighbour_ties_match_jax():
    """Front keeps the LAST of equal-s columns, rear the FIRST (PARITY #3),
    as JAX ``straight_fast._neigh`` does; -1 where JAX reports none."""
    s = np.array([[0.0, 50.0, 50.0, 100.0, 100.0, 20.0, 20.0, 75.0]], np.float32)
    lat = np.array([[0.0, 0.5, -0.5, 0.0, 9.0, 0.0, 1.0, 0.0]], np.float32)
    V = s.shape[1]
    occ = np.ones_like(s, bool)
    occ[0, 7] = False  # an unoccupiable slot is nobody's neighbour
    tol = 3.0
    front, rear = straight_frames.neighbours(
        torch.from_numpy(s), torch.from_numpy(lat), torch.from_numpy(occ),
        torch.zeros(1, 1, V), tol,
    )
    same_lane = (np.abs(lat[0][None, :] - 0.0) <= tol) & occ[0][None, :]
    fi, fe, ri, re = j_straight_fast._neigh(
        jnp.asarray(s[0]), jnp.asarray(np.broadcast_to(same_lane, (V, V))),
        jnp.asarray(s[0]), jnp.eye(V, dtype=bool),
    )
    np.testing.assert_array_equal(
        front[0, 0].numpy(), np.where(np.asarray(fe), np.asarray(fi), -1)
    )
    np.testing.assert_array_equal(
        rear[0, 0].numpy(), np.where(np.asarray(re), np.asarray(ri), -1)
    )
    # slot 0 sees the s=20 tie ahead and keeps slot 6; slot 3 sees the s=50
    # tie behind and keeps slot 1; slot 4 is off the lane
    assert front[0, 0, 0] == 6 and rear[0, 0, 3] == 1
    assert front[0, 0, 3] == -1 and rear[0, 0, 0] == -1


def report():
    """Print the largest |port - JAX| of each continuous field over every
    env, scene and step the test above runs, against each JAX path."""
    worst = {("pallas interpret", n): 0.0 for n in CONTINUOUS}
    worst.update({("XLA", n): 0.0 for n in CONTINUOUS})
    for env_id in ("highway-fast-v0", "highway-v0"):
        for scene in SCENES:
            for _, veh_t, veh_p, veh_x in _steps(env_id, scene):
                for path, ref in (("pallas interpret", veh_p),
                                  ("XLA", _clip_steering(veh_x))):
                    for n in CONTINUOUS:
                        err = np.abs(
                            getattr(veh_t, n).numpy().astype(np.float64)
                            - np.asarray(getattr(ref, n), np.float64)
                        ).max()
                        worst[path, n] = max(worst[path, n], float(err))
    for (path, n), err in worst.items():
        print(f"max |port - JAX {path}| {n}: {err:.3e}")


if __name__ == "__main__":
    # python tests/test_torch_straight_frames.py (JAX on the CPU)
    jax.config.update("jax_platforms", "cpu")
    report()
