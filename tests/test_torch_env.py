"""The port's batched env step, reset and rollout against the JAX package, on
the CPU.

One ``step_autoreset_batched`` from a JAX reset batch carried across with
the same actions: obs, reward, terminated, truncated, info and the state of
the rows that are not done match the JAX step (which takes the XLA frame
scan on the CPU); the done rows equal the port's own ``_reset`` drawn from a
clone of the step's generator.  Each batch has rows with a crashed ego or
with ``time`` one policy step short of ``duration``, so both ends of an
episode are exercised.

Tolerances: booleans exact; state as in test_torch_straight_frames.py
(pos 2e-4 m, other continuous fields 1e-4 of their magnitude); obs and
reward 1e-5 absolute: they are positions and speeds within those tolerances
divided by normalization ranges of 8 m and more, then mapped into [-1, 1].

The port draws its scenes from a ``torch.Generator`` where the JAX package
splits threefry keys, so resets are compared by their invariants and by
two-sample KS tests of the drawn quantities.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy import stats

import highwayenv_tpu as hj
import highwayenv_tpu_torch as ht
from highwayenv_tpu.vehicle import controller as j_controller
from highwayenv_tpu_torch.bridge import from_numpy_state
from highwayenv_tpu_torch.ops import straight_frames
from highwayenv_tpu_torch.parallel.rollout import rollout
from highwayenv_tpu_torch.vehicle import controller as t_controller
from highwayenv_tpu_torch.vehicle.state import KIND_EGO, KIND_IDM, VehicleState

torch.set_num_threads(1)

B = 8
ENV_IDS = ["highway-fast-v0", "highway-v0"]
STATE_DISCRETE = ("lane", "target_lane", "crashed", "hit", "impact_pending",
                  "speed_index", "kind")
STATE_CONTINUOUS = ("pos", "heading", "speed", "target_speed", "timer",
                    "impact", "steering", "accel")
HEAD_ATOL = 1e-5

_SETUP: dict = {}


def _setup(env_id):
    """JAX env, port env, a JAX reset batch and the jitted JAX step, built
    once per env so the JAX step compiles once per test process."""
    if env_id not in _SETUP:
        ej = hj.make(env_id)
        et = ht.make(env_id, device="cpu")
        _, states = jax.vmap(ej._reset)(jax.random.split(jax.random.PRNGKey(3), B))
        _SETUP[env_id] = (ej, et, states, jax.jit(ej.step_autoreset_batched))
    return _SETUP[env_id]


def _numpy_state(states) -> dict:
    return {
        "vehicles": {
            f.name: np.asarray(getattr(states.vehicles, f.name))
            for f in dataclasses.fields(VehicleState)
        },
        "time": np.asarray(states.time),
        "steps": np.asarray(states.steps),
    }


def _ending(states, et, case):
    """Rows 0, 2, 4 and 6 end this step: a crashed ego, or one policy step
    left before ``duration``."""
    ending = np.arange(B) % 2 == 0
    if case == "crashed_ego":
        crashed = np.asarray(states.vehicles.crashed).copy()
        crashed[ending, 0] = True
        return states.replace(
            vehicles=states.vehicles.replace(crashed=jnp.asarray(crashed))
        )
    time = np.asarray(states.time).copy()
    time[ending] = et.config["duration"] - 1.0 / et.config["policy_frequency"]
    return states.replace(time=jnp.asarray(time))


def _close(a, b, atol, where):
    np.testing.assert_allclose(
        np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=0,
        atol=atol, err_msg=where,
    )


@pytest.mark.parametrize("case", ["crashed_ego", "near_duration"])
@pytest.mark.parametrize("env_id", ENV_IDS)
def test_step_autoreset_batched_matches_jax(env_id, case):
    ej, et, states, jstep = _setup(env_id)
    sj = _ending(states, et, case)
    st = from_numpy_state(_numpy_state(sj))
    acts = np.random.default_rng(11).integers(0, et.action_type.n, B).astype(np.int32)

    obs_j, st_j, rew_j, term_j, trunc_j, info_j = jstep(sj, jnp.asarray(acts))
    gen = et.generator(5)
    gen_clone = et.generator(0)
    gen_clone.set_state(gen.get_state())
    obs_t, st_t, rew_t, term_t, trunc_t, info_t = et.step_autoreset_batched(
        st, torch.from_numpy(acts), gen
    )

    # the head is computed on the simulated state of every row
    done = (term_t | trunc_t).numpy()
    np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j))
    np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j))
    assert done[::2].all() and not done[1::2].any()
    _close(rew_t, rew_j, HEAD_ATOL, "reward")
    _close(info_t["speed"], info_j["speed"], 1e-4 * 40.0, "info speed")
    np.testing.assert_array_equal(info_t["crashed"].numpy(), np.asarray(info_j["crashed"]))
    np.testing.assert_array_equal(info_t["action"].numpy(), np.asarray(info_j["action"]))
    assert set(info_t["rewards"]) == set(info_j["rewards"])
    for name, value in info_t["rewards"].items():
        _close(value, info_j["rewards"][name], HEAD_ATOL, f"info rewards {name}")

    # rows that go on: obs and state as the JAX step left them
    keep = ~done
    _close(obs_t.numpy()[keep], np.asarray(obs_j)[keep], HEAD_ATOL, "obs")
    np.testing.assert_array_equal(st_t.steps.numpy()[keep], np.asarray(st_j.steps)[keep])
    _close(st_t.time.numpy()[keep], np.asarray(st_j.time)[keep], 0, "time")
    for name in STATE_DISCRETE:
        np.testing.assert_array_equal(
            getattr(st_t.vehicles, name).numpy()[keep],
            np.asarray(getattr(st_j.vehicles, name))[keep], err_msg=name,
        )
    for name in STATE_CONTINUOUS:
        b = np.asarray(getattr(st_j.vehicles, name))[keep]
        tol = 2e-4 if name == "pos" else 1e-4 * max(1.0, float(np.abs(b).max()))
        _close(getattr(st_t.vehicles, name).numpy()[keep], b, tol, name)

    # done rows: the port's own reset from the generator as it stood
    obs_r, st_r = et._reset(B, gen_clone)
    np.testing.assert_array_equal(obs_t.numpy()[done], obs_r.numpy()[done])
    np.testing.assert_array_equal(st_t.time.numpy()[done], st_r.time.numpy()[done])
    np.testing.assert_array_equal(st_t.steps.numpy()[done], st_r.steps.numpy()[done])
    for f in dataclasses.fields(VehicleState):
        np.testing.assert_array_equal(
            getattr(st_t.vehicles, f.name).numpy()[done],
            getattr(st_r.vehicles, f.name).numpy()[done], err_msg=f.name,
        )


def _spawn_x(veh, is_torch):
    x = veh.pos[..., 0]
    return x.numpy() if is_torch else np.asarray(x)


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_reset_invariants_and_distribution_match_jax(env_id):
    n = 256
    ej, et, _, _ = _setup(env_id)
    _, st = et.reset(n, et.generator(1))
    _, sj = jax.jit(jax.vmap(ej._reset))(jax.random.split(jax.random.PRNGKey(2), n))
    veh, vj = st.vehicles, sj.vehicles
    cfg = et.config
    lanes = cfg["lanes_count"]

    kind = veh.kind.numpy()
    assert (kind[:, 0] == KIND_EGO).all() and (kind[:, 1:] == KIND_IDM).all()
    assert et.ego_slots == (0,)
    assert (veh.speed[:, 0] == 25.0).all()
    lane = veh.lane.numpy()
    assert lane.dtype == np.int32 and ((0 <= lane) & (lane < lanes)).all()
    assert (veh.target_lane == veh.lane).all()
    assert (st.time == 0).all() and (st.steps == 0).all()
    assert veh.crashed.dtype == torch.bool and not veh.crashed.any()

    # spawn chain: each slot ahead of the previous by offset * U[0.9, 1.1],
    # offset = spacing * (12 + speed) * exp(-5/40 * lanes); slot 0 adds a
    # head start of 3 offsets
    spacing = np.where(np.arange(et.num_slots) == 0, cfg["ego_spacing"],
                       1.0 / cfg["vehicles_density"])
    offset = spacing * (12.0 + veh.speed.numpy()) * np.exp(-5.0 / 40.0 * lanes)
    gaps = np.diff(_spawn_x(veh, True), axis=1, prepend=0.0)
    ratio = gaps / offset
    ratio[:, 0] -= 3.0
    assert (ratio >= 0.9 - 1e-5).all() and (ratio <= 1.1 + 1e-5).all()

    # the drawn quantities, port against JAX
    samples = {
        "npc speed": (veh.speed[:, 1:].numpy(), np.asarray(vj.speed)[:, 1:]),
        "npc gap": (gaps[:, 1:], np.diff(_spawn_x(vj, False), axis=1)),
        "npc delta": (veh.delta[:, 1:].numpy(), np.asarray(vj.delta)[:, 1:]),
        "lane": (lane, np.asarray(vj.lane)),
    }
    for name, (a, b) in samples.items():
        p = stats.ks_2samp(a.ravel(), b.ravel()).pvalue
        assert p > 1e-3, f"{name}: KS p-value {p}"


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_action_mask_and_steering_match_jax(env_id):
    """The ego's available meta-actions and the P-cascade steering of every
    slot, from positions pushed off the lane centres (some beyond the road
    edge), random headings and speed indices."""
    ej, et, states, _ = _setup(env_id)
    rng = np.random.default_rng(4)
    veh = states.vehicles
    shape = np.asarray(veh.speed).shape
    pos = np.asarray(veh.pos).copy()
    pos[..., 1] += rng.uniform(-6.0, 6.0, shape).astype(np.float32)
    veh = veh.replace(
        pos=jnp.asarray(pos),
        heading=jnp.asarray(rng.uniform(-0.4, 0.4, shape).astype(np.float32)),
        speed_index=jnp.asarray(rng.integers(0, 3, shape).astype(np.int32)),
    )
    vt = from_numpy_state(_numpy_state(states.replace(vehicles=veh))).vehicles

    mask_j = jax.vmap(lambda v: ej.action_type.available_actions_mask(ej.geo, v, 0))(veh)
    mask_t = et.action_type.available_actions_mask(et.geo, vt, 0)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    assert not mask_t[:, 0].all() and not mask_t[:, 2].all()  # edges reached

    steer_j = j_controller.steering_control(
        ej.geo, veh.target_lane, veh.pos, veh.heading, veh.speed, veh.length
    )
    steer_t = t_controller.steering_control(
        et.geo, vt.target_lane, vt.pos, vt.heading, vt.speed, vt.length
    )
    # asin / atan2 / sin / cos of the two CPU libms differ by about an ulp
    _close(steer_t, steer_j, 1e-5, "steering")


@pytest.mark.parametrize(
    "observation",
    [
        {"features": ["presence", "x", "y", "vx", "vy", "heading", "cos_h", "sin_h"],
         "vehicles_count": 8, "see_behind": True},
        {"absolute": True, "normalize": False, "vehicles_count": 4},
        {"features_range": {"x": [-50, 50], "y": [-8, 8], "vx": [-10, 10],
                            "vy": [-10, 10]}, "clip": False},
    ],
    ids=["heading_features", "absolute_raw", "own_ranges"],
)
def test_kinematics_observation_options_match_jax(observation):
    """The Kinematics options the reference config exposes, on the same
    scene compressed so neighbours fall inside and outside every range."""
    config = {"observation": {"type": "Kinematics", **observation}}
    ej = hj.make("highway-fast-v0", config)
    et = ht.make("highway-fast-v0", config, device="cpu")
    _, states = jax.vmap(ej._reset)(jax.random.split(jax.random.PRNGKey(6), B))
    pos = np.asarray(states.vehicles.pos).copy()
    pos[..., 0] *= 0.5
    states = states.replace(vehicles=states.vehicles.replace(pos=jnp.asarray(pos)))
    obs_j = jax.vmap(ej._observe)(states)
    obs_t = et._observe(from_numpy_state(_numpy_state(states)))
    assert obs_t.shape == obs_j.shape
    # absolute positions run to ~500 m, where a float32 ulp is 3e-5
    _close(obs_t, obs_j, 1e-4 if observation.get("absolute") else HEAD_ATOL, "obs")


def test_rollout_on_the_cpu_is_finite_and_launches_no_kernel():
    et = ht.make("highway-fast-v0", device="cpu")
    gen = et.generator(0)
    _, states = et.reset(4, gen)
    before = straight_frames.frames_kernel.launches
    states, metrics = rollout(et, states, 3, gen)
    assert straight_frames.frames_kernel.launches == before
    assert set(metrics) == {"mean_reward", "done_rate", "obs_checksum"}
    for name, value in metrics.items():
        assert value.shape == () and bool(torch.isfinite(value)), name
    assert 0.0 <= float(metrics["mean_reward"]) <= 1.0
    assert bool(torch.isfinite(states.vehicles.pos).all())
    assert (states.steps % et.frames_per_step == 0).all()
