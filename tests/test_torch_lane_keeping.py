"""lane-keeping-v0 against the JAX package, on the CPU.

The port's ``envs/lane_keeping.py`` (a dynamical ContinuousAction ego on
the tire-slip model, the AttributesObservation dict) against
``highwayenv_tpu/envs/lane_keeping.py``, with the observation noise off
(``state_noise = derivative_noise = 0``: the JAX package draws it from its
state's key, the port from the generator): 36 steps of ``step_batched``
from a port reset batch, each from the JAX state of the step before, past
the end of the lane ("c", "d") where the tracked-lane cursor (the ego's
``route_ptr``) moves to the sine lane: the pre-step observation key by key,
the reward within 1e-5, the flags, cursor and lanes exactly, pos within
2e-4 m; then the truncation at 200 steps and its autoreset
(``step_autoreset_batched``, whose reset scene is deterministic).

With the noise on: the noise lies in [-0.05, 0.05], differs between steps
and rows, and the same seed gives the same observations; the compact
autoreset equals the full one key by key; the rollouts and the vector env
carry the dict.
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
from highwayenv_tpu.vehicle.state import VehicleState as JaxVehicleState
from highwayenv_tpu_torch.bridge import to_numpy_state
from highwayenv_tpu_torch.envs.lane_keeping import LaneKeepingState
from highwayenv_tpu_torch.parallel.rollout import obs_sum, rollout
from highwayenv_tpu_torch.vehicle.state import VehicleState

torch.set_num_threads(1)

ENV_ID = "lane-keeping-v0"
QUIET = {"state_noise": 0.0, "derivative_noise": 0.0}
KEYS = ("state", "derivative", "reference_state")
B = 8
DISCRETE = ("lane", "target_lane", "route_ptr", "crashed", "hit", "kind")
HEAD_ATOL = 1e-5
POS_ATOL = 2e-4
REL_TOL = 1e-4


def _jax_state(states, seed: int) -> JaxEnvState:
    d = to_numpy_state(states)
    return JaxEnvState(
        vehicles=JaxVehicleState(**{k: jnp.asarray(v) for k, v in d["vehicles"].items()}),
        time=jnp.asarray(d["time"]), steps=jnp.asarray(d["steps"]),
        key=jax.random.split(jax.random.PRNGKey(seed), d["time"].shape[0]),
    )


def _port_state(sj, noise: torch.Tensor) -> LaneKeepingState:
    return LaneKeepingState(
        vehicles=VehicleState(**{f.name: torch.from_numpy(np.array(getattr(sj.vehicles, f.name)))
                                 for f in dataclasses.fields(VehicleState)}),
        time=torch.from_numpy(np.array(sj.time)), steps=torch.from_numpy(np.array(sj.steps)),
        noise=noise,
    )


def _close(a, b, atol, where):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=atol, err_msg=where)


def _check_step(out_t, out_j, where: str) -> None:
    obs_t, st_t, rew_t, term_t, trunc_t, info_t = out_t
    obs_j, st_j, rew_j, term_j, trunc_j, info_j = out_j
    assert set(obs_t) == set(obs_j) == set(KEYS)
    for k in KEYS:
        assert obs_t[k].shape == (obs_t[k].shape[0], 4, 1)
        _close(obs_t[k], obs_j[k], HEAD_ATOL, f"{where} obs {k}")
    _close(rew_t, rew_j, HEAD_ATOL, f"{where} reward")
    np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j), err_msg=where)
    np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j), err_msg=where)
    assert info_t == {} and not info_j
    vt, vj = st_t.vehicles, st_j.vehicles
    np.testing.assert_array_equal(st_t.steps.numpy(), np.asarray(st_j.steps), err_msg=where)
    for name in DISCRETE:
        np.testing.assert_array_equal(getattr(vt, name).numpy(), np.asarray(getattr(vj, name)),
                                      err_msg=f"{where} {name}")
    for name in ("pos", "heading", "speed", "lateral_speed", "yaw_rate", "steering"):
        b = np.asarray(getattr(vj, name))
        tol = POS_ATOL if name == "pos" else REL_TOL * max(1.0, float(np.abs(b).max()))
        _close(getattr(vt, name).numpy(), b, tol, f"{where} {name}")


def _steer(step: int, batch: int) -> torch.Tensor:
    """Small steering (a few degrees), which keeps most egos near the lane."""
    rng = np.random.default_rng(100 + step)
    return torch.from_numpy(rng.normal(0.0, 0.05, (batch, 1)).astype(np.float32))


def test_steps_match_jax_past_the_end_of_lane_cd():
    et, ej = ht.make(ENV_ID, QUIET, device="cpu"), hj.make(ENV_ID, QUIET)
    assert et._general.dynamical and et.frames_per_step == 1 and et.observes_before_step
    step_j = jax.jit(ej.step_batched)
    gen = et.generator(0)
    _, st = et.reset(B, gen)
    lane_cd, lane_da = (et.net.global_lane_index(e) for e in (("c", "d", 0), ("d", "a", 0)))
    assert st.vehicles.lane[:, 0].tolist() == [lane_cd] * B
    sj = _jax_state(st, 0)
    cursor_moved = target_moved = False
    for step in range(36):
        acts = _steer(step, B)
        out_j = step_j(sj, jnp.asarray(acts.numpy()))
        out_t = et.step_batched(st, acts, gen)
        _check_step(out_t, out_j, f"step {step}")
        cursor_moved |= bool((out_t[1].vehicles.route_ptr[:, 0] == 1).any())
        target_moved |= bool((out_t[1].vehicles.target_lane[:, 0] == lane_da).any())
        sj = out_j[1]
        st = _port_state(sj, out_t[1].noise)
    # past the end of ("c", "d"): the target lane followed it onto ("d", "a"),
    # and the cursor moved on to the sine lane
    assert cursor_moved and target_moved
    assert bool((st.vehicles.route_ptr[:, 0] == 1).all())


def test_truncation_at_200_steps_and_its_autoreset_match_jax():
    et, ej = ht.make(ENV_ID, QUIET, device="cpu"), hj.make(ENV_ID, QUIET)
    step_j = jax.jit(ej.step_autoreset_batched)
    gen = et.generator(1)
    _, fresh = et.reset(B, gen)
    _, st = et.reset(B, gen)
    st = st.replace(steps=torch.full((B,), 198, dtype=torch.int32))
    sj = _jax_state(st, 1)
    for step, ends in ((0, False), (1, True)):
        acts = _steer(step, B)
        out_j = step_j(sj, jnp.asarray(acts.numpy()))
        out_t = et.step_autoreset_batched(st, acts, gen)
        _check_step(out_t, out_j, f"step {199 + step}")
        assert out_t[4].tolist() == [ends] * B and not bool(out_t[3].any())
        sj = out_j[1]
        st = _port_state(sj, out_t[1].noise)
    # the truncated rows were reset: the fresh scene
    reset = out_t[1]
    for f in dataclasses.fields(VehicleState):
        assert torch.equal(getattr(reset.vehicles, f.name), getattr(fresh.vehicles, f.name)), f.name
    assert reset.steps.tolist() == [0] * B


def test_observation_noise_is_bounded_fresh_and_seeded():
    """A step observes its pre-step state (the cursor moved) with the noise
    it drew, which the returned state keeps; the reset observes its scene
    with the reset batch's noise."""
    et = ht.make(ENV_ID, device="cpu")
    assert et.config["state_noise"] == et.config["derivative_noise"] == 0.05

    def run(seed):
        gen = et.generator(seed)
        obs, st = et.reset(16, gen)
        out = [(obs, st)]
        for step in range(3):
            prev = st
            obs, st, *_ = et.step_autoreset_batched(st, _steer(step, 16), gen)
            observed = prev.replace(
                vehicles=prev.vehicles.replace(route_ptr=st.vehicles.route_ptr),
                noise=st.noise)
            out.append((obs, observed))
        return out

    first, again = run(7), run(7)
    for (obs, observed), (obs2, _) in zip(first, again, strict=True):
        for k in KEYS:
            assert torch.equal(obs[k], obs2[k]), k
        assert torch.equal(obs["state"], et._lateral_state(observed) + observed.noise[:, 0])
        quiet = observed.replace(noise=torch.zeros_like(observed.noise))
        assert torch.equal(obs["derivative"], et.attr_derivative(quiet) + observed.noise[:, 1])
        # the reference state carries no noise
        assert torch.equal(obs["reference_state"], et.attr_reference_state(observed))
    noise = torch.stack([observed.noise for _, observed in first])  # (steps, B, 2, 4, 1)
    assert bool((noise.abs() <= 0.05).all()) and float(noise.abs().max()) > 0.04
    # fresh each step and each row
    assert bool((noise[1:] != noise[:-1]).all())
    assert bool((noise[:, 1:] != noise[:, :-1]).all())
    other = run(8)
    assert not torch.equal(other[1][0]["state"], first[1][0]["state"])


@pytest.mark.parametrize("slots", [1, 4])
def test_compact_autoreset_matches_full_key_by_key(slots):
    """Every other row at step 199: those rows are truncated and placed
    one (or four) at a time, their observation noise drawn with the reset
    batch; every key of the observation and every field as the full
    autoreset's, bit for bit."""
    et = ht.make(ENV_ID, device="cpu")
    _, st = et.reset(B, et.generator(2))
    steps = torch.zeros(B, dtype=torch.int32)
    steps[::2] = 199
    st = st.replace(steps=steps)
    acts = _steer(0, B)
    full = et.step_autoreset_batched(st, acts, et.generator(9))
    compact = et.step_autoreset_batched(st, acts, et.generator(9), reset_slots=slots)
    assert full[4].tolist() == [True, False] * (B // 2)
    for k in KEYS:
        assert torch.equal(compact[0][k], full[0][k]), k
    for f in dataclasses.fields(VehicleState):
        assert torch.equal(getattr(compact[1].vehicles, f.name),
                           getattr(full[1].vehicles, f.name)), f.name
    assert torch.equal(compact[1].noise, full[1].noise)
    for a, b in zip(compact[2:5], full[2:5]):
        assert torch.equal(a, b)
    # the done rows observe their fresh scene, the others their pre-step state
    assert full[1].steps.tolist() == [0, 1] * (B // 2)


def test_lane_keeping_through_rollouts_and_the_vector_env():
    et = ht.make(ENV_ID, device="cpu")
    gen = et.generator(0)
    _, st = et.reset(4, gen)
    for kw in ({}, {"compact_reset": 2}, {"fresh_pool": 2}):
        st2, metrics = rollout(et, st, 3, gen, **kw)
        assert isinstance(st2, LaneKeepingState)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
    obs, _ = et.reset(2, gen)
    assert torch.equal(obs_sum(obs), sum(obs[k].sum() for k in obs))

    import gymnasium

    envs = ht.make_vec(ENV_ID, 3, device="cpu")
    assert isinstance(envs.single_observation_space, gymnasium.spaces.Dict)
    assert envs.single_action_space == gymnasium.spaces.Box(-1.0, 1.0, (1,), np.float32)
    obs, _ = envs.reset(seed=1)
    assert set(obs) == set(KEYS) and obs["state"].shape == (3, 4, 1)
    obs, reward, term, trunc, info = envs.step(envs.action_space.sample())
    assert obs["derivative"].shape == (3, 4, 1) and reward.shape == (3,)
    assert np.isfinite(reward).all() and not term.any()
