"""The multi-agent intersection against the JAX package, on the CPU.

intersection-multi-agent-v0 and -v2 (the latter with the connected-lane
search): two egos in slots 24 and 25, a MultiAgentAction of
DiscreteMetaActions ((B, 2) actions, agent k's to slot ``ego_slots[k]``)
and a MultiAgentObservation (a tuple of two (B, 15, 7) Kinematics
observations).  Three policy steps of ``step_batched`` from a port reset
batch, each from the JAX state of the step before, no spawns
(``spawn_probability`` 0: the JAX package draws them from its own keys):
each element of the observation, reward, terminated, truncated,
``agents_rewards`` and ``agents_terminated`` within 1e-5 (flags exactly),
discrete state exactly, pos, speed and heading within 5e-4.  Then the
compact autoreset against the full one with the tuple observation, the
vector env's Tuple spaces, and -v1, which makes and steps as -v0 does.
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
from highwayenv_tpu_torch.bridge import from_numpy_state, to_numpy_state
from highwayenv_tpu_torch.envs.base import map_obs
from highwayenv_tpu_torch.parallel.rollout import obs_sum, random_actions, rollout
from highwayenv_tpu_torch.vehicle.state import VehicleState

torch.set_num_threads(1)

B = 4
IDS = ["intersection-multi-agent-v0", "intersection-multi-agent-v2"]
CONFIG = {"spawn_probability": 0.0}
DISCRETE = ("lane", "target_lane", "route_ptr", "crashed", "hit", "impact_pending",
            "speed_index", "kind", "is_yielding", "yield_timer")
STEP_ATOL = {"pos": 5e-4, "speed": 5e-4, "heading": 5e-4}
HEAD_ATOL = 1e-5


def _jax_state(states, seed: int):
    d = to_numpy_state(states)
    return JaxEnvState(
        vehicles=JaxVehicleState(**{k: jnp.asarray(v) for k, v in d["vehicles"].items()}),
        time=jnp.asarray(d["time"]), steps=jnp.asarray(d["steps"]),
        key=jax.random.split(jax.random.PRNGKey(seed), d["time"].shape[0]),
    )


def _port_state(states):
    return from_numpy_state({
        "vehicles": {f.name: np.asarray(getattr(states.vehicles, f.name))
                     for f in dataclasses.fields(VehicleState)},
        "time": np.asarray(states.time), "steps": np.asarray(states.steps),
    })


def _same(a, b, where):
    """Exact for integers and booleans, within 4 ulp at the magnitude for
    floats."""
    a, b = a.numpy(), b.numpy()
    if not np.issubdtype(b.dtype, np.floating):
        np.testing.assert_array_equal(a, b, err_msg=where)
        return
    scale = np.spacing(np.float32(max(float(np.abs(b).max(initial=0.0)), 1e-30)))
    np.testing.assert_allclose(a, b, rtol=0, atol=4 * scale, err_msg=where)


def _close(a, b, atol, where):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=atol, err_msg=where)


@pytest.mark.parametrize("env_id", IDS)
def test_steps_match_jax(env_id):
    ej, et = hj.make(env_id, CONFIG), ht.make(env_id, CONFIG, device="cpu")
    assert et.ego_slots == ej.ego_slots == (24, 25) and et.num_slots == ej.num_slots == 26
    assert et._general.connected == env_id.endswith("v2")
    step_j = jax.jit(ej.step_batched)
    gen = et.generator(4)
    _, st = et.reset(B, gen)
    sj = _jax_state(st, 4)
    for step in range(3):
        acts = random_actions(et, B, gen)
        assert acts.shape == (B, 2) and acts.dtype == torch.int32
        obs_j, sj, rew_j, term_j, trunc_j, info_j = step_j(sj, jnp.asarray(acts.numpy()))
        obs_t, st_t, rew_t, term_t, trunc_t, info_t = et.step_batched(
            st, acts, et.generator(100 + step))
        where = f"{env_id} step {step}"
        assert isinstance(obs_t, tuple) and len(obs_t) == len(obs_j) == 2
        for k, (a, b) in enumerate(zip(obs_t, obs_j, strict=True)):
            assert a.shape == (B, 15, 7)
            _close(a, b, HEAD_ATOL, f"{where} obs {k}")
        _close(rew_t, rew_j, HEAD_ATOL, f"{where} reward")
        np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j))
        np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j))
        for a, b in zip(info_t["agents_rewards"], info_j["agents_rewards"], strict=True):
            _close(a, b, HEAD_ATOL, f"{where} agents_rewards")
        for a, b in zip(info_t["agents_terminated"], info_j["agents_terminated"],
                        strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # the reward is the agents' mean; terminated: an ego crashed or both arrived
        mean = (info_t["agents_rewards"][0] + info_t["agents_rewards"][1]) / 2
        assert torch.equal(rew_t, mean)
        vt, vj = st_t.vehicles, sj.vehicles
        for name in DISCRETE:
            np.testing.assert_array_equal(getattr(vt, name).numpy(),
                                          np.asarray(getattr(vj, name)),
                                          err_msg=f"{where} {name}")
        for name in ("pos", "heading", "speed", "target_speed", "timer", "steering", "accel"):
            b = np.asarray(getattr(vj, name))
            tol = STEP_ATOL.get(name, 1e-4 * max(1.0, float(np.abs(b).max())))
            _close(getattr(vt, name).numpy(), b, tol, f"{where} {name}")
        st = _port_state(sj)


def test_actions_go_to_both_ego_slots():
    et = ht.make("intersection-multi-agent-v0", device="cpu")
    acts = torch.tensor([[0, 2], [1, 0], [2, 1]], dtype=torch.int32)
    slots = et._action_to_slots(acts)
    assert slots.shape == (3, 26) and slots.dtype == torch.int32
    assert torch.equal(slots[:, 24], acts[:, 0]) and torch.equal(slots[:, 25], acts[:, 1])
    assert int(slots[:, :24].abs().sum()) == 0
    assert et.action_shape == (2,) and et.action_type.n_agents == 2
    assert ht.make("intersection-v0", device="cpu").action_shape == ()
    # the egos start on corners 0 and 1, routed to o1
    _, st = et.reset(3, et.generator(0))
    lanes = st.vehicles.lane[:, 24:].tolist()
    assert all(row == et._spawn_lane[:2].tolist() for row in lanes)


@pytest.mark.parametrize("slots", [1, 4])
def test_compact_autoreset_matches_full_with_the_tuple_observation(slots):
    """Every other env's first ego crashed: those rows end and are placed
    one (or four) at a time; every element of the tuple observation and
    every field as the full autoreset's: integers and flags exactly, floats
    within 4 ulp at the field's magnitude, since the CPU's vectorized libm
    may round a row warmed up among P rows differently from the same row
    among B (test_torch_compact_autoreset.py; chip_smoke.py holds them
    bit-exact on the card)."""
    et = ht.make("intersection-multi-agent-v0", device="cpu")
    _, st = et.reset(B, et.generator(2))
    crashed = st.vehicles.crashed.clone()
    crashed[::2, 24] = True
    st = st.replace(vehicles=st.vehicles.replace(crashed=crashed))
    acts = random_actions(et, B, et.generator(3))
    full = et.step_autoreset_batched(st, acts, et.generator(9))
    compact = et.step_autoreset_batched(st, acts, et.generator(9), reset_slots=slots)
    done = full[3] | full[4]
    assert done.tolist() == [True, False, True, False]
    assert isinstance(compact[0], tuple) and len(compact[0]) == 2
    for k, (a, b) in enumerate(zip(compact[0], full[0], strict=True)):
        _same(a, b, f"obs {k}")
    for f in dataclasses.fields(VehicleState):
        _same(getattr(compact[1].vehicles, f.name), getattr(full[1].vehicles, f.name), f.name)
    for name, a, b in zip(("reward", "terminated", "truncated"), compact[2:5], full[2:5]):
        _same(a, b, name)
    # the observation helpers carry the tuple
    doubled = map_obs(lambda o: 2 * o, full[0])
    assert isinstance(doubled, tuple) and torch.equal(doubled[1], 2 * full[0][1])
    assert torch.equal(obs_sum(full[0]), full[0][0].sum() + full[0][1].sum())


def test_rollout_and_vector_env_take_tuples():
    et = ht.make("intersection-multi-agent-v0", device="cpu")
    gen = et.generator(0)
    _, st = et.reset(2, gen)
    st, metrics = rollout(et, st, 2, gen, compact_reset=1)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())

    import gymnasium

    envs = ht.make_vec("intersection-multi-agent-v0", 2, device="cpu")
    assert envs.single_action_space == gymnasium.spaces.Tuple(
        [gymnasium.spaces.Discrete(3)] * 2)
    obs, _ = envs.reset(seed=1)
    assert isinstance(obs, tuple) and obs[0].shape == (2, 15, 7)
    obs, reward, term, trunc, info = envs.step(envs.action_space.sample())
    assert isinstance(obs, tuple) and len(obs) == 2 and reward.shape == (2,)
    assert len(info["agents_rewards"]) == 2


def test_multi_agent_v1_waits_for_seeding():
    """-v1 no longer waits: it makes and steps as -v0 does, from a reset
    batch and from a seeded reset (``seeding.py``)."""
    env = ht.make("intersection-multi-agent-v1", CONFIG, device="cpu")
    gen = env.generator(0)
    _, states = env.reset(B, gen)
    obs, states, reward, _, _, info = env.step_batched(
        states, random_actions(env, B, gen), gen)
    assert isinstance(obs, tuple) and obs[0].shape == (B, 15, 7) and reward.shape == (B,)
    assert len(info["agents_rewards"]) == 2
    obs, state = env.reset_seeded(seed=0)
    assert obs[0].shape == (1, 15, 7) and (state.vehicles.kind[0, [24, 25]] == 1).all()
