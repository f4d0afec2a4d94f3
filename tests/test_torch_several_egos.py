"""Several controlled vehicles on the highway, parking and racetrack
families, against the JAX package, on the CPU.

highway-fast-v0 and highway-v0 with 2 egos (slots 0 and 11, and 0 and 26:
each ego ahead of its share of the NPCs, V=22 and 52), parking-v0 with 2
and 3, parking-parked-v0 with 2 and racetrack-v0 with 2 (slots 0 and 1):
three policy steps of ``step_batched`` from a port reset batch, each from
the JAX state of the step before.  Discrete fields exactly; pos within 2e-4
m on the straight road, 5e-4 m on the general one; the other continuous
fields within 1e-4 of their magnitude; every element of the tuple
observation (a dict's every key) and the reward within 1e-5.

The racetrack's reward is one number an env: its action term is the norm of
all the egos' actions together, the reference's ``np.linalg.norm`` of the
action tuple; the JAX package takes one norm per agent and gives (B, n)
rewards, so the port's is held to the JAX ``_reward`` of the action
flattened to (B, n * size).

Then the seeded several-ego resets bit for bit, the compact autoreset with
parking's tuple of dicts, the agents' actions scattered to their slots, the
spaces, exit-v0's refusal, and a multi-agent highway episode through
``GymEnv``.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import highwayenv_tpu as hj
import highwayenv_tpu.seeding as sj_seeding
import highwayenv_tpu_torch as ht
import highwayenv_tpu_torch.seeding as st_seeding
from highwayenv_tpu.envs.base import EnvState as JaxEnvState
from highwayenv_tpu.vehicle.state import VehicleState as JaxVehicleState
from highwayenv_tpu_torch.bridge import from_numpy_state
from highwayenv_tpu_torch.parallel.rollout import obs_sum, random_actions, rollout
from highwayenv_tpu_torch.vehicle.state import KIND_EGO, VehicleState

torch.set_num_threads(1)

B = 4
CASES = [
    ("highway-fast-v0", 2, (0, 11)),
    ("highway-v0", 2, (0, 26)),
    ("parking-v0", 2, (0, 1)),
    ("parking-v0", 3, (0, 1, 2)),
    ("parking-parked-v0", 2, (0, 1)),
    ("racetrack-v0", 2, (0, 1)),
]
DISCRETE = ("lane", "target_lane", "crashed", "hit", "impact_pending", "speed_index", "kind")
CONTINUOUS = ("heading", "speed", "target_speed", "timer", "steering", "accel")
HEAD_ATOL = 1e-5
MULTI = {
    "observation": {"type": "MultiAgentObservation",
                    "observation_config": {"type": "Kinematics"}},
    "action": {"type": "MultiAgentAction",
               "action_config": {"type": "DiscreteMetaAction"}},
}


def _jax_state(states) -> JaxEnvState:
    veh = JaxVehicleState(**{f.name: jnp.asarray(getattr(states.vehicles, f.name).numpy())
                             for f in dataclasses.fields(VehicleState)})
    return JaxEnvState(vehicles=veh, time=jnp.asarray(states.time.numpy()),
                       steps=jnp.asarray(states.steps.numpy()),
                       key=jax.random.split(jax.random.PRNGKey(1), states.time.shape[0]))


def _port_state(sj):
    return from_numpy_state({
        "vehicles": {f.name: np.asarray(getattr(sj.vehicles, f.name))
                     for f in dataclasses.fields(VehicleState)},
        "time": np.asarray(sj.time), "steps": np.asarray(sj.steps),
    })


def _close(a, b, atol, where):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=atol, err_msg=where)


def _close_obs(obs_t, obs_j, where):
    """Every element of a tuple observation, every key of a dict one."""
    if isinstance(obs_t, tuple):
        assert isinstance(obs_j, tuple) and len(obs_t) == len(obs_j), where
        for k, (a, b) in enumerate(zip(obs_t, obs_j)):
            _close_obs(a, b, f"{where} agent {k}")
    elif isinstance(obs_t, dict):
        assert obs_t.keys() == obs_j.keys(), where
        for key in obs_t:
            _close(obs_t[key].numpy(), obs_j[key], HEAD_ATOL, f"{where} {key}")
    else:
        _close(obs_t.numpy(), obs_j, HEAD_ATOL, where)


@pytest.mark.parametrize("env_id,egos,slots", CASES)
def test_torch_several_egos_step_like_jax(env_id, egos, slots):
    config = {"controlled_vehicles": egos}
    et, ej = ht.make(env_id, config, device="cpu"), hj.make(env_id, config)
    assert et.ego_slots == ej.ego_slots == slots and et.num_slots == ej.num_slots
    assert et.several_egos and et.action_shape[0] == egos
    straight = et._straight is not None
    step_j = jax.jit(ej.step_batched)
    gen = et.generator(7)
    _, st = et.reset(B, gen)
    assert (st.vehicles.kind[:, list(slots)] == KIND_EGO).all()
    assert int((st.vehicles.kind == KIND_EGO).sum()) == B * egos
    sj = _jax_state(st)
    for step in range(3):
        where = f"{env_id} x{egos} step {step}"
        acts = random_actions(et, B, gen)
        assert acts.shape == (B,) + et.action_shape
        obs_j, sj_next, rew_j, term_j, trunc_j, _ = step_j(sj, jnp.asarray(acts.numpy()))
        obs_t, st_t, rew_t, term_t, trunc_t, info_t = et.step_batched(
            st, acts, et.generator(100 + step))
        assert isinstance(obs_t, tuple) and len(obs_t) == egos
        _close_obs(obs_t, obs_j, f"{where} obs")
        if env_id.startswith("racetrack"):
            # one reward an env: the JAX _reward of the flattened action
            flat = jnp.asarray(acts.numpy().reshape(B, -1))
            rew_j = jax.vmap(ej._reward)(sj_next, flat)
            assert np.asarray(rew_j).shape == (B,) and rew_t.shape == (B,)
            assert info_t["rewards"]["action_reward"].shape == (B,)
            _close(info_t["rewards"]["action_reward"],
                   np.linalg.norm(acts.numpy().reshape(B, -1), axis=-1), 1e-6,
                   f"{where} action_reward")
        _close(rew_t, rew_j, HEAD_ATOL, f"{where} reward")
        np.testing.assert_array_equal(term_t.numpy(), np.asarray(term_j), err_msg=where)
        np.testing.assert_array_equal(trunc_t.numpy(), np.asarray(trunc_j), err_msg=where)
        vt, vj = st_t.vehicles, sj_next.vehicles
        for name in DISCRETE:
            np.testing.assert_array_equal(getattr(vt, name).numpy(),
                                          np.asarray(getattr(vj, name)),
                                          err_msg=f"{where} {name}")
        _close(vt.pos.numpy(), vj.pos, 2e-4 if straight else 5e-4, f"{where} pos")
        for name in CONTINUOUS:
            b = np.asarray(getattr(vj, name))
            _close(getattr(vt, name).numpy(), b, 1e-4 * max(1.0, float(np.abs(b).max())),
                   f"{where} {name}")
        sj = sj_next
        st = _port_state(sj)


def _same_state(state_t, state_j, where: str) -> None:
    for f in dataclasses.fields(VehicleState):
        a = getattr(state_t.vehicles, f.name)[0].numpy()
        b = np.asarray(getattr(state_j.vehicles, f.name))
        assert a.dtype == b.dtype and np.array_equal(a, b), (where, f.name)


@pytest.mark.parametrize("env_id,egos", [("highway-v0", 2), ("parking-v0", 3),
                                         ("racetrack-v0", 2)])
def test_torch_several_egos_seeded_reset_bit_equal(env_id, egos):
    config = {"controlled_vehicles": egos}
    et, ej = ht.make(env_id, config, device="cpu"), hj.make(env_id, config)
    assert st_seeding.supports_seeded_reset(et)
    for seed in (0, 3, 11):
        rj, rt = sj_seeding.np_random(seed), st_seeding.np_random(seed)
        obs_j, state_j = sj_seeding.seeded_reset(ej, rj)
        obs_t, state_t = et.reset_seeded(rng=rt)
        _same_state(state_t, state_j, f"{env_id} seed {seed}")
        assert int((state_t.vehicles.kind[0] == KIND_EGO).sum()) == egos
        assert rt.random() == rj.random()
        for k, (a, b) in enumerate(zip(obs_t, obs_j, strict=True)):
            if isinstance(a, dict):
                for key in a:
                    _close(a[key][0].numpy(), b[key], HEAD_ATOL, f"{env_id} {seed} {k}")
            else:
                _close(a[0].numpy(), b, HEAD_ATOL, f"{env_id} {seed} {k}")


@pytest.mark.parametrize("slots", [1, 4])
def test_torch_compact_autoreset_with_a_tuple_of_dicts(slots):
    """parking-v0 with 2 egos observes a tuple of two KinematicsGoal dicts:
    every other env's first ego crashed, those rows end and are placed one
    (or four) at a time; every key of every agent's observation and every
    field as the full autoreset's."""
    et = ht.make("parking-v0", {"controlled_vehicles": 2}, device="cpu")
    B8 = 8
    _, st = et.reset(B8, et.generator(2))
    crashed = st.vehicles.crashed.clone()
    crashed[::2, 0] = True
    st = st.replace(vehicles=st.vehicles.replace(crashed=crashed))
    acts = random_actions(et, B8, et.generator(3))
    full = et.step_autoreset_batched(st, acts, et.generator(9))
    compact = et.step_autoreset_batched(st, acts, et.generator(9), reset_slots=slots)
    assert ((full[3] | full[4]).tolist()) == [True, False] * (B8 // 2)
    assert isinstance(compact[0], tuple) and isinstance(compact[0][1], dict)
    for k, (a, b) in enumerate(zip(compact[0], full[0], strict=True)):
        for key in b:
            assert torch.equal(a[key], b[key]), (k, key)
    for f in dataclasses.fields(VehicleState):
        assert torch.equal(getattr(compact[1].vehicles, f.name),
                           getattr(full[1].vehicles, f.name)), f.name
    for a, b in zip(compact[2:5], full[2:5]):
        assert torch.equal(a, b)
    total = sum(float(v.double().sum()) for o in full[0] for v in o.values())
    assert abs(float(obs_sum(full[0])) - total) < 1e-4
    gen = et.generator(0)
    st2, metrics = rollout(et, st, 2, gen, compact_reset=slots)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


def test_torch_vector_env_takes_a_tuple_of_dicts():
    """parking-v0 with 2 egos under MultiAgentObservation through the
    vector env: a Tuple of Dict spaces equal to the JAX package's, numpy
    dicts out, (B, 2, 2) actions from the batched Tuple space."""
    import gymnasium

    config = {"controlled_vehicles": 2,
              "observation": {"type": "MultiAgentObservation",
                              "observation_config": {"type": "KinematicsGoal",
                                                     "features": ["x", "y", "vx", "vy",
                                                                  "cos_h", "sin_h"],
                                                     "scales": [100, 100, 5, 5, 1, 1],
                                                     "normalize": False}},
              "action": {"type": "MultiAgentAction",
                         "action_config": {"type": "ContinuousAction"}}}
    envs = ht.make_vec("parking-v0", 3, config=config, device="cpu", reset_slots=1)
    assert envs.single_observation_space == hj.make("parking-v0", config).observation_space
    assert isinstance(envs.single_observation_space[0], gymnasium.spaces.Dict)
    obs, _ = envs.reset(seed=2)
    assert isinstance(obs, tuple) and obs[1]["desired_goal"].shape == (3, 6)
    envs.action_space.seed(0)
    for _ in range(2):
        obs, reward, term, trunc, info = envs.step(envs.action_space.sample())
        assert isinstance(obs[0], dict) and reward.shape == (3,)
        assert np.isfinite(obs[1]["observation"]).all() and info["is_success"].shape == (3,)


def test_torch_agents_actions_go_to_their_slots():
    """With several egos every action type takes (B, n_agents, ...) actions,
    agent k's to slot ``ego_slots[k]``, as the JAX package's
    ``_action_to_slots`` does: a plain DiscreteMetaAction and a
    MultiAgentAction on highway-v0, a ContinuousAction on parking-v0."""
    for env_id, config in (("highway-v0", {"controlled_vehicles": 2}),
                           ("highway-v0", dict(MULTI, controlled_vehicles=2)),
                           ("parking-v0", {"controlled_vehicles": 3})):
        et, ej = ht.make(env_id, config, device="cpu"), hj.make(env_id, config)
        acts = random_actions(et, 5, et.generator(0))
        slots_t = et._action_to_slots(acts)
        slots_j = jax.vmap(ej._action_to_slots)(jnp.asarray(acts.numpy()))
        np.testing.assert_array_equal(slots_t.numpy(), np.asarray(slots_j))
        for k, slot in enumerate(et.ego_slots):
            assert torch.equal(slots_t[:, slot], acts[:, k].to(slots_t.dtype))
        others = [v for v in range(et.num_slots) if v not in et.ego_slots]
        assert float(slots_t[:, others].abs().sum()) == 0.0


@pytest.mark.parametrize("env_id", ["highway-v0", "parking-v0", "racetrack-v0"])
def test_torch_several_egos_spaces_match_jax(env_id):
    import gymnasium

    sub = {"highway-v0": {"type": "Kinematics"},
           "parking-v0": {"type": "KinematicsGoal",
                          "features": ["x", "y", "vx", "vy", "cos_h", "sin_h"],
                          "scales": [100, 100, 5, 5, 1, 1], "normalize": False},
           "racetrack-v0": hj.make("racetrack-v0").config["observation"]}[env_id]
    act = {"highway-v0": {"type": "DiscreteMetaAction"},
           "parking-v0": {"type": "ContinuousAction"},
           "racetrack-v0": hj.make("racetrack-v0").config["action"]}[env_id]
    for config in ({"controlled_vehicles": 2},
                   {"controlled_vehicles": 2,
                    "observation": {"type": "MultiAgentObservation", "observation_config": sub},
                    "action": {"type": "MultiAgentAction", "action_config": act}}):
        et, ej = ht.make(env_id, config, device="cpu"), hj.make(env_id, config)
        assert et.observation_space == ej.observation_space, (env_id, config)
        assert et.action_space == ej.action_space, (env_id, config)
    inner = gymnasium.spaces.Dict if env_id == "parking-v0" else gymnasium.spaces.Box
    assert isinstance(et.observation_space, gymnasium.spaces.Tuple)
    assert all(isinstance(s, inner) for s in et.observation_space.spaces)
    obs, _ = et.reset(2, et.generator(0))
    assert isinstance(obs, tuple) and len(obs) == 2


def test_torch_exit_refuses_several_egos():
    with pytest.raises(NotImplementedError, match="several controlled vehicles not ported"):
        ht.make("exit-v0", {"controlled_vehicles": 2}, device="cpu")
    # still refused elsewhere: the families without several egos
    with pytest.raises(NotImplementedError, match="several controlled vehicles"):
        ht.make("roundabout-v0", {"controlled_vehicles": 2}, device="cpu")
    assert ht.make("exit-v0", device="cpu").ego_slots == (0,)


def test_torch_multi_agent_highway_episode_through_gym_env():
    from highwayenv_tpu_torch.gym_env import GymEnv

    env = GymEnv("highway-fast-v0", dict(MULTI, controlled_vehicles=2), device="cpu")
    obs, info = env.reset(seed=3)
    assert isinstance(obs, tuple) and len(obs) == 2 and obs[0].shape == (5, 5)
    assert env.action_space.contains(env.action_space.sample())
    env.action_space.seed(0)
    done, steps = False, 0
    while not done and steps < 40:
        obs, reward, terminated, truncated, info = env.step(env.action_space.sample())
        assert isinstance(obs, tuple) and all(o.shape == (5, 5) for o in obs)
        assert isinstance(reward, float) and np.isfinite(reward)
        done, steps = terminated or truncated, steps + 1
    assert done and 1 <= steps <= 30
