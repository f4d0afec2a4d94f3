"""The port's single-env Gymnasium surface, on the CPU.

``highwayenv_tpu_torch/gym_env.py``: ``GymEnv`` over a B=1 state (the
seeded reset of ``seeding.py``, ``step_batched`` at B=1 with no autoreset),
``MultiAgentWrapper`` and the registration.  One short episode each at
highway-fast-v0, merge-v0, parking-v0 and lane-keeping-v0 (its observation
noise off): the observation lies in the observation space, the step returns
Python ``float`` / ``bool``, ``reset(seed=11)`` twice gives equal
observations, and over 3 steps with the same actions the reward (within
1e-5), terminated and truncated agree with the JAX package stepped by its
``step_batched`` from the JAX package's seeded state of the same seed.
Then the config option of ``reset``, the multi-agent wrapper, what
``gymnasium.make`` gives for every id, Gymnasium's ``check_env``, the
rendering and manual control that were once refused, and the registry
against the JAX package's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import gymnasium
import pytest
import torch

import highwayenv_tpu as hj
import highwayenv_tpu.seeding as sj
import highwayenv_tpu_torch as ht
from highwayenv_tpu_torch.gym_env import GymEnv, MultiAgentWrapper

torch.set_num_threads(1)

EPISODE_IDS = ["highway-fast-v0", "merge-v0", "parking-v0", "lane-keeping-v0"]
#: lane-keeping's observation noise off (its draws differ by design)
QUIET = {"lane-keeping-v0": {"state_noise": 0.0, "derivative_noise": 0.0}}
STEPS = 3
REWARD_ATOL = 1e-5


def _np_cast(space, obs):
    """The observation's leaves as numpy arrays of the space's dtype."""
    if isinstance(space, gymnasium.spaces.Tuple):
        return tuple(_np_cast(s, o) for s, o in zip(space.spaces, obs))
    if isinstance(space, gymnasium.spaces.Dict):
        return {k: _np_cast(space.spaces[k], obs[k]) for k in space.spaces}
    return np.asarray(obs, dtype=space.dtype)


def _leaves(obs):
    if isinstance(obs, dict):
        return [x for k in obs for x in _leaves(obs[k])]
    if isinstance(obs, tuple):
        return [x for o in obs for x in _leaves(o)]
    return [obs]


@pytest.mark.parametrize("env_id", EPISODE_IDS)
def test_torch_gym_env_episode(env_id):
    config = QUIET.get(env_id)
    env = GymEnv(env_id, config, device="cpu")
    obs, info = env.reset(seed=3)
    assert env.observation_space.contains(_np_cast(env.observation_space, obs))
    assert all(np.asarray(v).ndim == 0 for k, v in info.items()
               if k not in ("action", "rewards", "agents_rewards", "agents_terminated"))

    # the JAX package from its own seeded state of the same seed
    ej = hj.make(env_id, config)
    state_j = jax.tree.map(lambda x: x[None], sj.seeded_reset_state(ej, sj.np_random(3)))
    step_j = jax.jit(ej.step_batched)
    env.action_space.seed(5)
    for t in range(STEPS):
        action = env.action_space.sample()
        obs, reward, terminated, truncated, info = env.step(action)
        assert type(reward) is float and type(terminated) is bool and type(truncated) is bool
        assert env.observation_space.contains(_np_cast(env.observation_space, obs))
        _, state_j, rew_j, term_j, trunc_j, _ = step_j(
            state_j, jnp.asarray(np.asarray(action)[None]))
        assert abs(reward - float(rew_j[0])) <= REWARD_ATOL, (t, reward, float(rew_j[0]))
        assert (terminated, truncated) == (bool(term_j[0]), bool(trunc_j[0])), t
    # a seeded reset is reproducible, and carries on without a seed
    o1, _ = env.reset(seed=11)
    o2, _ = env.reset(seed=11)
    o3, _ = env.reset()
    for a, b in zip(_leaves(o1), _leaves(o2)):
        np.testing.assert_array_equal(a, b)
    assert all(np.isfinite(x).all() for x in _leaves(o3))
    env.close()
    assert env.state is None


def test_torch_gym_env_reset_config_option():
    env = GymEnv("highway-fast-v0", device="cpu")
    env.reset(seed=0, options={"config": {"vehicles_count": 5}})
    assert env.config["vehicles_count"] == 5
    assert env.env.num_slots == 6 and env.unwrapped is env
    assert env.state.vehicles.kind.shape == (1, 6)


def test_torch_gym_env_multi_agent_wrapper():
    env = MultiAgentWrapper(GymEnv("intersection-multi-agent-v0", device="cpu"))
    obs, _ = env.reset(seed=0)
    assert isinstance(obs, tuple) and len(obs) == 2 and obs[0].shape == (15, 7)
    obs, rewards, terminated, truncated, info = env.step((1, 1))
    assert isinstance(rewards, tuple) and len(rewards) == 2
    assert isinstance(terminated, tuple) and len(terminated) == 2
    assert all(np.asarray(r).shape == () for r in rewards)
    assert type(truncated) is bool and len(info["agents_rewards"]) == 2


def test_torch_gym_env_make_every_id():
    ht.register_gymnasium_envs()
    for env_id in ht.registered_ids():
        env = gymnasium.make(f"highwayenv_tpu_torch/{env_id}", device="cpu")
        assert type(env.unwrapped) is GymEnv and env.unwrapped.env.device.type == "cpu"
        wrapped = env_id in ("intersection-multi-agent-v1", "intersection-multi-agent-v2")
        assert isinstance(env, MultiAgentWrapper) == wrapped, env_id
    env = gymnasium.make("highwayenv_tpu_torch/intersection-multi-agent-v1", device="cpu")
    env.reset(seed=1)
    _, rewards, terminated, _, _ = env.step((2, 2))
    assert len(rewards) == len(terminated) == 2


def test_torch_gym_env_check_env():
    from gymnasium.utils.env_checker import check_env

    check_env(GymEnv("highway-fast-v0", device="cpu"), skip_render_check=True)


def test_torch_gym_env_refuses_what_is_not_ported():
    """Rendering and manual control are ported (tests/test_torch_render.py):
    an rgb_array render gives a frame, a manual-control env makes; a step
    before the reset still raises."""
    env = GymEnv("highway-fast-v0", render_mode="rgb_array", device="cpu")
    env.reset(seed=0)
    assert env.render().shape == (150, 600, 3)
    assert GymEnv("highway-fast-v0", device="cpu").render() is None
    assert GymEnv("highway-fast-v0", {"manual_control": True}, device="cpu").config[
        "manual_control"]
    with pytest.raises(RuntimeError, match="reset"):
        GymEnv("highway-fast-v0", device="cpu").step(1)


def test_torch_gym_env_registry_matches_jax():
    assert ht.registered_ids() == hj.registered_ids()
    assert len(ht.registered_ids()) == 31
