"""The port's Gymnasium surface on the CPU: GymVectorEnv, the registration,
the factories' spaces and the CUDA graph step's refusal of a CPU batch.

The contract tests of tests/envs/test_vector_env.py that apply to the port
(one card, Kinematics and DiscreteMetaAction only, one integer seed), run
with ``device="cpu"``, where the vector env steps eagerly; chip_smoke.py
drives the captured step on the card.  Its autoreset and final-obs tests
go by other names here: the root conftest.py marks every test whose id
contains theirs as slow.
"""

import gymnasium
import numpy as np
import pytest
import torch

import highwayenv_tpu as hj
import highwayenv_tpu_torch as ht
from highwayenv_tpu_torch.parallel.graph import CapturedStep

torch.set_num_threads(1)

CONFIG = {"vehicles_count": 6}


def test_vector_env_contract():
    envs = ht.make_vec("highway-fast-v0", num_envs=8, config=CONFIG, device="cpu")
    assert envs.num_envs == 8
    assert envs.metadata["autoreset_mode"].value == "SameStep"
    obs, info = envs.reset(seed=7)
    assert obs.shape == (8,) + envs.single_observation_space.shape
    assert envs.observation_space.contains(obs)

    for _ in range(3):
        acts = envs.action_space.sample()
        obs, r, term, trunc, info = envs.step(acts)
        assert envs.observation_space.contains(obs)
        assert r.shape == term.shape == trunc.shape == (8,)
        assert r.dtype == np.float64
        assert term.dtype == trunc.dtype == bool
        # vector-info convention: every key has a presence mask
        for k in info:
            if not k.startswith("_"):
                assert f"_{k}" in info
    envs.close()


def test_vector_env_seeding_is_deterministic():
    envs = ht.make_vec("highway-fast-v0", num_envs=4, config=CONFIG, device="cpu")
    a, _ = envs.reset(seed=3)
    b, _ = envs.reset(seed=3)
    c, _ = envs.reset(seed=4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    # the port has no per-env keys: a list of seeds is refused
    with pytest.raises(ht.NotPortedError, match="per-env seeds"):
        envs.reset(seed=[1, 2, 3, 4])


def test_gymnasium_make_vec_entry_point():
    ht.register_gymnasium_envs()
    envs = gymnasium.make_vec(
        "highwayenv_tpu_torch/highway-fast-v0", num_envs=4, config=CONFIG,
        device="cpu",
    )
    obs, _ = envs.reset(seed=0)
    obs, r, term, trunc, info = envs.step(envs.action_space.sample())
    assert obs.shape[0] == 4 and r.shape == (4,)
    envs.close()
    # the single-env GymEnv (gym_env.py) from the same registration
    from highwayenv_tpu_torch.gym_env import GymEnv

    env = gymnasium.make("highwayenv_tpu_torch/highway-fast-v0", config=CONFIG,
                         device="cpu")
    assert type(env.unwrapped) is GymEnv
    obs, _ = env.reset(seed=0)
    obs, r, term, trunc, info = env.step(env.action_space.sample())
    assert obs.shape == envs.single_observation_space.shape and type(r) is float


def test_vector_env_resets_on_the_same_step():
    envs = ht.make_vec("highway-fast-v0", num_envs=4,
                       config={"duration": 2, **CONFIG}, device="cpu")
    envs.reset(seed=0)
    idle = np.ones(4, dtype=np.int64)
    _, _, term1, trunc1, _ = envs.step(idle)
    d1 = term1 | trunc1  # crashed envs reset a step early
    _, _, term2, trunc2, _ = envs.step(idle)
    # duration 2 s at policy 1 Hz: every env that survived step 1 truncates
    # at step 2; envs reset at step 1 restarted their clock
    np.testing.assert_array_equal(trunc2, ~d1)
    # post-reset steps continue seamlessly
    obs3, r3, term3, trunc3, _ = envs.step(idle)
    assert np.isfinite(obs3).all()
    envs.close()


@pytest.mark.parametrize("reset_slots", [None, 2])
def test_vector_env_returns_the_terminal_obs(reset_slots):
    config = {"duration": 1, **CONFIG}
    envs = ht.make_vec("highway-fast-v0", num_envs=4, config=config,
                       final_obs=True, reset_slots=reset_slots, device="cpu")
    plain = ht.make_vec("highway-fast-v0", num_envs=4, config=config, device="cpu")
    envs.reset(seed=0)
    plain.reset(seed=0)
    acts = np.ones(4, dtype=np.int64)
    obs, r, term, trunc, info = envs.step(acts)
    assert trunc.all()
    assert "final_obs" in info and "_final_obs" in info
    # terminal obs differs from the post-reset obs returned as `obs`
    assert info["final_obs"].shape == obs.shape
    assert not np.allclose(info["final_obs"], obs)
    # the same draws and scenes as the step without final_obs
    obs_p, r_p, term_p, trunc_p, _ = plain.step(acts)
    np.testing.assert_array_equal(obs, obs_p)
    np.testing.assert_array_equal(r, r_p)
    np.testing.assert_array_equal(term | trunc, term_p | trunc_p)
    envs.close()
    plain.close()


@pytest.mark.parametrize("env_id", ht.registered_ids())
def test_spaces_match_jax(env_id):
    et = ht.make(env_id, device="cpu")
    ej = hj.make(env_id)
    assert et.action_space == ej.action_space
    assert et.observation_space == ej.observation_space


def test_unported_types_name_their_module():
    # Lidar is ported: it makes and observes (cells, 2)
    env = ht.make("highway-v0", {"observation": {"type": "LidarObservation"}}, device="cpu")
    obs, _ = env.reset(2, env.generator(0))
    assert obs.shape == (2, 16, 2)
    # Grayscale is ported: it makes and stacks (stack, W, H) uint8 frames
    gray = {"type": "GrayscaleObservation", "observation_shape": (128, 64),
            "stack_size": 4, "weights": [0.2989, 0.5870, 0.1140]}
    env = ht.make("highway-v0", {"observation": gray}, device="cpu")
    obs, _ = env.reset(2, env.generator(0))
    assert obs.shape == (2, 4, 128, 64) and obs.dtype == torch.uint8
    with pytest.raises(ValueError, match="Unknown observation type"):
        ht.make("highway-v0", {"observation": {"type": "NoSuchObservation"}}, device="cpu")


def test_captured_step_refuses_a_cpu_env():
    env = ht.make("highway-fast-v0", CONFIG, device="cpu")
    gen = env.generator(0)
    _, states = env.reset(2, gen)
    with pytest.raises(ValueError, match="CUDA graph"):
        CapturedStep(env, states, gen)


def test_import_does_not_import_gymnasium():
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, highwayenv_tpu_torch; assert 'gymnasium' not in sys.modules"],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
