"""The port's rendering against the JAX package's, on the CPU.

  - ``render.render_rgb`` (the numpy rasterizer of row 0 of a batched state)
    against the JAX package's ``render_rgb`` of the same single state,
    bridged, on a reset and two random steps: byte-identical at highway-v0;
    at least 99.9% of the pixels equal at the curved roundabout-v0 and
    racetrack-v0 (found when written: every pixel equal);
  - ``pygame_render.PygameFrameRenderer`` (the reference's draw pipeline)
    against the JAX package's: byte-identical at highway-v0; byte-identical
    or at least 99.9% of the pixels equal at roundabout-v0, intersection-v0
    and parking-v0 (the ego's colour; found: every pixel equal);
  - ``GymEnv``: ``rgb_array`` frames of (150, 600, 3), the pygame backend's
    the same shape, ``show_trajectories``, ``human`` under
    ``SDL_VIDEODRIVER=dummy`` with ``manual_control`` (keys to actions, as
    the JAX package's tests/envs/test_viewer.py), ``close``; a
    GrayscaleObservation of ``backend="pygame"`` rendered on the host, its
    stack as the reference's;
  - ``viewer.VideoRecorder`` writes a GIF of the frames;
  - the vector env's ``rgb_array`` render of env 0 and its refusal of an
    observation rendered on the host.
"""

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
from highwayenv_tpu_torch.parallel.rollout import random_actions
from highwayenv_tpu_torch.render import render_rgb

torch.set_num_threads(1)

pygame = pytest.importorskip("pygame")

GRAY_OBS = {
    "type": "GrayscaleObservation",
    "observation_shape": (128, 64),
    "stack_size": 4,
    "weights": [0.2989, 0.5870, 0.1140],
    "scaling": 1.75,
}


def _jax_row0(states):
    """Row 0 of a port batch as the JAX package's single-env state."""
    d = to_numpy_state(states)
    return JaxEnvState(
        vehicles=JaxVehicleState(**{k: jnp.asarray(v[0]) for k, v in d["vehicles"].items()}),
        time=jnp.asarray(d["time"][0]), steps=jnp.asarray(d["steps"][0]),
        key=jax.random.PRNGKey(0),
    )


def _states(env_id, steps=2):
    """A reset batch of 2 and ``steps`` random autoreset steps: every state."""
    et = ht.make(env_id, device="cpu")
    gen = et.generator(4)
    _, st = et.reset(2, gen)
    out = [st]
    for _ in range(steps):
        _, st, *_ = et.step_autoreset_batched(st, random_actions(et, 2, gen), gen)
        out.append(st)
    return et, hj.make(env_id), out


def _equal_share(a, b) -> float:
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return float((a == b).all(axis=-1).mean())


@pytest.mark.parametrize("env_id,min_equal", [
    ("highway-v0", 1.0), ("roundabout-v0", 0.999), ("racetrack-v0", 0.999),
])
def test_render_rgb_matches_jax(env_id, min_equal):
    from highwayenv_tpu.render import render_rgb as jax_render_rgb

    et, ej, states = _states(env_id)
    for k, st in enumerate(states):
        got, want = render_rgb(et, st), jax_render_rgb(ej, _jax_row0(st))
        assert got.shape == (et.config["screen_height"], et.config["screen_width"], 3)
        assert _equal_share(got, want) >= min_equal, f"{env_id} state {k}"


@pytest.mark.parametrize("env_id,min_equal", [
    ("highway-v0", 1.0), ("roundabout-v0", 0.999), ("intersection-v0", 0.999),
    ("parking-v0", 0.999),
])
def test_pygame_renderer_matches_jax(env_id, min_equal, monkeypatch):
    from highwayenv_tpu.pygame_render import PygameFrameRenderer as JaxRenderer
    from highwayenv_tpu_torch.pygame_render import PygameFrameRenderer

    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    et, ej, states = _states(env_id)
    w, h = et.config["screen_width"], et.config["screen_height"]
    mine, theirs = PygameFrameRenderer(et, w, h), JaxRenderer(ej, w, h)
    for k, st in enumerate(states):
        mine.display(st)
        theirs.display(_jax_row0(st))
        got, want = mine.get_image(), theirs.get_image()
        assert got.shape == (h, w, 3)
        assert _equal_share(got, want) >= min_equal, f"{env_id} state {k}"
        assert len(np.unique(got.reshape(-1, 3), axis=0)) > 2  # drawn, not blank


def test_gym_env_rgb_array_and_backends():
    from highwayenv_tpu_torch.gym_env import GymEnv

    env = GymEnv("highway-fast-v0", render_mode="rgb_array", device="cpu")
    assert GymEnv("highway-fast-v0", device="cpu").render() is None
    assert env.render() is None  # before a reset
    env.reset(seed=0)
    frame = env.render()
    assert frame.shape == (150, 600, 3) and frame.dtype == np.uint8
    env.step(1)
    assert env.render().shape == (150, 600, 3)
    ghosts = GymEnv("highway-fast-v0", {"show_trajectories": True}, render_mode="rgb_array",
                    device="cpu")
    ghosts.reset(seed=0)
    for _ in range(2):
        ghosts.render()
        ghosts.step(1)
    assert ghosts.render().shape == (150, 600, 3) and len(ghosts._history) > 0
    exact = GymEnv("highway-fast-v0", {"render_backend": "pygame"}, render_mode="rgb_array",
                   device="cpu")
    exact.reset(seed=0)
    assert exact.render().shape == (150, 600, 3)
    env.close()
    assert env.state is None


def test_torch_human_mode_with_manual_control(monkeypatch):
    from highwayenv_tpu_torch.gym_env import GymEnv
    from highwayenv_tpu_torch.viewer import EventHandler

    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    env = GymEnv("highway-fast-v0", {"manual_control": True}, render_mode="human",
                 device="cpu")
    env.reset(seed=0)
    frame = env.render()
    assert frame.shape == (150, 600, 3) and frame.dtype == np.uint8
    EventHandler.handle_event(env._viewer, env.env.action_type,
                              pygame.event.Event(pygame.KEYDOWN, key=pygame.K_RIGHT))
    assert env._viewer.get_manual_action() == 3  # FASTER
    EventHandler.handle_event(env._viewer, env.env.action_type,
                              pygame.event.Event(pygame.KEYDOWN, key=pygame.K_UP))
    assert env._viewer.get_manual_action() == 0  # LANE_LEFT
    lane0 = int(env.state.vehicles.target_lane[0, 0])
    _, reward, *_ = env.step(1)  # IDLE, overridden by the keyboard's LANE_LEFT
    assert np.isfinite(reward)
    assert int(env.state.vehicles.target_lane[0, 0]) == max(lane0 - 1, 0)
    env.close()
    assert env._viewer is None

    cont = GymEnv("parking-v0", {"manual_control": True}, render_mode="human", device="cpu")
    cont.reset(seed=0)
    cont.render()
    EventHandler.handle_event(cont._viewer, cont.env.action_type,
                              pygame.event.Event(pygame.KEYDOWN, key=pygame.K_UP))
    assert cont._viewer.get_manual_action()[0] == np.float32(0.7)
    EventHandler.handle_event(cont._viewer, cont.env.action_type,
                              pygame.event.Event(pygame.KEYUP, key=pygame.K_UP))
    assert cont._viewer.get_manual_action()[0] == 0.0
    cont.close()


def test_pygame_backend_grayscale_observation(monkeypatch):
    """The observation rendered on the host by the pygame pipeline: a stack
    of zeros and the reset's frame, rolled a step; the batched step carries
    a zero placeholder."""
    from highwayenv_tpu_torch.gym_env import GymEnv

    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    cfg = {"observation": {**GRAY_OBS, "backend": "pygame"}}
    env = GymEnv("highway-fast-v0", cfg, device="cpu")
    assert env.observation_space.shape == (4, 128, 64)
    o0, _ = env.reset(seed=0)
    assert o0.shape == (4, 128, 64) and o0.dtype == np.uint8
    assert not o0[:3].any() and o0[3].any()
    o1, *_ = env.step(1)
    np.testing.assert_array_equal(o1[2], o0[3])
    assert env.observation_space.contains(o1)
    batched = ht.make("highway-fast-v0", cfg, device="cpu")
    obs, _ = batched.reset(2, batched.generator(0))
    assert obs.shape == (2, 4, 128, 64) and not obs.any()


def test_video_recorder_writes_a_gif(tmp_path):
    from highwayenv_tpu_torch.gym_env import GymEnv
    from highwayenv_tpu_torch.viewer import VideoRecorder

    pytest.importorskip("imageio")
    env = GymEnv("highway-fast-v0", render_mode="rgb_array", device="cpu")
    env.reset(seed=0)
    rec = VideoRecorder(fps=15)
    for _ in range(3):
        rec.capture(env.render())
        env.step(1)
    path = rec.save(str(tmp_path / "ep.gif"))
    assert (tmp_path / "ep.gif").stat().st_size > 0 and path.endswith(".gif")
    with pytest.raises(ValueError, match="no frames"):
        VideoRecorder().save(str(tmp_path / "none.gif"))


def test_vector_env_renders_env_0():
    from highwayenv_tpu_torch.vector_env import GymVectorEnv

    envs = GymVectorEnv("highway-fast-v0", 2, render_mode="rgb_array", device="cpu")
    assert envs.render() is None  # before a reset
    envs.reset(seed=0)
    frame = envs.render()
    np.testing.assert_array_equal(frame, render_rgb(envs.env, envs.states))
    assert frame.shape == (150, 600, 3)
    assert GymVectorEnv("highway-fast-v0", 2, device="cpu").render() is None
    with pytest.raises(ValueError, match="host"):
        GymVectorEnv("highway-fast-v0", 2,
                      {"observation": {**GRAY_OBS, "backend": "pygame"}}, device="cpu")
