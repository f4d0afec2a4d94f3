"""Gymnasium surface of the port: the single env, its multi-agent wrapper
and the registration.

PyTorch counterpart of ``highwayenv_tpu/gym_env.py`` (reference
envs/common/abstract.py ``AbstractEnv`` and ``MultiAgentWrapper``).
``GymEnv`` is one env over a B=1 state on the env's device (CUDA unless
``device="cpu"`` is passed): ``reset(seed=..., options=...)`` and
``step(action)`` with numpy in and out.  A reset replays the reference's
NumPy draw order (``seeding.py``) with Gymnasium's ``np_random``, so
``reset(seed=s)`` gives the reference's scene and a reset without a seed
carries the generator on; the episode's own draws (intersection spawns,
lane-keeping noise) come from a ``torch.Generator`` derived from it without
consuming a draw.  A step runs the batched step at B=1 (``step_batched``,
the frame kernels on CUDA) with no autoreset.

Rendering is host code over the state: ``render()`` gives the
``rgb_array`` frame of ``render.py`` (or of ``pygame_render.py`` under
``config["render_backend"] = "pygame"``, pixel-exact to the reference), and
in ``human`` mode shows it in a pygame window (``viewer.EnvViewer``; with
``SDL_VIDEODRIVER=dummy`` headless), whose keys drive the ego under
``config["manual_control"]``.  A pygame-backend GrayscaleObservation is
rendered on the host here, on every reset and step.

``register_gymnasium_envs()`` registers every id under
``highwayenv_tpu_torch/<id>``: ``gymnasium.make`` gives a ``GymEnv`` (the
multi-agent intersection's -v1 and -v2 wrapped in ``MultiAgentWrapper``, as
the reference registers them) and ``gymnasium.make_vec`` the batched
``vector_env.GymVectorEnv``.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

import gymnasium


def _row(x):
    """Row 0 of a batched observation or info value as numpy: dicts key by
    key, tuples element by element."""
    if isinstance(x, dict):
        return {k: _row(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_row(v) for v in x)
    return x[0].cpu().numpy()


class GymEnv(gymnasium.Env):
    """One env of ``env_id`` as a Gymnasium ``Env``: ``config`` overrides the
    env's config, ``device`` is CUDA by default (``"cpu"`` on the CPU)."""

    metadata = {"render_modes": ["rgb_array", "human"], "render_fps": 15}

    def __init__(self, env_id: str, config: dict | None = None,
                 render_mode: str | None = None, device=None):
        self._env_id = env_id
        self._user_config = dict(config or {})
        self._device = device
        self.render_mode = render_mode
        self.env = self._make()
        self._state = None
        self._generator = self.env.generator(0)
        self._viewer = None
        self._pygame_renderer = None
        #: per slot, the deque of its last 30 poses (show_trajectories)
        self._history = {}

    def _make(self):
        import highwayenv_tpu_torch as ht

        return ht.make(self._env_id, dict(self._user_config) or None, device=self._device)

    # -- config surface (reference abstract.py) ----------------------------- #
    @property
    def config(self) -> dict:
        return self.env.config

    def configure(self, config: dict) -> None:
        self._user_config.update(config or {})
        self.env = self._make()

    @property
    def action_space(self):
        return self.env.action_space

    @property
    def observation_space(self):
        return self.env.observation_space

    @property
    def unwrapped(self):
        return self

    @property
    def state(self):
        """The B=1 ``EnvState`` (None before the first reset)."""
        return self._state

    def _actions(self, action) -> torch.Tensor:
        """One env's action as the batched (1, ...) tensor of the step: a
        tuple of per-agent actions stacked, a Box action as float32."""
        if isinstance(action, (tuple, list)) and len(self.env.ego_slots) > 1:
            action = np.stack([np.asarray(a) for a in action])
        action = np.asarray(action)
        if self.env.action_type.action_shape:
            action = action.astype(np.float32)
        return torch.as_tensor(action[None], device=self.env.device)

    @property
    def _host_obs(self) -> bool:
        """The observation is rendered on the host (a pygame-backend
        GrayscaleObservation)."""
        return getattr(self.env.observation_type, "host_side", False)

    def _observation(self, obs):
        """Row 0 of the step's observation, or the host-rendered one."""
        if self._host_obs:
            return self.env.observation_type.observe_host(self.env, self._state)
        return _row(obs)

    def reset(self, *, seed: int | None = None, options: dict | None = None):
        from highwayenv_tpu_torch import seeding

        super().reset(seed=seed)  # seeds or carries on self.np_random
        if options and "config" in options:
            self.configure(options["config"])
        if seeding.supports_seeded_reset(self.env):
            # the reference's draw order: the scene of reset(seed)
            obs, self._state = self.env.reset_seeded(rng=self.np_random,
                                                     generator=self._generator)
        else:
            if seed is not None:
                self._generator.manual_seed(seed)
            obs, self._state = self.env.reset_batch(1, self._generator)
        if self._host_obs:
            self.env.observation_type.reset_stack()
        obs = self._observation(obs)
        # the reset's info (reference abstract.py): _info with a sampled action
        info = self.env._info(self._state, self._actions(self.action_space.sample()))
        return obs, _row(info)

    def step(self, action):
        if self._state is None:
            raise RuntimeError("reset() must be called before step()")
        if self.config.get("manual_control", False) and self._viewer is not None:
            # the keyboard overrides the agent
            action = self._viewer.get_manual_action()
        obs, self._state, reward, terminated, truncated, info = self.env.step_batched(
            self._state, self._actions(action), self._generator
        )
        return (self._observation(obs), float(reward[0]), bool(terminated[0]), bool(truncated[0]),
                _row(info))

    def render_frame(self) -> np.ndarray:
        """The (H, W, 3) uint8 frame of the state: ``render.render_rgb``, or
        the pygame pipeline under ``config["render_backend"] = "pygame"``;
        with ``show_trajectories`` the past poses as faded ghosts."""
        from highwayenv_tpu_torch.render import render_rgb, row0

        if self._state is None:
            raise RuntimeError("reset() must be called before render()")
        if self.config.get("render_backend") == "pygame":
            from highwayenv_tpu_torch.pygame_render import PygameFrameRenderer

            if self._pygame_renderer is None:
                self._pygame_renderer = PygameFrameRenderer(
                    self.env, self.config["screen_width"], self.config["screen_height"])
            self._pygame_renderer.display(self._state)
            return self._pygame_renderer.get_image()
        if not self.config.get("show_trajectories"):
            return render_rgb(self.env, self._state)
        # each slot's pose history (reference Vehicle.history, a deque of 30)
        veh = row0(self._state.vehicles)
        for i in range(self.env.num_slots):
            if veh["kind"][i] == 0:
                continue
            self._history.setdefault(i, collections.deque(maxlen=30)).appendleft(
                (veh["pos"][i].copy(), float(veh["heading"][i]), float(veh["length"][i]),
                 float(veh["width"][i])))
        return render_rgb(self.env, self._state, history=self._history)

    def render(self):
        if self._state is None:
            return None
        if self.render_mode == "rgb_array":
            return self.render_frame()
        if self.render_mode == "human":
            from highwayenv_tpu_torch.viewer import EnvViewer

            if self._viewer is None:
                self._viewer = EnvViewer(self)
            return self._viewer.display()
        return None

    def close(self):
        if self._viewer is not None:
            self._viewer.close()
            self._viewer = None
        self._state = None


class MultiAgentWrapper(gymnasium.Wrapper):
    """Per-agent rewards and terminations from the aggregated env
    (reference abstract.py ``MultiAgentWrapper``)."""

    def step(self, action):
        obs, _reward, _terminated, truncated, info = self.env.step(action)
        return obs, info["agents_rewards"], info["agents_terminated"], truncated, info


#: the ids the reference registers with ``MultiAgentWrapper`` applied
_WRAPPED = {"intersection-multi-agent-v1", "intersection-multi-agent-v2"}


def register_gymnasium_envs(namespace: str = "highwayenv_tpu_torch") -> None:
    """Register every ported id with Gymnasium under ``namespace/<id>``."""
    import highwayenv_tpu_torch as ht

    for env_id in ht.registered_ids():
        name = f"{namespace}/{env_id}"
        if name in gymnasium.registry:
            continue
        extra = {}
        if env_id in _WRAPPED:
            extra["additional_wrappers"] = (MultiAgentWrapper.wrapper_spec(),)
        gymnasium.register(
            id=name,
            entry_point="highwayenv_tpu_torch.gym_env:GymEnv",
            vector_entry_point="highwayenv_tpu_torch.vector_env:GymVectorEnv",
            kwargs={"env_id": env_id},
            **extra,
        )
