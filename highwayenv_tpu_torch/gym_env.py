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

``register_gymnasium_envs()`` registers every id under
``highwayenv_tpu_torch/<id>``: ``gymnasium.make`` gives a ``GymEnv`` (the
multi-agent intersection's -v1 and -v2 wrapped in ``MultiAgentWrapper``, as
the reference registers them) and ``gymnasium.make_vec`` the batched
``vector_env.GymVectorEnv``.  Rendering is not ported: ``render()`` with a
render mode and ``manual_control`` raise ``NotPortedError``.
"""

from __future__ import annotations

import numpy as np
import torch

import gymnasium

from highwayenv_tpu_torch import NotPortedError

#: what rendering waits for (ROADMAP Queue 1 item 8)
_RENDERING = ("rendering is not ported yet (ROADMAP Queue 1 item 8: render.py, "
              "observations/grayscale.py, viewer.py)")


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

    def _make(self):
        import highwayenv_tpu_torch as ht

        if self._user_config.get("manual_control"):
            raise NotPortedError(f"manual_control: {_RENDERING}")
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
        # the reset's info (reference abstract.py): _info with a sampled action
        info = self.env._info(self._state, self._actions(self.action_space.sample()))
        return _row(obs), _row(info)

    def step(self, action):
        if self._state is None:
            raise RuntimeError("reset() must be called before step()")
        obs, self._state, reward, terminated, truncated, info = self.env.step_batched(
            self._state, self._actions(action), self._generator
        )
        return (_row(obs), float(reward[0]), bool(terminated[0]), bool(truncated[0]),
                _row(info))

    def render(self):
        if self.render_mode is not None:
            raise NotPortedError(_RENDERING)
        return None

    def close(self):
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
