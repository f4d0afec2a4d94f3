"""Gymnasium VectorEnv over the port's batched step.

PyTorch counterpart of ``highwayenv_tpu/vector_env.py``: the whole batch of
envs steps at once, on the card as one replay of a CUDA graph
(``parallel/graph.py``), so a vector-env trainer gets the batched engine
through the standard API:

    import gymnasium
    import highwayenv_tpu_torch as ht
    ht.register_gymnasium_envs()
    envs = gymnasium.make_vec("highwayenv_tpu_torch/highway-fast-v0", num_envs=4096)
    obs, info = envs.reset(seed=0)
    obs, r, term, trunc, info = envs.step(envs.action_space.sample())

Autoreset follows Gymnasium's SAME_STEP mode: when an episode ends, the
returned observation is already the first observation of the next episode.
``final_obs=True`` also returns the terminal observation, in
``info["final_obs"]``, at the cost of a second observation of the batch.
``reset_slots=P`` places only the done rows, P at a time (the compact
autoreset of ``envs/base.py``).

The batch lives on the card unless ``device="cpu"`` is asked for, where it
steps eagerly.  ``render_mode="rgb_array"`` renders env 0 on the host
(``render.py``); an observation rendered on the host (the pygame grayscale
backend) is refused.  Observations, rewards, flags and info come back as numpy.
A seed is one integer, which seeds the env's generator; the port draws the
batch from that one generator and has no per-env keys, so a list of seeds
raises ``NotPortedError``.  One card: the JAX package's ``shard`` is not
ported.
"""

from __future__ import annotations

import numpy as np
import torch
from gymnasium.vector import AutoresetMode, VectorEnv
from gymnasium.vector.utils import batch_space

from highwayenv_tpu_torch import NotPortedError


def _to_numpy(x):
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_to_numpy(v) for v in x)
    return x.cpu().numpy()


class GymVectorEnv(VectorEnv):
    """The batch of ``num_envs`` envs of ``env_id`` as one Gymnasium
    VectorEnv.

    Parameters
    ----------
    env_id:
        A registered id of the port (e.g. ``"highway-v0"``).
    num_envs:
        Batch size.
    config:
        Env config overrides.
    final_obs:
        Also return the terminal observation of the envs that finished this
        step, as ``info["final_obs"]`` (SAME_STEP contract).
    reset_slots:
        Place only the done rows at each step, this many at a time.
    device:
        ``None`` for CUDA (raises without it), or ``"cpu"``.
    """

    metadata = {"autoreset_mode": AutoresetMode.SAME_STEP, "render_modes": ["rgb_array"]}

    def __init__(self, env_id: str, num_envs: int, config: dict | None = None,
                 render_mode: str | None = None, final_obs: bool = False,
                 reset_slots: int | None = None, device=None):
        import highwayenv_tpu_torch as ht

        self.env = ht.make(env_id, dict(config) if config else None, device=device)
        if getattr(self.env.observation_type, "host_side", False):
            raise ValueError(
                "GymVectorEnv needs an observation computed on the device; "
                f"{type(self.env.observation_type).__name__} is rendered on the "
                "host under this config (the pygame grayscale backend)"
            )
        self.render_mode = render_mode
        self.num_envs = int(num_envs)
        self._final_obs = bool(final_obs)
        self._reset_slots = reset_slots
        self._generator = self.env.generator(0)
        self._captured = None  # the CUDA graph of the step, on the card
        self._states = None

        self.single_action_space = self.env.action_space
        self.single_observation_space = self.env.observation_space
        self.action_space = batch_space(self.single_action_space, self.num_envs)
        self.observation_space = batch_space(
            self.single_observation_space, self.num_envs
        )

    # -- gymnasium VectorEnv surface ------------------------------------ #

    def reset(self, *, seed=None, options=None):
        if options and "config" in options:
            raise ValueError(
                "reconfiguring a vector env is not supported; pass config= "
                "to the constructor"
            )
        if seed is None:
            seed = np.random.SeedSequence().entropy % (2**31)
        if np.ndim(seed) != 0:
            raise NotPortedError(
                "per-env seeds: the port draws the batch from one generator "
                "and has no per-env keys; pass one integer seed"
            )
        self._generator.manual_seed(int(seed))
        obs, states = self.env.reset_batch(self.num_envs, self._generator)
        if self.env.device.type == "cuda":
            from highwayenv_tpu_torch.parallel.graph import CapturedStep

            if self._captured is None:
                self._captured = CapturedStep(
                    self.env, states, self._generator, self._reset_slots,
                    self._final_obs,
                )
            else:
                self._captured.load(states)
            states = self._captured.states
        self._states = states
        return _to_numpy(obs), {}

    def step(self, actions):
        if self._states is None:
            raise RuntimeError("reset() must be called before step()")
        if isinstance(actions, (tuple, list)) and len(self.env.ego_slots) > 1:
            # a batched Tuple space's sample: one (B, ...) array per agent
            actions = np.stack([np.asarray(a) for a in actions], axis=1)
        actions = np.asarray(actions)
        if self.env.action_type.action_shape:
            # a Box action: float32, as the JAX package's _action_to_slots
            actions = actions.astype(np.float32)
        actions = torch.as_tensor(actions, device=self.env.device)
        if self._captured is not None:
            out = self._captured(actions)
        else:
            env = self.env
            out = env._autoreset_rest(*env._autoreset_first(
                self._states, actions, self._generator, self._reset_slots,
                self._final_obs,
            ))
        obs, self._states, reward, terminated, truncated, info = out
        info = _to_numpy(info)
        # gymnasium vector-info convention: per-key presence masks
        for k in list(info):
            if not k.startswith("_"):
                info[f"_{k}"] = np.ones(self.num_envs, dtype=bool)
        return (
            _to_numpy(obs),
            reward.cpu().numpy().astype(np.float64),
            terminated.cpu().numpy().astype(bool),
            truncated.cpu().numpy().astype(bool),
            info,
        )

    def render(self):
        """The ``rgb_array`` frame of env 0 (``render.render_rgb``), or None
        without that render mode or before a reset."""
        if self.render_mode != "rgb_array" or self._states is None:
            return None
        from highwayenv_tpu_torch.render import render_rgb

        return render_rgb(self.env, self._states)

    def close_extras(self, **kwargs):
        self._states = None
        self._captured = None

    @property
    def states(self):
        """The EnvState batch (on the card, the captured step's buffers)."""
        return self._states
