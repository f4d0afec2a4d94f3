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
raises ``NotPortedError``.

``shard`` splits the batch over the cards of the process
(``parallel/sharding.py``): ``None`` (the default) does so when the env is
on CUDA, more than one CUDA device is visible and ``num_envs`` divides
evenly over them; ``True`` shards over ``sharding.default_devices()`` and
raises ``ValueError`` on a batch that does not divide; ``False`` keeps one
card.  Sharded, each card holds an env, a generator and, on CUDA, a
``CapturedStep`` of its num_envs / D envs: ``reset(seed)`` seeds the
generators with ``sharding.shard_generators(seed, mesh)`` (shard d from the
seed and d), so shard d draws what an unsharded env of its rows would draw
from that generator, not what the whole batch draws from one.  Actions are
split by rows and the outputs concatenated in shard order.
"""

from __future__ import annotations

import numpy as np
import torch
from gymnasium.vector import AutoresetMode, VectorEnv
from gymnasium.vector.utils import batch_space

from highwayenv_tpu_torch import NotPortedError
from highwayenv_tpu_torch.parallel import sharding
from highwayenv_tpu_torch.parallel.rollout import PolicyStep


def _to_numpy(x):
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_to_numpy(v) for v in x)
    return x.cpu().numpy()


def _concat(parts):
    """The shards' numpy outputs (arrays, dicts or tuples of them) joined
    row-wise in shard order."""
    if len(parts) == 1:
        return parts[0]
    if isinstance(parts[0], dict):
        return {k: _concat([p[k] for p in parts]) for k in parts[0]}
    if isinstance(parts[0], tuple):
        return tuple(_concat(list(ps)) for ps in zip(*parts))
    return np.concatenate(parts)


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
    shard:
        Split the batch over the cards of ``sharding.default_devices()``:
        ``None`` when the env is on CUDA and more than one card divides
        ``num_envs`` evenly, ``True`` always (a ``ValueError`` where the
        batch does not divide), ``False`` never.
    """

    metadata = {"autoreset_mode": AutoresetMode.SAME_STEP, "render_modes": ["rgb_array"]}

    def __init__(self, env_id: str, num_envs: int, config: dict | None = None,
                 render_mode: str | None = None, final_obs: bool = False,
                 reset_slots: int | None = None, device=None,
                 shard: bool | None = None):
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
        # one env, generator and captured step (on the card) per shard; one
        # of each unsharded
        self._mesh = None
        self._envs = [self.env]
        if shard is None:
            count = torch.cuda.device_count() if self.env.device.type == "cuda" else 1
            shard = count > 1 and self.num_envs % count == 0
        if shard:
            self._mesh = sharding.make_mesh(sharding.default_devices())
            if self.num_envs % self._mesh.num_shards:
                raise ValueError(
                    f"num_envs={self.num_envs} does not split over "
                    f"{self._mesh.num_shards} devices; pass a multiple or shard=False"
                )
            self._envs = sharding.shard_envs(self.env, self._mesh)
        self._generators = [e.generator(0) for e in self._envs]
        # the step of each shard (captured as CUDA graphs on the card), made
        # at the first reset
        self._steps = None
        self._shards = None  # the batch's states, one EnvState a shard

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
        # reseeded in place: the captured steps hold the generators
        for i, g in enumerate(self._generators):
            g.manual_seed(int(seed) if self._mesh is None
                          else sharding.shard_seed(int(seed), self._mesh.first_shard + i))
        n = self.num_envs // len(self._envs)
        resets = [e.reset_batch(n, g) for e, g in zip(self._envs, self._generators)]
        if self._steps is None:
            self._steps = [
                PolicyStep(e, s, g, compact_reset=self._reset_slots,
                           graph=self.env.device.type == "cuda", final_obs=self._final_obs)
                for e, (_, s), g in zip(self._envs, resets, self._generators)
            ]
        else:
            for step, (_, s) in zip(self._steps, resets):
                step.load(s)
        self._shards = [step.states for step in self._steps]
        return _concat([_to_numpy(o) for o, _ in resets]), {}

    def step(self, actions):
        if self._shards is None:
            raise RuntimeError("reset() must be called before step()")
        if isinstance(actions, (tuple, list)) and len(self.env.ego_slots) > 1:
            # a batched Tuple space's sample: one (B, ...) array per agent
            actions = np.stack([np.asarray(a) for a in actions], axis=1)
        actions = np.asarray(actions)
        if self.env.action_type.action_shape:
            # a Box action: float32, as the JAX package's _action_to_slots
            actions = actions.astype(np.float32)
        # every shard's step queued before the host read of any
        for step, a in zip(self._steps, np.split(actions, len(self._steps))):
            step.launch(torch.as_tensor(a, device=step.env.device))
        outs = [step.finish() for step in self._steps]
        self._shards = [out[1] for out in outs]
        obs, reward, terminated, truncated, info = (
            _concat([_to_numpy(out[k]) for out in outs]) for k in (0, 2, 3, 4, 5)
        )
        # gymnasium vector-info convention: per-key presence masks
        for k in list(info):
            if not k.startswith("_"):
                info[f"_{k}"] = np.ones(self.num_envs, dtype=bool)
        return (
            obs,
            reward.astype(np.float64),
            terminated.astype(bool),
            truncated.astype(bool),
            info,
        )

    def render(self):
        """The ``rgb_array`` frame of env 0 (``render.render_rgb``), or None
        without that render mode or before a reset."""
        if self.render_mode != "rgb_array" or self._shards is None:
            return None
        from highwayenv_tpu_torch.render import render_rgb

        return render_rgb(self._envs[0], self._shards[0])

    def close_extras(self, **kwargs):
        self._shards = None
        self._steps = None

    @property
    def states(self):
        """The EnvState batch (on the card, the captured step's buffers);
        sharded, the list of the shards' EnvStates in shard order."""
        if self._shards is None or self._mesh is not None:
            return self._shards
        return self._shards[0]
