"""Single-device random-policy rollout with per-env autoreset.

Counterpart of the body of ``highwayenv_tpu/parallel/sharding.py::
sharded_rollout_fn`` on one card: each step draws uniform random actions
(``random_actions``: an integer in [0, n) for a discrete action, U(-1, 1)
on each axis of a continuous one, as ``_action_sampler`` does), runs
``step_autoreset_batched`` and folds the observation (every field of a
dict one) into a checksum so the observation head is part of the measured
work (every element of a tuple one).  Metrics stay on the device
until the caller reads them.

The two reset-amortizing options of ``sharded_rollout_fn``:

  - ``compact_reset=P`` passes ``reset_slots=P`` to the autoreset step,
    which places only the done rows, P at a time: the same results as the
    default, with the generator advanced alike;
  - ``fresh_pool=P`` steps through ``step_batched`` and draws P fresh scenes
    a step, which go to the step's done envs in prefix order (done env k of
    the step gets scene min(k, P - 1)), with no host sync.  It draws other
    scenes than the default and reuses the last one past P done envs.

``graph=True`` replays the step as a CUDA graph (``parallel/graph.py``):
the same results as the eager steps.
"""

from __future__ import annotations

import torch

from highwayenv_tpu_torch.envs.base import _rows, map_obs, take_rows, where_done


def random_actions(env, batch: int, generator: torch.Generator, device=None):
    """A uniform random action per env (and per agent, (B, n_agents, ...),
    where the env has several egos): int32 in [0, n) for a discrete action
    type, (..., size) float32 U(-1, 1) for a continuous one."""
    at = env.action_type
    device = env.device if device is None else device
    shape = (batch,) + env.action_shape
    if not at.action_shape:
        return torch.randint(0, at.n, shape, generator=generator, device=device,
                             dtype=torch.int32)
    return torch.empty(shape, dtype=torch.float32, device=device).uniform_(
        -1.0, 1.0, generator=generator
    )


def obs_sum(obs) -> torch.Tensor:
    """The sum of every observation: of every field of a dict one, of
    every element of a tuple one."""
    if isinstance(obs, dict):
        obs = tuple(obs.values())
    if isinstance(obs, tuple):
        return torch.stack([obs_sum(o) for o in obs]).sum()
    return obs.sum()


def rollout(env, states, horizon: int, generator: torch.Generator,
            fresh_pool: int | None = None, compact_reset: int | None = None,
            graph: bool = False):
    """Run ``horizon`` policy steps from ``states``.

    Returns ``(states, {"mean_reward", "done_rate", "obs_checksum"})`` with
    0-dim tensors: the mean over steps of the batch-mean reward and done
    flag, and the sum of every observation.  With ``graph=True`` the
    returned states are the captured step's own buffers.
    """
    if fresh_pool and compact_reset:
        raise ValueError(
            "fresh_pool and compact_reset are alternative reset-amortization "
            "strategies; pass one"
        )
    if graph and fresh_pool:
        raise ValueError("graph=True captures the autoreset step; fresh_pool "
                         "steps through step_batched and is not captured")
    B = states.time.shape[0]
    step = None
    if graph:
        from highwayenv_tpu_torch.parallel.graph import CapturedStep

        step = CapturedStep(env, states, generator, reset_slots=compact_reset)
    rewards, dones, obs_sums = [], [], []
    for _ in range(horizon):
        actions = random_actions(env, B, generator, states.time.device)
        if step is not None:
            obs, states, reward, term, trunc, _ = step(actions)
        elif fresh_pool is None:
            obs, states, reward, term, trunc, _ = env.step_autoreset_batched(
                states, actions, generator, reset_slots=compact_reset
            )
        else:
            obs, stepped, reward, term, trunc, _ = env.step_batched(
                states, actions, generator
            )
            done = term | trunc
            pool_obs, pool = env._reset(fresh_pool, generator)
            rank = torch.clamp(
                torch.cumsum(done.to(torch.int32), 0) - 1, 0, fresh_pool - 1
            )
            states = where_done(done, take_rows(pool, rank), stepped)
            obs = map_obs(lambda p, o: torch.where(_rows(done, o), p[rank], o), pool_obs, obs)
        rewards.append(reward.mean())
        dones.append((term | trunc).float().mean())
        obs_sums.append(obs_sum(obs))
    return states, {
        "mean_reward": torch.stack(rewards).mean(),
        "done_rate": torch.stack(dones).mean(),
        "obs_checksum": torch.stack(obs_sums).sum(),
    }
