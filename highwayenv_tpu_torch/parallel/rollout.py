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

The loop's body is ``PolicyStep``, which ``parallel/sharding.py`` runs on
every shard of a batch split over several cards.
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


def check_options(fresh_pool: int | None, compact_reset: int | None,
                  graph: bool) -> None:
    """Refuse the options that exclude each other."""
    if fresh_pool and compact_reset:
        raise ValueError(
            "fresh_pool and compact_reset are alternative reset-amortization "
            "strategies; pass one"
        )
    if graph and fresh_pool:
        raise ValueError("graph=True captures the autoreset step; fresh_pool "
                         "steps through step_batched and is not captured")


def take_scenes(done, scenes, idx, states, obs):
    """``states`` and ``obs`` with each done row replaced by scene ``idx``
    of that row ((B,) indices into ``scenes``, an (obs, EnvState))."""
    scene_obs, scene_states = scenes
    states = where_done(done, take_rows(scene_states, idx), states)
    obs = map_obs(lambda p, o: torch.where(_rows(done, o), p[idx], o), scene_obs, obs)
    return states, obs


class PolicyStep:
    """The body of the random-policy rollout on one batch, step after step.

    ``launch(actions=None)`` takes the actions (by default a random one per
    env from ``generator``) and queues the step up to its first host read
    (none on the full autoreset; the compact one reads the rows left once
    it has placed P); ``finish()`` completes it, advances ``states`` and
    returns the step's (obs, states, reward, terminated, truncated, info).
    The split lets a caller stepping several batches
    (``parallel/sharding.py``, the sharded ``vector_env.py``) queue every
    batch's step before it makes the host read of any, so that their cards
    overlap.

    The step is ``step_autoreset_batched`` (``compact_reset=P`` passed as
    ``reset_slots``; ``final_obs`` adds the terminal observation to the
    info), one replay of a ``CapturedStep`` with ``graph=True``
    (``states`` is then its buffers), or with ``fresh_pool=P``
    ``step_batched`` followed by the pool's scenes on the done rows.
    """

    def __init__(self, env, states, generator: torch.Generator,
                 fresh_pool: int | None = None, compact_reset: int | None = None,
                 graph: bool = False, final_obs: bool = False):
        check_options(fresh_pool, compact_reset, graph)
        if fresh_pool and final_obs:
            raise ValueError("final_obs is the autoreset step's; fresh_pool steps "
                             "through step_batched")
        self.env, self.generator = env, generator
        self.fresh_pool, self.compact_reset = fresh_pool, compact_reset
        self.final_obs = final_obs
        self.captured = None
        if graph:
            from highwayenv_tpu_torch.parallel.graph import CapturedStep

            self.captured = CapturedStep(env, states, generator,
                                         reset_slots=compact_reset, final_obs=final_obs)
            states = self.captured.states
        self.states = states
        self._out = None

    def load(self, states) -> None:
        """Start from ``states`` (a batch of the same size: a reset)."""
        if self.captured is not None:
            self.captured.load(states)
        else:
            self.states = states

    def launch(self, actions=None) -> None:
        """Queue the step on ``actions`` (default random ones), with no host
        read."""
        env, gen, states = self.env, self.generator, self.states
        if actions is None:
            actions = random_actions(env, states.time.shape[0], gen, states.time.device)
        if self.captured is not None:
            self.captured.replay(actions)
        elif self.fresh_pool is None:
            self._out = env._autoreset_first(states, actions, gen, self.compact_reset,
                                             self.final_obs)
        else:
            self._out = env.step_batched(states, actions, gen)

    def done(self) -> torch.Tensor:
        """The (B,) done rows of a launched ``fresh_pool`` step."""
        return self._out[3] | self._out[4]

    def finish(self, pool=None, offset=0):
        """Complete the launched step: (obs, states, reward, terminated,
        truncated, info).

        Under ``fresh_pool=P`` the done rows take the scenes of ``pool``,
        an (obs, EnvState) of P scenes (by default drawn here from the
        step's generator after the step), in prefix order from ``offset``:
        done row k of this batch gets scene min(offset + k, P - 1)."""
        if self.captured is not None:
            out = self.captured.finish()
        elif self.fresh_pool is None:
            out = self.env._autoreset_rest(*self._out)
        else:
            obs, stepped, reward, term, trunc, info = self._out
            done = term | trunc
            if pool is None:
                pool = self.env._reset(self.fresh_pool, self.generator)
            rank = torch.clamp(
                offset + torch.cumsum(done.to(torch.int32), 0) - 1, 0, self.fresh_pool - 1
            )
            states, obs = take_scenes(done, pool, rank, stepped, obs)
            out = (obs, states, reward, term, trunc, info)
        self._out = None
        self.states = out[1]
        return out


def rollout(env, states, horizon: int, generator: torch.Generator,
            fresh_pool: int | None = None, compact_reset: int | None = None,
            graph: bool = False):
    """Run ``horizon`` policy steps from ``states`` (``PolicyStep``).

    Returns ``(states, {"mean_reward", "done_rate", "obs_checksum"})`` with
    0-dim tensors: the mean over steps of the batch-mean reward and done
    flag, and the sum of every observation.  With ``graph=True`` the
    returned states are the captured step's own buffers.
    """
    step = PolicyStep(env, states, generator, fresh_pool, compact_reset, graph)
    rewards, dones, obs_sums = [], [], []
    for _ in range(horizon):
        step.launch()
        obs, _, reward, term, trunc, _ = step.finish()
        done = term | trunc
        rewards.append(reward.mean())
        dones.append(done.float().mean())
        obs_sums.append(obs_sum(obs))
    return step.states, {
        "mean_reward": torch.stack(rewards).mean(),
        "done_rate": torch.stack(dones).mean(),
        "obs_checksum": torch.stack(obs_sums).sum(),
    }
