"""Single-device random-policy rollout with per-env autoreset.

Counterpart of the body of ``highwayenv_tpu/parallel/sharding.py::
sharded_rollout_fn`` on one card: each step draws uniform discrete actions,
runs ``step_autoreset_batched`` and folds the observation into a checksum so
the observation head is part of the measured work.  Metrics stay on the
device until the caller reads them.
"""

from __future__ import annotations

import torch


def rollout(env, states, horizon: int, generator: torch.Generator):
    """Run ``horizon`` policy steps from ``states``.

    Returns ``(states, {"mean_reward", "done_rate", "obs_checksum"})`` with
    0-dim tensors: the mean over steps of the batch-mean reward and done
    flag, and the sum of every observation.
    """
    B = states.time.shape[0]
    rewards, dones, obs_sums = [], [], []
    for _ in range(horizon):
        actions = torch.randint(
            0, env.action_type.n, (B,), generator=generator,
            device=states.time.device, dtype=torch.int32,
        )
        obs, states, reward, term, trunc, _ = env.step_autoreset_batched(
            states, actions, generator
        )
        rewards.append(reward.mean())
        dones.append((term | trunc).float().mean())
        obs_sums.append(obs.sum())
    return states, {
        "mean_reward": torch.stack(rewards).mean(),
        "done_rate": torch.stack(dones).mean(),
        "obs_checksum": torch.stack(obs_sums).sum(),
    }
