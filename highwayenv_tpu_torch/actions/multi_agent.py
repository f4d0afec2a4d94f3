"""MultiAgentAction: one sub-action type shared by every controlled vehicle.

PyTorch counterpart of ``highwayenv_tpu/actions/multi_agent.py`` (reference
envs/common/action.py ``MultiAgentAction``).  The agent-facing space is a
Tuple of the sub-action's space, one per ego slot; the batched action is
(B, n_agents) plus the sub-action's shape, which ``BaseEnv._action_to_slots``
scatters to the ego slots, so the frames apply the sub-action to every ego
row with its own action.
"""

from __future__ import annotations


class MultiAgentAction:
    """The sub-action of ``action_config`` for each of the env's ego slots.

    Every attribute other than those below is the sub-action's
    (``target_speeds``, ``n``, ``size``, ``longitudinal``, ``speed_table``,
    ...), as the frames and the resets read them."""

    def __init__(self, env, action_config: dict, **kwargs):
        from highwayenv_tpu_torch.factories import action_factory

        self.env = env
        self.action_config = dict(action_config)
        self.sub = action_factory(self.action_config, env)

    def __getattr__(self, name):
        if name == "sub":  # not set yet: no recursion through __getattr__
            raise AttributeError(name)
        return getattr(self.sub, name)

    @property
    def n_agents(self) -> int:
        return len(self.env.ego_slots)

    def space(self):
        from gymnasium import spaces

        return spaces.Tuple([self.sub.space() for _ in range(self.n_agents)])

    def apply(self, geo, state, ego_mask, slot_actions):
        return self.sub.apply(geo, state, ego_mask, slot_actions)
