"""MultiAgentObservation and TupleObservation.

PyTorch counterpart of ``highwayenv_tpu/observations/multi.py`` (reference
envs/common/observation.py ``MultiAgentObservation``, ``TupleObservation``).
A multi-agent observation is observed once per ego slot, and
``BaseEnv._observe`` returns the tuple of them; a tuple observation is the
tuple of its sub-observations of one ego.  ``envs/base.py::map_obs``
carries tuples through the autoresets, the captured step and the rollouts.
"""

from __future__ import annotations


class MultiAgentObservation:
    #: ``BaseEnv._observe`` observes every ego slot
    multi_agent = True

    def __init__(self, env, observation_config: dict, **kwargs):
        from highwayenv_tpu_torch.factories import observation_factory

        self.env = env
        self.observation_config = dict(observation_config)
        self.sub = observation_factory(env, self.observation_config)

    def space(self):
        from gymnasium import spaces

        return spaces.Tuple([self.sub.space() for _ in self.env.ego_slots])

    def observe(self, geo, state, ego: int):
        return self.sub.observe(geo, state, ego)


class TupleObservation:
    def __init__(self, env, observation_configs, **kwargs):
        from highwayenv_tpu_torch.factories import observation_factory

        self.env = env
        self.subs = [observation_factory(env, cfg) for cfg in observation_configs]

    def space(self):
        from gymnasium import spaces

        return spaces.Tuple([s.space() for s in self.subs])

    def observe(self, geo, state, ego: int):
        return tuple(s.observe(geo, state, ego) for s in self.subs)
