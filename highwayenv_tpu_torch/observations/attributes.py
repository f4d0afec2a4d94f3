"""AttributesObservation: a dict of env-computed arrays.

PyTorch counterpart of ``highwayenv_tpu/observations/attributes.py``
(reference envs/common/observation.py ``AttributesObservation``): each
attribute name maps to the env's ``attr_<name>(state)``, a (B, ...) tensor
computed from the whole ``EnvState`` (so the env may keep what an attribute
needs, such as its observation noise, in its state).
"""

from __future__ import annotations

import numpy as np


class AttributesObservation:
    #: ``BaseEnv._observe`` passes the whole EnvState
    observes_env = True

    def __init__(self, env, attributes, **kwargs):
        self.env = env
        self.attributes = tuple(attributes)

    def space(self):
        """A Dict of one unbounded float32 Box per attribute, shaped as the
        observation of one freshly reset env."""
        from gymnasium import spaces

        env = self.env
        obs, _ = env.reset(1, env.generator(0))
        return spaces.Dict({
            a: spaces.Box(-np.inf, np.inf, shape=tuple(obs[a].shape[1:]), dtype=np.float32)
            for a in self.attributes
        })

    def observe_env(self, env, state) -> dict:
        return {a: getattr(env, f"attr_{a}")(state) for a in self.attributes}
