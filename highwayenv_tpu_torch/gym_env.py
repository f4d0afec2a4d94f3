"""Gymnasium registration of the port's envs.

``register_gymnasium_envs()`` registers every ported id under
``highwayenv_tpu_torch/<id>`` with ``vector_entry_point`` set to
``vector_env.GymVectorEnv``, so ``gymnasium.make_vec`` steps the whole batch
at once.  The single-env ``GymEnv`` of the JAX package is not ported: with a
seed it replays the reference's NumPy draw order through ``seeding.py``,
which the port does not have yet, so ``gymnasium.make`` raises
``NotPortedError`` and says so.
"""

from __future__ import annotations

import gymnasium

from highwayenv_tpu_torch import NotPortedError


def single_env_not_ported(**kwargs):
    """The ``entry_point`` of every registered id: refuses, naming why."""
    raise NotPortedError(
        "the single-env GymEnv is not ported yet: a seeded reset replays the "
        "reference's NumPy draw order through highwayenv_tpu/seeding.py, "
        "which has no counterpart in the port; use gymnasium.make_vec"
    )


def register_gymnasium_envs(namespace: str = "highwayenv_tpu_torch") -> None:
    """Register every ported id with Gymnasium under ``namespace/<id>``."""
    import highwayenv_tpu_torch as ht

    for env_id in ht.registered_ids():
        name = f"{namespace}/{env_id}"
        if name in gymnasium.registry:
            continue
        gymnasium.register(
            id=name,
            entry_point="highwayenv_tpu_torch.gym_env:single_env_not_ported",
            vector_entry_point="highwayenv_tpu_torch.vector_env:GymVectorEnv",
            kwargs={"env_id": env_id},
        )
