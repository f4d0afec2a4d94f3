"""highwayenv_tpu_torch — the PyTorch / CUDA port of highwayenv_tpu.

Batched driving environments whose per-frame simulation runs as a
hand-written CUDA kernel on an NVIDIA Hopper card.  The JAX package
``highwayenv_tpu`` stays the reference the port is held against; this
package imports nothing of it and nothing of JAX.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
Every id of the reference's registry is ported (31): the straight highway
envs (highway-v0, highway-fast-v0) on the sorted frame kernels, and on the
general analytic-lane path roundabout, merge, the generic merge and
roundabout, two-way and u-turn (the time-to-collision observation), exit
(the exit observation), the regulated intersection, the racetrack family and
the parking family (the KinematicsGoal dict observation), whose
ContinuousAction egos run the frame kernels' raw-control branch; on every id
the NPCs may be the Linear-family classes (``other_vehicles_type``), which
the frame kernels' Linear rows' instantiation steps.  The -v1 / -v2 ids
(merge-v1, merge-generic-v1, u-turn-v1, exit-v1, roundabout-v1,
roundabout-generic-v1, racetrack-v1, racetrack-large-v1, racetrack-oval-v1,
intersection-v2) search neighbours on the connected lanes too, on the
general kernels' connected instantiations; intersection-multi-agent-v0, -v1
and -v2 run two egos with a MultiAgentAction and a MultiAgentObservation (a
tuple observation; -v1 and -v2 come wrapped in Gymnasium's
``MultiAgentWrapper`` from ``gymnasium.make``); intersection-v1 and
lane-keeping-v0 (the AttributesObservation dict) drive a dynamical
ContinuousAction ego on the BicycleVehicle tire-slip model, on the general
kernels' dynamical instantiations.

``reset_seeded(seed)`` of any env replays the reference's NumPy draw order
for its ``reset(seed)`` scene (``seeding.py``); the single-env ``GymEnv``
(``gym_env.py``) resets through it.
"""

from __future__ import annotations

__version__ = "0.1.0"

_REGISTRY: dict[str, tuple] = {}

#: the config of the ids with the connected-lane neighbour search (the
#: reference's ConnectedLaneNeighboursMixin)
CONNECTED = {"config": {"neighbour_vehicles_connected_lanes": True}}


class NotPortedError(KeyError, NotImplementedError):
    """``make`` of an id the port does not run (yet)."""


def register(env_id: str, cls, kwargs: dict | None = None):
    _REGISTRY[env_id] = (cls, kwargs or {})


def make(env_id: str, config: dict | None = None, device=None,
         sorted_frames: bool = True, lean: bool = True):
    """Instantiate a registered environment on ``device`` (default CUDA).

    Returns an env with batched ``reset(batch_size, generator)`` and
    ``step_autoreset_batched(states, actions, generator)``; see envs/base.py.
    ``sorted_frames=False`` steps the frames through the dense kernel alone
    instead of the s-sorted banded path (the JAX package's ``HT_NO_SORTED``).
    ``lean=False`` (the JAX package's ``pallas_lean = False``) lets a
    straight scene hold obstacle and landmark rows (``HostVehicle`` records
    of those kinds, or a ``kind`` edited in a batch): its frames run the
    dense kernel's objects instantiation, one launch a step; the default
    lean step refuses such rows.
    """
    if env_id not in _REGISTRY:
        raise NotPortedError(
            f"{env_id!r} is unknown or not ported to highwayenv_tpu_torch; "
            f"ported: {sorted(_REGISTRY)}"
        )
    cls, base_kwargs = _REGISTRY[env_id]
    base_config = dict(base_kwargs.get("config", {}))
    if config:
        base_config.update(config)
    return cls(config=base_config or None, device=device,
               sorted_frames=sorted_frames, lean=lean)


def registered_ids():
    return sorted(_REGISTRY)


def make_vec(env_id: str, num_envs: int, config: dict | None = None, **kw):
    """Gymnasium VectorEnv over the batched step (vector_env.py): on the card
    the whole batch steps as one replay of a CUDA graph.

    ``shard=`` splits the batch over the process's cards
    (``parallel/sharding.py``): ``None`` (the default) when the env is on
    CUDA and more than one card divides ``num_envs`` evenly, ``True``
    always (``ValueError`` on a batch that does not divide), ``False``
    never.  Sharded, each card holds an env, a graph and a generator
    seeded from the reset's seed and its shard index
    (``sharding.shard_generators``)."""
    from highwayenv_tpu_torch.vector_env import GymVectorEnv

    return GymVectorEnv(env_id, num_envs, config=config, **kw)


def register_gymnasium_envs(namespace: str = "highwayenv_tpu_torch") -> None:
    """Register every ported id with Gymnasium (gym_env.py): ``make`` gives
    the single-env ``GymEnv``, ``make_vec`` the batched ``GymVectorEnv``."""
    from highwayenv_tpu_torch.gym_env import register_gymnasium_envs as _register

    _register(namespace)


def _register_all():
    from highwayenv_tpu_torch.envs.exit import ExitEnv
    from highwayenv_tpu_torch.envs.highway import HighwayEnv, HighwayEnvFast
    from highwayenv_tpu_torch.envs.intersection import (
        ContinuousIntersectionEnv,
        IntersectionEnv,
        MultiAgentIntersectionEnv,
    )
    from highwayenv_tpu_torch.envs.lane_keeping import LaneKeepingEnv
    from highwayenv_tpu_torch.envs.merge import MergeEnv
    from highwayenv_tpu_torch.envs.merge_generic import MergeGenericEnv
    from highwayenv_tpu_torch.envs.parking import (
        ParkingEnv,
        ParkingEnvActionRepeat,
        ParkingEnvParkedVehicles,
    )
    from highwayenv_tpu_torch.envs.racetrack import (
        RacetrackEnv,
        RacetrackEnvLarge,
        RacetrackEnvOval,
    )
    from highwayenv_tpu_torch.envs.roundabout import RoundaboutEnv
    from highwayenv_tpu_torch.envs.roundabout_generic import RoundaboutGenericEnv
    from highwayenv_tpu_torch.envs.two_way import TwoWayEnv
    from highwayenv_tpu_torch.envs.u_turn import UTurnEnv

    register("exit-v0", ExitEnv)
    register("exit-v1", ExitEnv, CONNECTED)
    register("highway-v0", HighwayEnv)
    register("highway-fast-v0", HighwayEnvFast)
    register("intersection-v0", IntersectionEnv)
    register("intersection-v1", ContinuousIntersectionEnv)
    register("intersection-v2", IntersectionEnv, CONNECTED)
    register("intersection-multi-agent-v0", MultiAgentIntersectionEnv)
    register("intersection-multi-agent-v1", MultiAgentIntersectionEnv)
    register("intersection-multi-agent-v2", MultiAgentIntersectionEnv, CONNECTED)
    register("lane-keeping-v0", LaneKeepingEnv)
    register("merge-v0", MergeEnv)
    register("merge-v1", MergeEnv, CONNECTED)
    register("merge-generic-v0", MergeGenericEnv)
    register("merge-generic-v1", MergeGenericEnv, CONNECTED)
    register("parking-v0", ParkingEnv)
    register("parking-ActionRepeat-v0", ParkingEnvActionRepeat)
    register("parking-parked-v0", ParkingEnvParkedVehicles)
    register("racetrack-v0", RacetrackEnv)
    register("racetrack-v1", RacetrackEnv, CONNECTED)
    register("racetrack-large-v0", RacetrackEnvLarge)
    register("racetrack-large-v1", RacetrackEnvLarge, CONNECTED)
    register("racetrack-oval-v0", RacetrackEnvOval)
    register("racetrack-oval-v1", RacetrackEnvOval, CONNECTED)
    register("roundabout-v0", RoundaboutEnv)
    register("roundabout-v1", RoundaboutEnv, CONNECTED)
    register("roundabout-generic-v0", RoundaboutGenericEnv)
    register("roundabout-generic-v1", RoundaboutGenericEnv, CONNECTED)
    register("two-way-v0", TwoWayEnv)
    register("u-turn-v0", UTurnEnv)
    register("u-turn-v1", UTurnEnv, CONNECTED)


_register_all()
