"""Observation and action types by config["type"].

PyTorch counterpart of ``highwayenv_tpu/factories.py`` (reference
envs/common/observation.py ``observation_factory`` and envs/common/action.py
``action_factory``), so scenario configs stay drop-in.  The port has the
Kinematics, KinematicsGoal, TimeToCollision, ExitObservation,
OccupancyGrid, LidarObservation, GrayscaleObservation,
MultiAgentObservation, TupleObservation and AttributesObservation
observations and the DiscreteMetaAction, ContinuousAction, DiscreteAction
and MultiAgentAction (every observation and action type the JAX package
knows); an unknown type raises ``ValueError`` as in the JAX package.
"""

from __future__ import annotations

from highwayenv_tpu_torch.actions.continuous import ContinuousAction, DiscreteAction
from highwayenv_tpu_torch.actions.discrete_meta import DiscreteMetaAction
from highwayenv_tpu_torch.actions.multi_agent import MultiAgentAction
from highwayenv_tpu_torch.observations.attributes import AttributesObservation
from highwayenv_tpu_torch.observations.exit_obs import ExitObservation
from highwayenv_tpu_torch.observations.grayscale import GrayscaleObservation
from highwayenv_tpu_torch.observations.kinematics import KinematicsObservation
from highwayenv_tpu_torch.observations.kinematics_goal import KinematicsGoalObservation
from highwayenv_tpu_torch.observations.lidar import LidarObservation
from highwayenv_tpu_torch.observations.multi import MultiAgentObservation, TupleObservation
from highwayenv_tpu_torch.observations.occupancy_grid import OccupancyGridObservation
from highwayenv_tpu_torch.observations.ttc import TimeToCollisionObservation

def observation_factory(env, config: dict):
    kwargs = {k: v for k, v in config.items() if k != "type"}
    if config["type"] == "Kinematics":
        return KinematicsObservation(
            reset_edge_lanes=getattr(env, "obs_edge_lanes", None), **kwargs
        )
    if config["type"] == "KinematicsGoal":
        return KinematicsGoalObservation(env, **kwargs)
    if config["type"] == "TimeToCollision":
        return TimeToCollisionObservation(env, **kwargs)
    if config["type"] == "ExitObservation":
        return ExitObservation(
            reset_edge_lanes=getattr(env, "obs_edge_lanes", None), **kwargs
        )
    if config["type"] == "OccupancyGrid":
        return OccupancyGridObservation(**kwargs)
    if config["type"] == "LidarObservation":
        return LidarObservation(**kwargs)
    if config["type"] == "MultiAgentObservation":
        return MultiAgentObservation(env, **kwargs)
    if config["type"] == "TupleObservation":
        return TupleObservation(env, **kwargs)
    if config["type"] == "AttributesObservation":
        return AttributesObservation(env, **kwargs)
    if config["type"] == "GrayscaleObservation":
        return GrayscaleObservation(env, **kwargs)
    raise ValueError(f"Unknown observation type: {config['type']}")


def action_factory(config: dict, env=None):
    kwargs = {k: v for k, v in config.items() if k != "type"}
    if config["type"] == "DiscreteMetaAction":
        return DiscreteMetaAction(**kwargs)
    if config["type"] == "ContinuousAction":
        return ContinuousAction(**kwargs)
    if config["type"] == "DiscreteAction":
        return DiscreteAction(**kwargs)
    if config["type"] == "MultiAgentAction":
        return MultiAgentAction(env, **kwargs)
    raise ValueError(f"Unknown action type: {config['type']}")
