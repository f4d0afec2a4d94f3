"""Scene state to and from plain numpy arrays.

The port has no weights; what carries over from the JAX package is scene
state.  ``to_numpy_state`` / ``from_numpy_state`` map an ``EnvState`` to the
dict ``{"vehicles": {field: array}, "time": array, "steps": array}`` with the
JAX ``EnvState`` / ``VehicleState`` field names and dtypes, batched (B, ...),
and ``"obs_stack"`` (the GrayscaleObservation's frame stack) where the state
has one.
Other keys of the dict (the JAX per-env PRNG ``key``) are ignored: the port
draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from highwayenv_tpu_torch.envs.base import EnvState
from highwayenv_tpu_torch.vehicle.state import VehicleState


def from_numpy_state(state: dict, device="cpu") -> EnvState:
    veh = state["vehicles"]
    return EnvState(
        vehicles=VehicleState(**{
            f.name: torch.from_numpy(np.array(veh[f.name])).to(device)
            for f in dataclasses.fields(VehicleState)
        }),
        time=torch.from_numpy(np.array(state["time"])).to(device),
        steps=torch.from_numpy(np.array(state["steps"])).to(device),
        obs_stack=(None if state.get("obs_stack") is None
                   else torch.from_numpy(np.array(state["obs_stack"])).to(device)),
    )


def to_numpy_state(state: EnvState) -> dict:
    out = {
        "vehicles": {
            f.name: getattr(state.vehicles, f.name).cpu().numpy()
            for f in dataclasses.fields(VehicleState)
        },
        "time": state.time.cpu().numpy(),
        "steps": state.steps.cpu().numpy(),
    }
    if state.obs_stack is not None:
        out["obs_stack"] = state.obs_stack.cpu().numpy()
    return out
