"""The port's LidarObservation against the JAX package's, on the CPU.

highway-fast-v0, roundabout-v0 and parking-v0 (walls and obstacles are
``solid``, the goal landmarks are not): states from a port reset batch and
three of its steps, the same states observed by both packages, normalized
and not, alone and under MultiAgentObservation.  Every cell within 1e-5 of
the range (distance and radial velocity), except a cell next to a sector
boundary: an obstacle's centre or a corner of its rectangle whose angle
(shifted by half a cell) lies within 1e-5 rad of one of the cell's two
boundaries may fall on the other side of it in one package, by one ulp of
``atan2``, and the whole cell then flips between a hit and the range.  Each
differing cell must be such a case.  Then the spaces.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import highwayenv_tpu as hj
import highwayenv_tpu_torch as ht
from highwayenv_tpu.envs.base import EnvState as JaxEnvState
from highwayenv_tpu.vehicle.state import VehicleState as JaxVehicleState
from highwayenv_tpu_torch.parallel.rollout import random_actions
from highwayenv_tpu_torch.vehicle.state import VehicleState

torch.set_num_threads(1)

B = 8
IDS = ["highway-fast-v0", "roundabout-v0", "parking-v0"]
ATOL = 1e-5  # of the range
BOUNDARY = 1e-5  # rad


def _jax_state(states) -> JaxEnvState:
    veh = JaxVehicleState(**{f.name: jnp.asarray(getattr(states.vehicles, f.name).numpy())
                             for f in dataclasses.fields(VehicleState)})
    return JaxEnvState(vehicles=veh, time=jnp.asarray(states.time.numpy()),
                       steps=jnp.asarray(states.steps.numpy()),
                       key=jax.random.split(jax.random.PRNGKey(0), states.time.shape[0]))


def _states(et):
    """A reset batch and its three next steps' states."""
    gen = et.generator(5)
    _, st = et.reset(B, gen)
    out = [st]
    for _ in range(3):
        st = et.step_autoreset_batched(st, random_actions(et, B, gen), gen)[1]
        out.append(st)
    return out


def _near_boundary(veh, ego: int, cells: int, rng: float) -> np.ndarray:
    """(B, cells) bool: a cell one of whose boundaries lies within BOUNDARY
    rad of the shifted angle of an eligible obstacle's centre or corner."""
    angle = 2 * np.pi / cells
    pos = veh.pos.double().numpy()
    length, width = veh.length.double().numpy(), veh.width.double().numpy()
    heading = veh.heading.double().numpy()
    delta = pos - pos[:, ego : ego + 1]
    elig = (veh.solid.numpy() & (np.arange(pos.shape[1]) != ego)
            & (np.hypot(delta[..., 0], delta[..., 1]) <= rng))
    hl, hw = length / 2, width / 2
    c, s = np.cos(heading), np.sin(heading)
    points = [delta]
    for lx, ly in ((-hl, -hw), (-hl, hw), (hl, hw), (hl, -hw)):
        points.append(delta + np.stack([c * lx - s * ly, s * lx + c * ly], -1))
    near = np.zeros((pos.shape[0], cells), bool)
    for p in points:
        a = np.arctan2(p[..., 1], p[..., 0]) + angle / 2  # (B, V)
        frac = a / angle
        j = np.round(frac)  # the nearest boundary's index
        close = elig & (np.abs(frac - j) * angle < BOUNDARY)
        for b, v in zip(*np.nonzero(close)):
            # the boundary j * angle is the lower one of cell j, the upper
            # one of cell j - 1
            near[b, int(j[b, v]) % cells] = True
            near[b, (int(j[b, v]) - 1) % cells] = True
    return near


def _check(obs_t, obs_j, veh, ego, cells, rng, scale, where):
    obs_t, obs_j = obs_t.numpy().astype(np.float64), np.asarray(obs_j, np.float64)
    assert obs_t.shape == obs_j.shape == (B, cells, 2), where
    bad = (np.abs(obs_t - obs_j) > ATOL * scale).any(axis=-1)  # (B, cells)
    if bad.any():
        near = _near_boundary(veh, ego, cells, rng)
        assert not (bad & ~near).any(), (where, np.argwhere(bad & ~near)[:4],
                                         obs_t[bad & ~near][:4], obs_j[bad & ~near][:4])
    return int(bad.sum())


@pytest.mark.parametrize("env_id", IDS)
@pytest.mark.parametrize("normalize", [True, False])
def test_torch_lidar_matches_jax(env_id, normalize):
    cfg = {"observation": {"type": "LidarObservation", "normalize": normalize}}
    et, ej = ht.make(env_id, cfg, device="cpu"), hj.make(env_id, cfg)
    ot, oj = et.observation_type, ej.observation_type
    rng, cells = ot.maximum_range, ot.cells
    scale = 1.0 if normalize else rng
    ego = et.ego_slots[0]
    observe_j = jax.vmap(lambda v: oj.observe(ej.geo, v, ego))
    flipped, hits = 0, 0
    for k, st in enumerate(_states(et)):
        obs_t = et._observe(st)
        sj = _jax_state(st)
        flipped += _check(obs_t, observe_j(sj.vehicles), st.vehicles, ego, cells, rng,
                          scale, f"{env_id} state {k}")
        hits += int((obs_t[..., 0] < (1.0 if normalize else rng)).sum())
    assert hits > 0, f"{env_id}: no ray hit anything"
    if env_id == "parking-v0":
        # walls are solid, the goal landmark is not: the reset's rays hit
        # the walls and never stop at the landmark's centre alone
        assert bool(ot.observe(et.geo, st.vehicles, ego)[..., 0].min() < scale)
        assert not bool(st.vehicles.solid[:, et.goal_slot_of(ego)].any())
    assert flipped <= 2, f"{env_id}: {flipped} cells flipped at a boundary"


@pytest.mark.parametrize("env_id", ["highway-fast-v0", "parking-v0"])
def test_torch_lidar_under_multi_agent_observation(env_id):
    cfg = {"controlled_vehicles": 2,
           "observation": {"type": "MultiAgentObservation",
                           "observation_config": {"type": "LidarObservation"}}}
    if env_id == "highway-fast-v0":
        cfg["action"] = {"type": "MultiAgentAction",
                         "action_config": {"type": "DiscreteMetaAction"}}
    et, ej = ht.make(env_id, cfg, device="cpu"), hj.make(env_id, cfg)
    assert et.observation_space == ej.observation_space
    st = _states(et)[-1]
    obs_t = et._observe(st)
    obs_j = jax.vmap(ej._observe)(_jax_state(st))
    assert isinstance(obs_t, tuple) and len(obs_t) == len(obs_j) == 2
    for k, (a, b) in enumerate(zip(obs_t, obs_j, strict=True)):
        _check(a, b, st.vehicles, et.ego_slots[k], 16, 60.0, 1.0,
               f"{env_id} agent {k}")


@pytest.mark.parametrize("config", [{}, {"cells": 8, "maximum_range": 30.0,
                                         "normalize": False}])
def test_torch_lidar_space_and_make(config):
    cfg = {"observation": {"type": "LidarObservation", **config}}
    for env_id in ("highway-v0", "roundabout-v0", "racetrack-v0", "parking-v0"):
        et, ej = ht.make(env_id, cfg, device="cpu"), hj.make(env_id, cfg)
        assert et.observation_space == ej.observation_space, env_id
        obs, _ = et.reset(2, et.generator(0))
        assert obs.shape == (2,) + et.observation_space.shape and obs.dtype == torch.float32
        assert bool(torch.isfinite(obs).all())
