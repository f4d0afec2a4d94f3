"""Finite-MDP (time-to-collision grid) export of a batch of scenes.

PyTorch counterpart of ``highwayenv_tpu/ops/finite_mdp.py`` (reference
envs/common/finite_mdp.py ``finite_mdp``, ``transition_model``,
``clip_position``): the SPEED x LANE x TIME time-to-collision grid of the
first controlled vehicle (``observations/ttc.py``) with the deterministic
transition table, the rewards of its states and actions and the terminal
states.  Plain tensors, one MDP per env of the batch, for any planner
(value iteration, MCTS); the reference wraps them in the optional
``finite_mdp.mdp.DeterministicMDP``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from highwayenv_tpu_torch.observations.ttc import compute_ttc_grid
from highwayenv_tpu_torch.road import lane as lane_ops


class FiniteMDP(NamedTuple):
    transition: torch.Tensor  # (S, A) int64 next state, the same for every env
    reward: torch.Tensor  # (B, S, A) float32
    terminal: torch.Tensor  # (B, S) bool
    state: torch.Tensor  # (B,) int32 raveled current state
    original_shape: tuple  # (speeds, lanes, times)


def clip_position(h, i, j, shape):
    """The raveled index of (h, i, j) clipped into ``shape``."""
    h = np.clip(h, 0, shape[0] - 1)
    i = np.clip(i, 0, shape[1] - 1)
    j = np.clip(j, 0, shape[2] - 1)
    return np.ravel_multi_index((h, i, j), shape)


def transition_tensor(shape, n_actions: int = 5) -> np.ndarray:
    """The (S, A) next-state table of a grid of ``shape``: every action
    moves one time step on; LANE_LEFT / LANE_RIGHT change the lane, FASTER
    / SLOWER the speed only at time index 0."""
    V, L, T = shape
    h, i, j, a = np.meshgrid(np.arange(V), np.arange(L), np.arange(T),
                             np.arange(n_actions), indexing="ij")
    nxt = clip_position(h, i, j + 1, shape)
    nxt = np.where(a == 0, clip_position(h, i - 1, j + 1, shape), nxt)
    nxt = np.where(a == 2, clip_position(h, i + 1, j + 1, shape), nxt)
    nxt = np.where((a == 3) & (j == 0), clip_position(h + 1, i, j + 1, shape), nxt)
    nxt = np.where((a == 4) & (j == 0), clip_position(h - 1, i, j + 1, shape), nxt)
    return nxt.reshape(V * L * T, n_actions)


def finite_mdp(env, state, time_quantization: float = 1.0, horizon: float = 10.0,
               grid_lanes: int | None = None) -> FiniteMDP:
    """The finite MDP of each env of ``state`` for its first controlled
    slot, on the grid of ``env.connected3`` (the depth-3 connectivity
    matrix).  ``grid_lanes`` sizes the grid's lane axis; None takes
    ``env.ttc_grid_lanes`` or the widest edge."""
    cfg, geo, veh = env.config, env.geo, state.vehicles
    ego = env.ego_slots[0]
    dev = veh.speed.device
    speeds = torch.as_tensor(np.asarray(env.action_type.target_speeds, np.float32),
                             device=dev)
    connected = torch.as_tensor(env.connected3, device=dev)
    if grid_lanes is None:
        grid_lanes = getattr(env, "ttc_grid_lanes", env.max_edge_lanes)
    grid = compute_ttc_grid(geo, veh, ego, speeds, connected, grid_lanes,
                            time_quantization, horizon)  # (B, S, L, T)
    B = grid.shape[0]
    V, L, T = grid.shape[-3:]
    lane_id = geo.lane_id[lane_ops._gather(geo, veh.lane[:, ego])]
    s0 = (veh.speed_index[:, ego] * (L * T) + lane_id * T).to(torch.int32)
    transition = torch.as_tensor(transition_tensor((V, L, T)), device=dev)

    lanes = torch.arange(L, device=dev) / max(L - 1, 1)
    speed_frac = torch.arange(V, device=dev) / max(V - 1, 1)
    state_reward = (
        cfg["collision_reward"] * grid
        + cfg["right_lane_reward"] * lanes[None, :, None]
        + cfg["high_speed_reward"] * speed_frac[:, None, None]
    ).reshape(B, V * L * T)
    lane_change = cfg.get("lane_change_reward", 0)
    action_reward = torch.tensor([lane_change, 0, lane_change, 0, 0],
                                 dtype=torch.float32, device=dev)
    reward = state_reward[..., None] + action_reward
    end_of_horizon = torch.arange(T, device=dev) == T - 1
    terminal = ((grid == 1.0) | end_of_horizon).reshape(B, V * L * T)
    return FiniteMDP(transition, reward, terminal, s0, (V, L, T))
