"""Masked pairwise collision pass over (B, V, V) pair tensors.

PyTorch counterpart of ``highwayenv_tpu/ops/collision.py`` (reference
Road.step pair loop + RoadObject.handle_collisions): a sphere pre-check,
the swept rectangle SAT, then crash / hit flags and the post-collision
impact.  A pair (i, j), i < j, is tested when at least one side is a
vehicle; ``self`` is the lower index.
"""

from __future__ import annotations

import torch

from highwayenv_tpu_torch.utils.math import rects_intersecting_xy_folded
from highwayenv_tpu_torch.vehicle.state import KIND_OBSTACLE, VehicleState


def handle_collisions(state: VehicleState, dt: float) -> VehicleState:
    B, V = state.kind.shape
    idx = torch.arange(V, device=state.kind.device)
    upper = idx[:, None] < idx[None, :]

    def rows(x):
        return x[..., :, None]

    def cols(x):
        return x[..., None, :]

    active, is_veh = state.active, state.is_vehicle
    chk, coll = state.check_collisions, state.collidable
    pair_ok = (
        upper
        & rows(active) & cols(active)
        & (rows(is_veh) | cols(is_veh))
        & (rows(chk) | cols(chk))
        & rows(coll) & cols(coll)
    )
    px, py = state.pos[..., 0], state.pos[..., 1]
    dx = rows(px) - cols(px)
    dy = rows(py) - cols(py)
    diag = state.diagonal
    reach = (rows(diag) + cols(diag)) / 2 + rows(state.speed) * dt
    pair_ok = pair_ok & (dx * dx + dy * dy <= reach * reach)

    velx = state.speed * torch.cos(state.heading)
    vely = state.speed * torch.sin(state.heading)
    inter, will, tx, ty = rects_intersecting_xy_folded(
        rows(px), rows(py), rows(state.length), rows(state.width),
        rows(state.heading),
        cols(px), cols(py), cols(state.length), cols(state.width),
        cols(state.heading),
        relx=(rows(velx) - cols(velx)) * dt,
        rely=(rows(vely) - cols(vely)) * dt,
    )
    inter = inter & pair_ok
    will = will & pair_ok

    solid = state.solid
    both_solid = rows(solid) & cols(solid)
    obst = state.kind == KIND_OBSTACLE
    w = will & both_solid
    neither = ~rows(obst) & ~cols(obst)
    # impact coefficients: the full translation against an obstacle, half
    # each between two vehicles
    coef_i = torch.where(
        w & cols(obst), 1.0, torch.where(w & neither, 0.5, 0.0)
    )
    coef_j = torch.where(
        w & rows(obst), 1.0, torch.where(w & neither, -0.5, 0.0)
    )

    # last-written impact (PARITY #2): the reference ASSIGNS the impact,
    # pairs (k, v) for k ascending arrive before pairs (v, m) for m
    # ascending, so slot v keeps its max-index row-side pair if it writes as
    # ``self``, else its max-index column-side pair, else the old impact
    write_i = w & ~rows(obst)
    write_j = w & ~cols(obst)
    last_j = torch.where(write_i, idx, -1).amax(dim=-1)  # (B, V)
    last_i = torch.where(write_j, idx[:, None], -1).amax(dim=-2)
    any_row, any_col = last_j >= 0, last_i >= 0

    def pick_row(t):  # t[b, v, last_j[b, v]]
        g = last_j.clamp(min=0).long()[..., None]
        return torch.gather(t, -1, g)[..., 0]

    def pick_col(t):  # t[b, last_i[b, v], v]
        g = last_i.clamp(min=0).long()[..., None, :]
        return torch.gather(t, -2, g)[..., 0, :]

    imp_x = torch.where(
        any_row, pick_row(coef_i * tx),
        torch.where(any_col, pick_col(coef_j * tx), state.impact[..., 0]),
    )
    imp_y = torch.where(
        any_row, pick_row(coef_i * ty),
        torch.where(any_col, pick_col(coef_j * ty), state.impact[..., 1]),
    )

    crash_pair = inter & both_solid
    crashed = state.crashed | crash_pair.any(dim=-1) | crash_pair.any(dim=-2)
    hit_i = inter & ~rows(solid)
    hit_j = inter & ~cols(solid)
    hit = state.hit | hit_i.any(dim=-1) | hit_j.any(dim=-2)
    return state.replace(
        crashed=crashed,
        hit=hit,
        impact=torch.stack([imp_x, imp_y], dim=-1),
        impact_pending=state.impact_pending | any_row | any_col,
    )
