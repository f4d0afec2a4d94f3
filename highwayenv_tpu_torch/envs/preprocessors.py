"""State preprocessors: planner helpers that rewrite a batch of scenes.

PyTorch counterpart of ``highwayenv_tpu/envs/preprocessors.py`` (reference
envs/common/abstract.py ``simplify``, ``change_vehicles``,
``set_preferred_lane``, ``set_vehicle_field``, ``randomize_behavior``).
Each takes the env and a batched (B, V) ``EnvState`` and returns a new
``EnvState``; the env is configuration only, so the reference's
``deepcopy`` of the env becomes a new state.  The rows ``change_vehicles``
makes Linear (``KIND_LINEAR``) are stepped by LinearVehicle's law on every
frame path: the law goes by each row's kind, and ``change_vehicles`` sets
the env's ``linear_rows``, which sends its frames to the CUDA kernels'
Linear rows' instantiation.

``set_route_at_intersection`` picks each row's route through the host-side
route tools of ``ops/uncertainty.py``.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from highwayenv_tpu_torch.envs.base import NPC_PRESETS, EnvState, with_preset
from highwayenv_tpu_torch.vehicle.state import (
    KIND_EGO,
    KIND_IDM,
    KIND_LINEAR,
    KIND_PAD,
    KIND_PLAIN,
)

#: reference ``AbstractEnv.PERCEPTION_DISTANCE``
PERCEPTION_DISTANCE = 200.0

#: the kind of each NPC class ``change_vehicles`` takes
KIND_OF_CLASS = {
    "IDMVehicle": KIND_IDM,
    "LinearVehicle": KIND_LINEAR,
    "AggressiveVehicle": KIND_LINEAR,
    "DefensiveVehicle": KIND_LINEAR,
    "Vehicle": KIND_PLAIN,
}

#: ``randomize_behavior``'s ranges (reference behavior.py): the IDM
#: exponent, the LinearVehicle acceleration parameters between 0.5 and 1.5
#: times their defaults, and its steering parameters around their defaults
DELTA_RANGE = (3.5, 4.5)
ACCEL_DEFAULT = (0.3, 0.3, 2.0)
STEER_DEFAULT = (5.0, 5.0 / 0.6)
STEER_SPREAD = (0.07, 1.5)


def simplify(env, state: EnvState) -> EnvState:
    """The vehicles beyond ``PERCEPTION_DISTANCE`` of the ego made padding;
    the ego and the objects that are no vehicle stay (reference
    ``AbstractEnv.simplify``)."""
    veh = state.vehicles
    ego = env.ego_slots[0]
    d = veh.pos - veh.pos[:, ego:ego + 1]
    dist = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    slots = torch.arange(veh.kind.shape[1], device=veh.kind.device)
    keep = (dist < PERCEPTION_DISTANCE) | (slots == ego) | ~veh.is_vehicle
    return state.replace(vehicles=veh.replace(kind=torch.where(keep, veh.kind, KIND_PAD)))


def change_vehicles(env, state: EnvState, vehicle_class_path: str) -> EnvState:
    """Every NPC vehicle made the class ``vehicle_class_path`` names
    (reference ``AbstractEnv.change_vehicles``): its kind, and for a
    Linear-family class its acceleration parameters and MOBIL gain, and
    ``env.linear_rows`` set, so that the env's frame kernels run their
    Linear rows' instantiation."""
    name = vehicle_class_path.rsplit(".", 1)[-1]
    kind = KIND_OF_CLASS[name]
    veh = state.vehicles
    is_npc = veh.is_vehicle & (veh.kind != KIND_EGO)
    if name in NPC_PRESETS:
        env.linear_rows = True
        veh = with_preset(veh, is_npc, name)
    else:
        veh = veh.replace(kind=torch.where(is_npc, kind, veh.kind))
    return state.replace(vehicles=veh)


def set_preferred_lane(env, state: EnvState, preferred_lane: int) -> EnvState:
    """The IDM and Linear NPCs' routes pinned to lane id ``preferred_lane``
    and their MOBIL caution off (reference
    ``AbstractEnv.set_preferred_lane``)."""
    veh = state.vehicles
    is_idm = (veh.kind == KIND_IDM) | (veh.kind == KIND_LINEAR)
    has_route = veh.route_base >= 0
    return state.replace(vehicles=veh.replace(
        route_id=torch.where(has_route & is_idm[..., None], preferred_lane, veh.route_id),
        mobil_max_braking=torch.where(is_idm, 1000.0, veh.mobil_max_braking),
    ))


def set_vehicle_field(env, state: EnvState, field: str, value) -> EnvState:
    """``field`` set to ``value`` on every slot but the ego's (reference
    ``AbstractEnv.set_vehicle_field``), e.g. ``enable_lane_change``."""
    veh = state.vehicles
    arr = getattr(veh, field)
    ego = env.ego_slots[0]
    not_ego = torch.arange(arr.shape[1], device=arr.device) != ego
    not_ego = not_ego.view(not_ego.shape + (1,) * (arr.dim() - 2))
    return state.replace(vehicles=veh.replace(**{field: torch.where(not_ego, value, arr)}))


def behavior_draws(shape, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """``randomize_behavior``'s draws for a (B, V) ``shape``, in order: the
    IDM exponents (B, V) in ``DELTA_RANGE`` and the uniforms of the
    acceleration (B, V, 3) and steering (B, V, 2) parameters."""
    dev = generator.device
    lo, hi = DELTA_RANGE
    delta = lo + torch.rand(shape, generator=generator, device=dev) * (hi - lo)
    return {
        "delta": delta,
        "accel_u": torch.rand(tuple(shape) + (3,), generator=generator, device=dev),
        "steer_u": torch.rand(tuple(shape) + (2,), generator=generator, device=dev),
    }


def randomize_behavior(env, state: EnvState, generator: torch.Generator | None = None,
                       draws: dict[str, torch.Tensor] | None = None) -> EnvState:
    """New behaviour parameters for every NPC, independently per env and
    slot (reference ``AbstractEnv.randomize_behavior``): the IDM exponent of
    the IDM and Linear rows, and the acceleration and steering parameters of
    the Linear rows.  The draws come from ``generator`` (``behavior_draws``)
    unless given."""
    veh = state.vehicles
    if draws is None:
        draws = behavior_draws(veh.kind.shape, generator)
    dev = veh.speed.device
    base = torch.tensor(ACCEL_DEFAULT, dtype=torch.float32, device=dev)
    accel_params = 0.5 * base + draws["accel_u"] * (1.5 * base - 0.5 * base)
    sp = torch.tensor(STEER_DEFAULT, dtype=torch.float32, device=dev)
    spread = torch.tensor(STEER_SPREAD, dtype=torch.float32, device=dev)
    lo, hi = sp - spread, sp + spread
    steer_params = lo + draws["steer_u"] * (hi - lo)
    is_idm = veh.kind == KIND_IDM
    is_lin = veh.kind == KIND_LINEAR
    return state.replace(vehicles=veh.replace(
        delta=torch.where(is_idm | is_lin, draws["delta"], veh.delta),
        accel_params=torch.where(is_lin[..., None], accel_params, veh.accel_params),
        steer_params=torch.where(is_lin[..., None], steer_params, veh.steer_params),
    ))


def set_route_at_intersection(env, state: EnvState, slot: int, _to,
                              generator: torch.Generator | None = None) -> EnvState:
    """The road ``slot`` follows at its next intersection chosen, and its
    route arrays rewritten from the cursor (reference
    ``ControlledVehicle.set_route_at_intersection``), in every row: each
    row's own route (``ops/uncertainty.py``'s ``route_of_slot``) and its
    followable routes (``routes_at_intersection``), the one of index
    ``_to`` modulo their count, or with ``_to="random"`` one index a row
    drawn uniformly from ``generator`` (a fresh one if None).  A row with
    no route keeps its own.  The slot's route columns are read to the host
    once and written back as tensors on the state's device."""
    from highwayenv_tpu_torch.ops.uncertainty import _route_of, routes_at_intersection

    veh = state.vehicles
    names = ("route_base", "route_n", "route_id", "route_ptr", "route_len")
    cols = {f: getattr(veh, f)[:, slot].cpu().numpy() for f in names}
    B, R = cols["route_base"].shape
    if _to == "random":
        if generator is None:
            generator = torch.Generator()
            generator.seed()
        draws = torch.rand(B, generator=generator, device=generator.device).cpu().numpy()
    found: dict[tuple, list] = {}
    new = {f: c.copy() for f, c in cols.items()}
    for b in range(B):
        route = tuple(_route_of(env, SimpleNamespace(**{f: c[b][None] for f, c in cols.items()}), 0))
        if route not in found:
            found[route] = routes_at_intersection(env.net, list(route))
        routes = found[route]
        if not routes:
            continue
        k = int(draws[b] * len(routes)) if _to == "random" else _to
        chosen = routes[k % len(routes)]
        new["route_base"][b], new["route_n"][b], new["route_id"][b] = -1, 0, -1
        for i, (f, t, lid) in enumerate(chosen[:R]):
            new["route_base"][b, i] = env.net.global_lane_index((f, t, 0))
            new["route_n"][b, i] = len(env.net.lanes_on_edge(f, t))
            new["route_id"][b, i] = -1 if lid is None else int(lid)
        new["route_ptr"][b] = 0
        new["route_len"][b] = min(len(chosen), R)
    out = {}
    for f in names:
        t = getattr(veh, f).clone()
        t[:, slot] = torch.as_tensor(new[f], device=t.device)
        out[f] = t
    return state.replace(vehicles=veh.replace(**out))
