"""All frames of a policy step on an analytic-lane network: CUDA kernels + plain torch.

Counterpart of ``highwayenv_tpu/ops/general_pallas_bm.py``
(``build_general_frame``, ``pallas_simulate_general``), the general path of
the envs whose lanes are straight, sine and circular (roundabout-v0,
merge-v0, intersection-v0).  One frame is the JAX package's
``BaseEnv._frame`` in its default branch (no dynamical egos, decisions on
the frame-start state):

  1. ``follow_road``: controlled vehicles whose target lane ends take the
     next lane, along their route or by the closest successor edge;
  2. the ego's DiscreteMetaAction on the first frame of the policy step;
     with ``raw`` (a ContinuousAction or DiscreteAction, stored on the
     egos before the frames: the JAX kernel's ``raw_controls`` branch) the
     egos keep their stored steering and acceleration instead;
  3. the IDM / MOBIL decision pass on the (B, L, V) projection table of
     every object on every lane, with the route-directed override and the
     same-road abort gate, and the dual-lane IDM acceleration; a Linear
     row (``KIND_LINEAR``) decides with LinearVehicle's acceleration; with
     ``GeneralSpec.connected`` (the -v1 / -v2 ids) every neighbour query
     also searches the query lane's successor and predecessor lanes
     (``behavior.neighbours_connected``);
  4. the steering P-cascade toward the target lane's heading ahead (IDM
     rows, and the ego unless it keeps raw controls), LinearVehicle's
     steering law on Linear rows;
  5. on a regulated road (intersection), on the env's tick frames, the
     right-of-way pass of ``road/regulation.py`` (it writes only the
     target speed and the yielding state, which no later step of the frame
     reads);
  6. bicycle integration (with ``GeneralSpec.dynamical``, a dynamical
     ContinuousAction, the egos' rows then taken from one RK4 step of the
     tire-slip model of ``vehicle/dynamics.py``, as the JAX package's
     ``BaseEnv._frame`` overrides them), the new projection table and the
     heading-aware re-localization (closest lane by |lat| + overrun +
     heading distance);
  7. swept-SAT collisions with obstacles and last-write impacts.

``frames_general_plain`` runs them in batched torch; it is what the CPU
and ``BaseEnv._simulate`` use.  On CUDA tensors all frames of a step run in
one launch of ``csrc/general_frames.cu``: ``frames_general_kernel`` (K4)
without the regulated block, ``frames_regulated_kernel`` (K5) with it, and
on a connected spec their ``kConnected`` instantiations
``frames_general_connected_kernel`` and
``frames_regulated_connected_kernel``, on a dynamical spec their
``kDynamical`` instantiations ``frames_general_dynamical_kernel`` and
``frames_regulated_dynamical_kernel``, and on a spec with both flags the
instantiations with both, ``frames_general_connected_dynamical_kernel`` and
``frames_regulated_connected_dynamical_kernel``, each with its own launch
count; a scene of more than ``NARROW_SLOTS`` slots launches the wide twin
of its instantiation (``csrc/general_frames_wide.cu``, one env a block of
128 threads, up to ``WIDE_SLOTS``: ``frames_general_wide_kernel`` ...), and
one of more than ``WIDE_SLOTS`` its cluster twin
(``csrc/general_frames_cluster.cu``, one env a thread-block cluster of up
to 16 such blocks, up to ``MAX_SLOTS``: ``frames_general_cluster_kernel``
...), and a scene that no layout with shared memory holds (over
``MAX_SLOTS`` slots, or a block over ``SMEM_LIMIT``: ``launch_smem``) its
global twin (``csrc/general_frames_global.cu``, the cluster design with an
env's arrays in a slab of global memory, up to ``GLOBAL_SLOTS``:
``frames_general_global_kernel`` ...), picked by ``frames_kernel_for``
(``layout_for``); on CPU tensors all run ``frames_general_plain``.
The kernels' tables are sized by the scene: lanes, lanes an edge, route
slots, successor and predecessor edges, candidate lanes and target speeds
(``lane_tables``, ``conn_tables``, ``speed_table``), and poly lanes read
from the sample bank (``poly_tables``); what bounds a scene is its slots
(``GLOBAL_SLOTS``) and a grid of one target speed.  ``try_general`` is the
scope gate: the envs outside it raise when made, naming the reason.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from highwayenv_tpu_torch.ops import collision
from highwayenv_tpu_torch.ops.straight_frames import (
    KernelWrapper,
    checked_fields,
    empty_fields,
    on_cuda,
    with_fields,
)
from highwayenv_tpu_torch.road import lane as lane_ops
from highwayenv_tpu_torch.road import regulation
from highwayenv_tpu_torch.road.lane import LaneGeometry
from highwayenv_tpu_torch.vehicle import behavior, controller, dynamics, kinematics
from highwayenv_tpu_torch.vehicle.behavior import IDMParams
from highwayenv_tpu_torch.vehicle.state import KIND_EGO, KIND_LINEAR, VehicleState

#: the layouts' slots: the global kernels hold an env's slots in a cluster of
#: up to 16 blocks of up to ``GLOBAL_THREADS`` threads, one a slot, their
#: arrays in global memory (at most ``GLOBAL_SLOTS``: the card holds such a
#: cluster, ``GeneralFramesKernel.cluster_fit``, ``tools/cluster_fit.py``);
#: the cluster kernels in a cluster of up to 16 blocks of 128 threads (over
#: the portable cluster size of 8 through the non-portable size attribute),
#: at most ``MAX_SLOTS``; the wide ones in one block (at most
#: ``WIDE_SLOTS``), the narrow ones in a warp (at most ``NARROW_SLOTS``).
#: Every table is sized by the scene (lanes, lanes an edge, route slots,
#: successor and predecessor edges, target speeds); a scene whose block
#: would ask more shared memory than ``SMEM_LIMIT`` (``launch_smem``) takes
#: the global kernels, which ask none
GLOBAL_SLOTS = 8192
GLOBAL_THREADS = 512
MAX_SLOTS = 2048
WIDE_SLOTS = 128
NARROW_SLOTS = 32
#: the shared memory a block may ask on an H100 (its opt-in maximum,
#: ``cudaDevAttrMaxSharedMemoryPerBlockOptin``: 227 KB)
SMEM_LIMIT = 232448
#: the fixed layout of the tables (``GEN_FIXED_SUCC`` ... in the .cu): a
#: scene within it (no poly lane, at most 4 successor edges, 16 route slots
#: and, under the connected-lane search, 9 candidate lanes a lane) runs the
#: kernels' instantiations of compile-time strides, its tables padded to
#: it; any other the ``kSized`` one of the ``_sized`` libraries
#: (``launch_tables``)
FIXED_SUCC = 4
FIXED_CONN = 9
FIXED_ROUTE = 16
FIXED_SPEEDS = 16


def launch_tables(S: int, K: int | None, poly: bool, R: int = 1,
                  n_speeds: int | None = None) -> tuple[int, int, bool]:
    """(successor columns, candidate columns, sized) of a launch's tables
    for a scene of S successor edges a lane, K candidate lanes a lane
    (None without the connected-lane search), poly lanes or not, R route
    slots and ``n_speeds`` target speeds (None under raw controls): the
    fixed layout's padded ones, or the scene's own under ``kSized``."""
    sized = (poly or S > FIXED_SUCC or R > FIXED_ROUTE or (K is not None and K > FIXED_CONN)
             or (n_speeds is not None and n_speeds > FIXED_SPEEDS))
    if sized:
        return S, K or 0, True
    return FIXED_SUCC, 0 if K is None else FIXED_CONN, False


class GeneralSpec(NamedTuple):
    """What a general frame needs besides the state."""

    geo: LaneGeometry
    p: IDMParams
    dt: float
    max_edge_lanes: int
    action_type: object  # DiscreteMetaAction, ContinuousAction or DiscreteAction
    #: frames between right-of-way ticks on a regulated road, else None
    period: int | None = None
    #: the connected-lane neighbour search (``neighbour_vehicles_connected_lanes``)
    connected: bool = False
    #: the egos integrate by the tire-slip model (a dynamical action type)
    dynamical: bool = False
    #: the reference's decision order (``sequential_decisions``): plain
    #: torch frames only, on any network, no kernel
    sequential: bool = False
    #: the route slots a slot holds (the env's ``route_slots``), which the
    #: layout of a launch counts (``frames_kernel_for``)
    route_slots: int = 1


def _words_env(L: int, V: int, R: int, regulated: bool, W: int) -> int:
    """``EnvSmem::words`` of the .cu: one env's words in shared memory."""
    rows = 2 * L * V + 9 * V
    union = max(rows, 4 * 11 * V + 7 * V + 2 * R * V) if regulated else rows
    w = 2 * V + union + 12 * V + 3 * R * V + W * (L + V + 4)
    return (w + 1) & ~1


def _words_block(L: int, V: int, S: int, K: int, sized: bool) -> int:
    """``block_words`` of the .cu: the lane tables, the lanes' order, the
    candidate tables (K a lane, 0 without the search) and the pair table."""
    w = (L * (LANE_F_WORDS + lane_i_words(S, sized) + 1) + 2 * L * K
         + (V * (V - 1) // 2 + 1) // 2)
    return (w + 1) & ~1


def launch_smem(V: int, L: int, R: int, S: int, K: int, regulated: bool,
                sized: bool = False) -> int:
    """The shared memory, in bytes, that a block of the launch asks at a
    scene of V slots, L lanes, R route slots, S successor columns and K
    candidate columns a lane (0 without the connected-lane search), in the
    fixed or the ``sized`` layout, in the layout of shared memory that V
    picks (narrow, wide or cluster; the global layout asks none): the .cu's
    ``launch_smem`` (``general_smem_bytes`` of each library, which
    chip_smoke.py holds this copy to)."""
    if V > WIDE_SLOTS:  # a cluster's block: 128 slots of its own, no pair table
        return 4 * (_words_block(L, 0, S, K, sized)
                    + _words_env(L, WIDE_SLOTS, R, regulated, 4))
    if V > NARROW_SLOTS:  # one env a block
        return 4 * (_words_block(L, V, S, K, sized) + _words_env(L, V, R, regulated, 4))
    envs = 64 // (16 if V <= 16 else 32)
    return 4 * (_words_block(L, V, S, K, sized) + envs * _words_env(L, V, R, regulated, 1))


def global_threads(V: int) -> int:
    """Threads a block of the global launch at V slots: the fewest of 128,
    256 and ``GLOBAL_THREADS`` whose 16 blocks hold V (``global_threads`` of
    the .cu)."""
    threads = WIDE_SLOTS
    while threads < GLOBAL_THREADS and -(-V // threads) > 16:
        threads *= 2
    return threads


def global_words(L: int, V: int, R: int, regulated: bool) -> int:
    """The float32 words of one env's slab in the global layout at a scene
    of V slots, L lanes and R route slots: a chunk of 128 slots laid out as
    a cluster block's shared memory (``_words_env`` at 128 slots, 4 mask
    words) for each 128 threads of the launch's blocks (``global_words`` of
    the .cu, ``general_global_words`` of the library, which chip_smoke.py
    holds this copy to)."""
    G = global_threads(V)
    return -(-V // G) * (G // WIDE_SLOTS) * _words_env(L, WIDE_SLOTS, R, regulated, 4)


def layout_for(V: int, L: int, R: int, S: int, n_speeds: int | None,
               K: int | None = None, regulated: bool = False, poly: bool = False) -> str:
    """The layout of the frame kernels a scene launches ("" narrow, "wide",
    "cluster" or "global"; the arguments as ``kernel_limits`` takes them):
    the one of shared memory its slots pick (up to ``NARROW_SLOTS``,
    ``WIDE_SLOTS``, ``MAX_SLOTS``) where a block of it asks at most
    ``SMEM_LIMIT`` bytes (``launch_smem``, the tables as ``launch_tables``
    lays them out), else the global one."""
    S_t, K_t, sized = launch_tables(S, K, poly, R, n_speeds)
    if V <= MAX_SLOTS and launch_smem(V, L, R, S_t, K_t, regulated, sized) <= SMEM_LIMIT:
        return "cluster" if V > WIDE_SLOTS else "wide" if V > NARROW_SLOTS else ""
    return "global"


def kernel_limits(V: int, L: int, R: int, S: int, n_speeds: int | None,
                  K: int | None = None, regulated: bool = False,
                  poly: bool = False) -> list[str]:
    """The limits of the kernels that a scene of V slots, L lanes, R route
    slots, S successor edges a lane, ``n_speeds`` target speeds (None under
    raw controls) and, under the connected-lane search, K candidate lanes a
    lane (None without it), on a regulated road or not, with poly lanes or
    not, breaks: the slots of the global layout and a grid of one speed
    (``speed_to_index`` divides by the grid's span).  Lanes, lanes an edge,
    route slots, successor and predecessor edges and target speeds are
    tables of the scene's size, and a scene whose block of shared memory
    would be too large takes the global layout (``layout_for``).  A
    dynamical action is no limit: every instantiation has its dynamical
    twin, the connected ones too."""
    return [
        what for what, bad in (
            (f"{V} slots > {GLOBAL_SLOTS}", V > GLOBAL_SLOTS),
            (f"{n_speeds} target speeds < 2 (speed_to_index divides by the grid's span)",
             n_speeds is not None and n_speeds < 2),
        ) if bad
    ]


def _connected(env) -> bool:
    return bool(env.config.get("neighbour_vehicles_connected_lanes", False))


def dynamical(action_type) -> bool:
    """Whether ``action_type`` integrates its egos by the tire-slip model."""
    return bool(getattr(action_type, "dynamical", False))


def general_unported(env) -> list[str]:
    """Why ``env`` cannot take the general path: every limit of the
    kernels' arrays, so that no env that is made is refused at launch (the
    JAX package's gate bounds only V and L, and runs the connected-lane
    search outside its kernel)."""
    geo, at = env.geo, env.action_type
    return kernel_limits(
        env.num_slots, geo.num_lanes, env.route_slots, geo.succ_edge_base.shape[1],
        None if at.stores_raw_controls else len(at.target_speeds),
        geo.conn_lanes.shape[1] if _connected(env) else None, env.regulated,
        geo.poly is not None,
    )


def sequential(env) -> bool:
    """Whether ``env`` decides in the reference's act() order
    (``config["sequential_decisions"]``)."""
    return bool(env.config.get("sequential_decisions", False))


def try_general(env) -> GeneralSpec | None:
    """The general path's spec, or None when the env is outside the gate.
    A ``sequential_decisions`` env launches no kernel, so the kernels'
    limits do not gate it."""
    if not sequential(env) and general_unported(env):
        return None
    return GeneralSpec(
        geo=env.geo, p=env.idm_params, dt=env.dt,
        max_edge_lanes=int(env.max_edge_lanes), action_type=env.action_type,
        period=env._regulation_period if env.regulated else None,
        connected=_connected(env), dynamical=dynamical(env.action_type),
        sequential=sequential(env), route_slots=int(env.route_slots),
    )


def _check_raw(slot_actions, raw: bool) -> None:
    """Raw controls are stored before the frames, which then take no slot
    actions; meta-actions are applied inside and must be given."""
    if raw != (slot_actions is None):
        raise ValueError("slot_actions go with meta-actions; raw controls are "
                         "stored on the egos first (store_raw_controls)")


# --------------------------------------------------------------------------- #
# plain torch
# --------------------------------------------------------------------------- #


def frame_general_plain(veh: VehicleState, spec: GeneralSpec, table,
                        slot_actions: torch.Tensor | None,
                        tick: torch.Tensor | None = None, raw: bool = False):
    """One frame on (B, V) fields from the frame-start projection table
    ``(s, lat)`` (B, L, V); the ego's action is applied when
    ``slot_actions`` is given, the right-of-way pass in the envs where the
    (B,) bool ``tick`` is set; with ``raw`` the egos keep their stored
    controls.  Under ``spec.sequential`` the decisions go in the
    reference's order (the JAX package's ``_frame`` branch): the ego's
    action, then ``behavior.idm_act_sequential``.  Returns the state and
    the new table."""
    geo, p = spec.geo, spec.p
    table_s, table_lat = table
    if spec.sequential:
        # the reference's act() order: the ego's action first, then slot
        # after slot its follow_road and decision
        if slot_actions is not None:
            veh = spec.action_type.apply(geo, veh, veh.kind == KIND_EGO, slot_actions)
        veh, idm_acc = behavior.idm_act_sequential(
            geo, p, veh, table_s, table_lat, spec.max_edge_lanes, spec.connected)
    else:
        veh = controller.follow_road(geo, veh, spec.max_edge_lanes, table_s)
        if slot_actions is not None:
            veh = spec.action_type.apply(geo, veh, veh.kind == KIND_EGO, slot_actions)
        veh, idm_acc = behavior.idm_act(geo, p, veh, table_s, table_lat, spec.connected)
    # the ego's target is its own after the decision pass: one steering
    # law serves the ego and the IDM rows, LinearVehicle's the Linear rows
    steer = controller.steering_from_table(
        geo, veh.target_lane, veh, table_s, table_lat, veh.kind == KIND_LINEAR
    )
    # a raw-control ego keeps its stored steering and acceleration
    is_ego = (veh.kind == KIND_EGO) & (not raw)
    is_idm = behavior.is_driven(veh)
    veh = veh.replace(
        steering=torch.where(is_ego | is_idm, steer, veh.steering),
        accel=torch.where(
            is_ego, controller.speed_control(veh.target_speed, veh.speed),
            torch.where(is_idm, idm_acc, veh.accel),
        ),
    )
    if tick is not None and bool(tick.any()):
        # after the controls, before integration, on the frame-start state
        ruled = regulation.enforce_road_rules(geo, veh)
        t = tick[:, None]
        veh = veh.replace(
            target_speed=torch.where(t, ruled.target_speed, veh.target_speed),
            is_yielding=torch.where(t, ruled.is_yielding, veh.is_yielding),
            yield_timer=torch.where(t, ruled.yield_timer, veh.yield_timer),
        )
    pre = veh
    veh = kinematics.integrate(veh, spec.dt)
    if spec.dynamical:
        # the egos' rows from one RK4 step of the pre-integration state; they
        # keep the kinematic pass's crash, impact and timer updates
        ego = pre.kind == KIND_EGO
        dyn = dynamics.integrate_dynamic(pre, spec.dt, ego)
        veh = veh.replace(
            pos=torch.where(ego[..., None], dyn.pos, veh.pos),
            heading=torch.where(ego, dyn.heading, veh.heading),
            speed=torch.where(ego, dyn.speed, veh.speed),
            lateral_speed=torch.where(ego, dyn.lateral_speed, veh.lateral_speed),
            yaw_rate=torch.where(ego, dyn.yaw_rate, veh.yaw_rate),
        )
    table = lane_ops.projection_table(geo, veh.pos)
    new_lane = lane_ops.closest_lane_from_table(geo, *table, veh.heading)
    veh = veh.replace(lane=torch.where(veh.is_vehicle, new_lane, veh.lane))
    return collision.handle_collisions(veh, spec.dt), table


def frames_general_plain(veh: VehicleState, spec: GeneralSpec,
                         slot_actions: torch.Tensor | None, frames: int,
                         steps0: torch.Tensor | None = None,
                         raw: bool = False) -> VehicleState:
    """``frames`` frames in plain batched torch, the ego's meta-action on
    the first, or with ``raw`` (and no ``slot_actions``) the egos' stored
    controls kept: K4's reference.  With the (B,) int32 frame counters
    ``steps0`` of a regulated road's envs at the step's start, frame ``i``
    of env ``b`` is a right-of-way tick when
    ``(steps0[b] + i + 1) % period == 0``: K5's reference."""
    if (steps0 is None) != (spec.period is None):
        raise ValueError("steps0 goes with a regulated road, and only there")
    _check_raw(slot_actions, raw)
    tick_phase = None
    if steps0 is not None:
        # the phase alone, in int32: the counter itself may grow without bound
        tick_phase = torch.remainder(steps0.to(torch.int32), spec.period)
    table = lane_ops.projection_table(spec.geo, veh.pos)
    for i in range(frames):
        tick = None
        if tick_phase is not None:
            tick = torch.remainder(tick_phase + (i + 1), spec.period) == 0
        veh, table = frame_general_plain(
            veh, spec, table, slot_actions if i == 0 else None, tick, raw=raw
        )
    return veh


# --------------------------------------------------------------------------- #
# the CUDA kernel's wrapper
# --------------------------------------------------------------------------- #

_LANE_F = ("sx", "sy", "ux", "uy", "nx", "ny", "heading0", "amplitude",
           "pulsation", "phase", "cx", "cy", "radius", "start_phase", "cw",
           "width", "length", "speed_limit")
_LANE_I = ("kind", "forbidden", "lane_id", "edge_base", "edge_n", "from_node",
           "to_node")
LANE_F_WORDS = len(_LANE_F)
#: the first successor column: S base lanes, then S lane counts, then the
#: priority and (the kSized layout) the lane's poly bank row
LANE_I_SUCC = len(_LANE_I)
#: the priority's column in the fixed layout (S = FIXED_SUCC)
LANE_I_PRIORITY = LANE_I_SUCC + 2 * FIXED_SUCC


def lane_i_words(S: int, sized: bool) -> int:
    """Words of an int lane row at S successor columns, in the fixed or the
    ``sized`` layout (``lane_i_words`` of the .cu; 16 in the fixed one)."""
    return LANE_I_SUCC + 2 * S + 1 + int(sized)


def lane_tables(geo: LaneGeometry, device, succ: int | None = None,
                sized: bool | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's (L, LANE_F_WORDS) float and (L, lane_i_words(S, sized))
    int lane tables (the counterpart of ``GeneralGeo``): the columns of
    ``_LANE_I``, S = ``succ`` successor edges' base lanes (-1 pad) and lane
    counts (0 pad), the priority, and in the ``sized`` layout the lane's
    poly bank row (-1 on an analytic lane).  By default the layout
    ``launch_tables`` gives the network (under no connected search, at one
    route slot)."""
    n_succ = geo.succ_edge_base.shape[1]
    if sized is None:
        succ, _, sized = launch_tables(n_succ, None, geo.poly is not None)
    S = n_succ if succ is None else succ
    if S < n_succ:
        raise ValueError(f"{S} successor columns < the scene's {n_succ}")
    cols = {
        "sx": geo.start[:, 0], "sy": geo.start[:, 1],
        "ux": geo.direction[:, 0], "uy": geo.direction[:, 1],
        "nx": geo.direction_lateral[:, 0], "ny": geo.direction_lateral[:, 1],
        "cx": geo.center[:, 0], "cy": geo.center[:, 1],
    }
    lf = torch.stack(
        [cols[k] if k in cols else getattr(geo, k) for k in _LANE_F], dim=1
    ).to(device=device, dtype=torch.float32).contiguous()
    L, n = geo.num_lanes, LANE_I_SUCC
    li = torch.full((L, lane_i_words(S, sized)), -1, dtype=torch.int32)
    for k, name in enumerate(_LANE_I):
        li[:, k] = getattr(geo, name).cpu().to(torch.int32)
    li[:, n:n + n_succ] = geo.succ_edge_base.cpu()
    li[:, n + S:n + 2 * S] = 0
    li[:, n + S:n + S + n_succ] = geo.succ_edge_n.cpu()
    li[:, n + 2 * S] = geo.priority.cpu().to(torch.int32)
    if sized and geo.poly is not None:
        li[:, n + 2 * S + 1] = geo.poly.slot.cpu().to(torch.int32)
    return lf, li.to(device).contiguous()


def conn_tables(geo: LaneGeometry, device,
                cands: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The connected kernels' (L, K) int candidate lanes (-1 pad) and float
    offsets (0 pad): ``geo.conn_lanes`` / ``conn_offsets`` (K = 1 + S + P
    columns), padded to ``cands`` columns where given."""
    L, n = geo.conn_lanes.shape
    K = n if cands is None else cands
    if K < n:
        raise ValueError(f"{K} candidate columns < the scene's {n}")
    lanes = torch.full((L, K), -1, dtype=torch.int32)
    offsets = torch.zeros((L, K), dtype=torch.float32)
    lanes[:, :n] = geo.conn_lanes.cpu()
    offsets[:, :n] = geo.conn_offsets.cpu()
    return lanes.to(device).contiguous(), offsets.to(device).contiguous()


def poly_tables(geo: LaneGeometry, device) -> tuple[torch.Tensor, ...]:
    """The kernels' copy of the poly bank (``PolyBank`` of the .cu): the
    (P, S, 2) pose samples and tangents, their (P,) counts, the (P, 3, C)
    control points (arc length, x, y) and their (P,) counts; () on a network
    without poly lanes."""
    bank = geo.poly
    if bank is None:
        return ()
    f32 = dict(device=device, dtype=torch.float32)
    i32 = dict(device=device, dtype=torch.int32)
    return (bank.pos.to(**f32).contiguous(), bank.normal.to(**f32).contiguous(),
            bank.n.to(**i32).contiguous(),
            torch.stack([bank.cp_s, bank.cp_x, bank.cp_y], dim=1).to(**f32).contiguous(),
            bank.cp_n.to(**i32).contiguous())


class PolyBankFields(ctypes.Structure):
    """The ctypes mirror of the .cu's ``PolyBank``: the device pointers of
    ``poly_tables``, samples a bank row and control points a bank row."""

    _fields_ = [
        ("pos", ctypes.c_void_p), ("normal", ctypes.c_void_p), ("n", ctypes.c_void_p),
        ("cp", ctypes.c_void_p), ("cp_n", ctypes.c_void_p),
        ("S", ctypes.c_int), ("C", ctypes.c_int),
    ]


class GenParams(ctypes.Structure):
    """The ctypes mirror of the .cu's ``GenParams``; its pointers (the
    speed grid, the poly bank) are the wrapper's device tables."""

    _fields_ = [
        ("L", ctypes.c_int), ("M", ctypes.c_int), ("V", ctypes.c_int),
        ("R", ctypes.c_int), ("frames", ctypes.c_int),
        ("n_speeds", ctypes.c_int), ("longitudinal", ctypes.c_int),
        ("lateral", ctypes.c_int), ("period", ctypes.c_int), ("raw", ctypes.c_int),
        ("dt", ctypes.c_float), ("acc_max", ctypes.c_float),
        ("comfort_acc_max", ctypes.c_float), ("distance_wanted", ctypes.c_float),
        ("time_wanted", ctypes.c_float), ("inv_two_sqrt_ab", ctypes.c_float),
        ("politeness", ctypes.c_float), ("lane_change_delay", ctypes.c_float),
        ("kp_a", ctypes.c_float), ("kp_heading", ctypes.c_float),
        ("kp_lateral", ctypes.c_float), ("tau_pursuit", ctypes.c_float),
        ("ts_lo", ctypes.c_float), ("inv_ts_range", ctypes.c_float),
        ("target_speeds", ctypes.c_float * FIXED_SPEEDS),
        ("linear", ctypes.c_int), ("S", ctypes.c_int), ("K", ctypes.c_int),
        ("speed_grid", ctypes.c_void_p),
        ("poly", PolyBankFields),
    ]


_IN_FIELDS = [
    # (name, dtype, trailing shape); "R" is the route width
    ("pos", torch.float32, (2,)), ("heading", torch.float32, ()),
    ("speed", torch.float32, ()), ("lane", torch.int32, ()),
    ("target_lane", torch.int32, ()), ("target_speed", torch.float32, ()),
    ("timer", torch.float32, ()), ("crashed", torch.bool, ()),
    ("hit", torch.bool, ()), ("impact_pending", torch.bool, ()),
    ("impact", torch.float32, (2,)), ("steering", torch.float32, ()),
    ("accel", torch.float32, ()), ("route_ptr", torch.int32, ()),
    ("speed_index", torch.int32, ()), ("delta", torch.float32, ()),
    ("kind", torch.int32, ()), ("length", torch.float32, ()),
    ("width", torch.float32, ()), ("check_collisions", torch.bool, ()),
    ("collidable", torch.bool, ()), ("enable_lane_change", torch.bool, ()),
    ("mobil_gain", torch.float32, ()), ("mobil_max_braking", torch.float32, ()),
    ("route_len", torch.int32, ()), ("route_base", torch.int32, ("R",)),
    ("route_n", torch.int32, ("R",)), ("route_id", torch.int32, ("R",)),
    # read on Linear rows only
    ("accel_params", torch.float32, (3,)), ("steer_params", torch.float32, (2,)),
]
#: the mutated fields, written to new tensors (JAX ``GEN_MUT_FIELDS``)
OUT_FIELDS = _IN_FIELDS[:15]
#: K5's further fields, read and written (JAX ``gen_fields(R, regulated=True)``)
REG_FIELDS = [("is_yielding", torch.bool, ()), ("yield_timer", torch.int32, ())]
#: the ``kDynamical`` instantiations' further fields, read and written
DYN_FIELDS = [("lateral_speed", torch.float32, ()), ("yaw_rate", torch.float32, ())]


class DynFields(ctypes.Structure):
    """The ctypes mirror of the .cu's ``DynFields``: the device pointers of
    ``DYN_FIELDS`` in and out, then ``dynamics.kernel_constants(dt)``."""

    _fields_ = [
        ("lateral_speed", ctypes.c_void_p), ("yaw_rate", ctypes.c_void_p),
        ("lateral_speed_out", ctypes.c_void_p), ("yaw_rate_out", ctypes.c_void_p),
        ("dt_half", ctypes.c_float), ("dt_sixth", ctypes.c_float),
        ("damp", ctypes.c_float), ("inv_inertia", ctypes.c_float),
    ]


def _resolve(fields, R: int):
    return [(n, d, tuple(R if x == "R" else x for x in t)) for n, d, t in fields]


def kernel_params(spec: GeneralSpec, V: int, R: int, frames: int,
                  raw: bool = False, linear: bool = True, sized: bool = False) -> GenParams:
    """The kernel's parameter block without its device pointers (the
    wrapper sets ``speed_grid`` and ``poly`` to its tables in the kSized
    layout; the fixed one carries the speed grid in ``target_speeds``).  Raw
    controls take no target speeds: ``n_speeds = 0`` and ``raw = 1``;
    ``linear`` picks the Linear rows' instantiation; ``sized``: the kSized
    layout whatever the scene (the global library's, ``scene_tables``).  A
    scene outside the kernels' limits raises: ``make`` refuses its env
    (``general_unported``)."""
    at, p, geo = spec.action_type, spec.p, spec.geo
    ts = np.zeros(0, np.float32) if raw else np.asarray(at.target_speeds, np.float32)
    # the grid as controller.speed_to_index takes it
    span = None if raw else np.asarray(at.target_speeds)
    S, K, sized = scene_tables(spec, R, raw, sized)
    bad = kernel_limits(V, geo.num_lanes, R, geo.succ_edge_base.shape[1],
                        None if raw else len(ts),
                        geo.conn_lanes.shape[1] if spec.connected else None,
                        spec.period is not None, geo.poly is not None)
    if bad:
        raise ValueError(f"outside the general kernels' limits: {', '.join(bad)}")
    bank = geo.poly
    out = GenParams(
        L=geo.num_lanes, M=spec.max_edge_lanes, V=V, R=R, frames=frames,
        n_speeds=len(ts), longitudinal=int(at.longitudinal),
        lateral=int(at.lateral), period=spec.period or 0, raw=int(raw),
        dt=spec.dt, acc_max=p.acc_max,
        comfort_acc_max=p.comfort_acc_max, distance_wanted=p.distance_wanted,
        time_wanted=p.time_wanted, inv_two_sqrt_ab=p.inv_two_sqrt_ab,
        politeness=p.politeness, lane_change_delay=p.lane_change_delay,
        kp_a=controller.KP_A, kp_heading=controller.KP_HEADING,
        kp_lateral=controller.KP_LATERAL, tau_pursuit=controller.TAU_PURSUIT,
        # speed_to_index's division by the grid's span, a Python scalar:
        # torch on CUDA multiplies by its reciprocal, taken in double and
        # rounded to float32
        ts_lo=float(ts[0]) if len(ts) else 0.0,
        inv_ts_range=(float(np.float32(1.0 / (span[-1] - span[0]))) if len(ts) else 0.0),
        linear=int(linear), S=S, K=K,
        poly=PolyBankFields(S=0 if bank is None else bank.pos.shape[1],
                            C=0 if bank is None else bank.cp_s.shape[1]),
    )
    if not sized:  # the fixed layout's grid, in the block
        for i, x in enumerate(ts):
            out.target_speeds[i] = float(x)
    return out


def scene_tables(spec: GeneralSpec, R: int, raw: bool,
                 sized: bool = False) -> tuple[int, int, bool]:
    """``launch_tables`` of ``spec``'s scene at R route slots, under raw
    controls or meta-actions: (successor columns, candidate columns,
    sized); with ``sized`` the scene's own columns in the kSized layout
    whatever they are (the global library has only that layout)."""
    geo = spec.geo
    S = geo.succ_edge_base.shape[1]
    K = geo.conn_lanes.shape[1] if spec.connected else None
    if sized:
        return S, K or 0, True
    return launch_tables(S, K, geo.poly is not None, R,
                         None if raw else len(spec.action_type.target_speeds))


def lane_order(geo: LaneGeometry, device) -> torch.Tensor:
    """The (L,) int32 lanes grouped by kind (circular, sine, straight, poly,
    each in lane order), the order the projection takes them in: what the
    shared layouts' thread 0 builds in shared memory, built once here for
    the global layout."""
    group = {lane_ops.CIRCULAR: 0, lane_ops.SINE: 1, lane_ops.POLY: 3}
    kinds = geo.kind.cpu().tolist()
    order = sorted(range(len(kinds)), key=lambda l: group.get(kinds[l], 2))
    return torch.tensor(order, dtype=torch.int32, device=device)


def speed_table(spec: GeneralSpec, raw: bool, device) -> tuple[torch.Tensor, ...]:
    """The kSized kernels' device copy of the target-speed grid, () under
    raw controls."""
    if raw:
        return ()
    return (torch.tensor(np.asarray(spec.action_type.target_speeds, np.float32),
                         device=device),)


class GeneralFramesKernel(KernelWrapper):
    """Wrapper of the ``general_frames`` CUDA kernels: K4, or with
    ``regulated=True`` K5 (the same frame plus the right-of-way pass, a
    second entry point of the same library); with ``connected=True`` their
    ``kConnected`` instantiations (entries ``general_frames_connected`` and
    ``general_frames_regulated_connected``), which search the connected
    lanes from the lane tables' candidates (``conn_tables``) and take only a
    connected spec, as the others take only a spec without it; with
    ``dynamical=True`` their ``kDynamical`` instantiations (entries
    ``general_frames_dynamical`` and ``general_frames_regulated_dynamical``),
    which integrate the egos by the tire-slip model and read and write
    ``lateral_speed`` and ``yaw_rate`` too (``DynFields``), for a dynamical
    spec only; with both flags the instantiations that do both (entries
    ``general_frames_connected_dynamical`` and
    ``general_frames_regulated_connected_dynamical``: the candidate tables,
    then the parameters, then ``DynFields``).  With ``wide=True`` the same
    entry of the wide library (``csrc/general_frames_wide.cu``): scenes of
    ``NARROW_SLOTS`` + 1 to ``WIDE_SLOTS`` slots, one env a block; with
    ``cluster=True`` that of the cluster library
    (``csrc/general_frames_cluster.cu``): scenes of up to ``MAX_SLOTS``
    slots, one env a cluster of ceil(V / 128) blocks, a launch that no
    cluster of that size fits refused with its CUDA error; with
    ``glob=True`` that of the global library
    (``csrc/general_frames_global.cu``): scenes of up to ``GLOBAL_SLOTS``
    slots and any lanes, one env a cluster of ceil(V / G) blocks of G =
    ``global_threads(V)`` threads, its arrays in a slab of
    ``global_words`` floats an env that each call takes from torch's
    allocator as it takes the outputs (a captured launch from the graph's
    pool), the lanes' order by kind a table of the wrapper's
    (``lane_order``), the kSized instantiations alone; the others take
    at most ``NARROW_SLOTS``.

    Called on CUDA tensors it launches its kernel once for all frames of
    the policy step, the ego meta-action applied inside on frame 0, and adds
    one to ``launches``; on CPU tensors it runs ``frames_general_plain``.
    With ``raw`` the egos keep the controls stored on them before the call
    (``store_raw_controls``) and there are no slot actions to read.
    K5 takes the (B,) int32 frame counters ``steps0`` of the envs at the
    step's start and passes the kernel only their tick phase
    ``steps0 % period``, as the JAX wrapper does.  ``linear`` as for K1
    (``ops/straight_frames.py``): the Linear rows' instantiation, or the
    IDM code, which traps on a Linear row.  A scene outside the tables'
    fixed layout (poly lanes, more than ``FIXED_SUCC`` successor edges,
    ``FIXED_CONN`` candidate lanes a lane, ``FIXED_ROUTE`` route slots or
    ``FIXED_SPEEDS`` target speeds: ``launch_tables``) launches the ``kSized`` instantiation of the same
    entry in the ``source + "_sized"`` library instead (the tables' strides
    read at run time, the poly bank in global memory; Linear rows possible
    whatever ``linear`` says); the others launch on tables padded to the
    fixed layout.
    """

    #: the fields the kernel reads, in the order of its pointer block
    in_fields = _IN_FIELDS
    #: the ctypes mirror of the library's parameter block
    params_type = GenParams

    def __init__(self, regulated: bool = False, connected: bool = False,
                 dynamical: bool = False, wide: bool = False, cluster: bool = False,
                 glob: bool = False):
        super().__init__()
        if wide + cluster + glob > 1:
            raise ValueError("a wrapper launches the wide, the cluster or the global library, "
                             "one of them")
        self.regulated, self.connected, self.dynamical = regulated, connected, dynamical
        self.wide, self.cluster, self.glob = wide, cluster, glob
        self.source = ("general_frames_global" if glob else "general_frames_cluster" if cluster
                       else "general_frames_wide" if wide else "general_frames")
        self.max_slots = (GLOBAL_SLOTS if glob else MAX_SLOTS if cluster
                          else WIDE_SLOTS if wide else NARROW_SLOTS)
        self.entry = ("general_frames" + "_regulated" * regulated
                      + "_connected" * connected + "_dynamical" * dynamical)
        self._tables: dict = {}
        self._sized_lib = None

    def _library(self, sized: bool = False):
        """The fixed layout's library (``source``), or with ``sized`` the
        ``kSized`` one (``source`` + "_sized"), each built and bound at its
        first use; the global library, whatever ``sized`` says."""
        if not sized or self.glob:
            return super()._library()
        if self._sized_lib is None:
            from highwayenv_tpu_torch.ops import _build

            lib = _build.load_kernel_library(self.source + "_sized")
            self._bind(lib)
            self._sized_lib = lib
        return self._sized_lib

    def _bind(self, lib):
        sizes = [("general_params_bytes", "GenParams", self.params_type)]
        if self.dynamical:
            sizes.append(("general_dyn_bytes", "DynFields", DynFields))
        for fn_name, what, mirror in sizes:
            size = getattr(lib, fn_name, None)
            if size is not None and size() != ctypes.sizeof(mirror):
                raise RuntimeError(f"{what} is {size()} bytes in the library, "
                                   f"{ctypes.sizeof(mirror)} in its mirror")
        fn = getattr(lib, self.entry)
        fn.argtypes = (
            [ctypes.c_void_p] * (3 + self.regulated + 2 * self.connected)
            + [ctypes.POINTER(self.params_type), ctypes.c_int, ctypes.c_void_p]
            + [ctypes.POINTER(DynFields)] * self.dynamical
        )
        fn.restype = ctypes.c_int

    def cluster_fit(self, ranks: int, L: int, R: int, S: int = FIXED_SUCC,
                    K: int | None = None, linear: bool = True,
                    device=None, threads: int = WIDE_SLOTS) -> tuple[int, int]:
        """(clusters, bytes): how many clusters of ``ranks`` blocks of
        ``threads`` threads (128 in the cluster library; 128, 256 or
        ``GLOBAL_THREADS`` in the global one) of this cluster or global
        instantiation the card can hold at once
        (``cudaOccupancyMaxActiveClusters``, the launch's own question; 0:
        none fits), each block asking the shared memory a launch at ``L``
        lanes, ``R`` route slots, ``S`` successor edges and ``K`` candidates
        a lane (connected; default 1 + 2 S) asks (the tables as
        ``launch_tables`` lays them out, the ``kSized`` instantiation where
        it does; none in the global library), which the library computes as
        the launch does and returns beside.  Raises on a CUDA error."""
        if not (self.cluster or self.glob):
            raise ValueError("cluster_fit asks the cluster library's kernels, or the global "
                             "library's")
        most = -(-MAX_SLOTS // WIDE_SLOTS)
        if not 1 <= ranks <= most:
            raise ValueError(f"cluster_fit: {ranks} cluster blocks outside 1 to {most}")
        allowed = (WIDE_SLOTS, 2 * WIDE_SLOTS, GLOBAL_THREADS) if self.glob else (WIDE_SLOTS,)
        if threads not in allowed:
            raise ValueError(f"cluster_fit: blocks of {threads} threads, not of {allowed}")
        for n, what in ((L, "lanes"), (R, "route slots")):
            if n < 1:
                raise ValueError(f"cluster_fit: {n} {what} < 1")
        S, K, sized = launch_tables(S, (1 + 2 * S if K is None else K) if self.connected
                                    else None, False, R)
        if self.glob:
            sized = True
        lib = self._library(sized)
        fn = lib.general_cluster_fit
        fn.argtypes = [ctypes.c_int] * 10 + [ctypes.POINTER(ctypes.c_int)] * 2
        fn.restype = ctypes.c_int
        smem, clusters = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
            err = fn(int(self.regulated), int(self.connected), int(self.dynamical),
                     int(linear), ranks, threads, L, R, S, K, ctypes.byref(smem),
                     ctypes.byref(clusters))
        if err != 0:
            raise RuntimeError(f"general_cluster_fit({ranks} blocks of {threads} threads, "
                               f"L={L}, R={R}): CUDA error {err}")
        return clusters.value, smem.value

    def global_words(self, L: int, V: int, R: int) -> int:
        """The words of one env's slab that the global library's launch
        takes at the scene (``general_global_words``), for a check of
        ``global_words``."""
        if not self.glob:
            raise ValueError("global_words asks the global library")
        fn = self._library().general_global_words
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_longlong
        return int(fn(int(self.regulated), L, V, R))

    def smem_bytes(self, L: int, V: int, R: int, S: int, K: int = 0,
                   sized: bool = False) -> int:
        """The shared memory a block of this wrapper's fixed or ``sized``
        library's launch asks at the scene (``general_smem_bytes``, the
        launch's own count), for a check of ``launch_smem``."""
        fn = self._library(sized).general_smem_bytes
        fn.argtypes = [ctypes.c_int] * 7
        fn.restype = ctypes.c_longlong
        return int(fn(int(self.regulated), int(self.connected), L, V, R, S, K))

    def _device_tables(self, spec: GeneralSpec, raw: bool, dev, S: int, K: int,
                       sized: bool):
        """(lane tables, poly bank, speed grid) on ``dev`` in the layout
        (S, K, sized) of ``launch_tables``: the lane tables (and the
        candidate tables of a connected instantiation) as the launch's
        pointer arguments, built once per network, action type, layout and
        device (before a graph captures the launch)."""
        key = (id(spec.geo), id(spec.action_type), raw, str(dev), S, K, sized)
        if key not in self._tables:
            conn = conn_tables(spec.geo, dev, K) if self.connected else ()
            self._tables[key] = (spec.geo, spec.action_type, (
                lane_tables(spec.geo, dev, S, sized) + conn,
                poly_tables(spec.geo, dev) if sized else (),
                speed_table(spec, raw, dev) if sized else (),
                lane_order(spec.geo, dev) if self.glob else None))
        return self._tables[key][2]

    def _params(self, spec: GeneralSpec, V: int, R: int, frames: int, raw: bool,
                linear: bool, dev):
        """(table pointers, parameter block, the global layout's lanes'
        order or None) of a launch on ``dev``."""
        lanes, poly, speeds, order = self._device_tables(
            spec, raw, dev, *scene_tables(spec, R, raw, self.glob))
        params = kernel_params(spec, V, R, frames, raw, linear, self.glob)
        if speeds:
            params.speed_grid = speeds[0].data_ptr()
        if poly:
            for name, t in zip(("pos", "normal", "n", "cp", "cp_n"), poly):
                setattr(params.poly, name, t.data_ptr())
        return [t.data_ptr() for t in lanes], params, order

    def __call__(self, veh: VehicleState, spec: GeneralSpec,
                 slot_actions: torch.Tensor | None, frames: int,
                 steps0: torch.Tensor | None = None, raw: bool = False,
                 linear: bool = True) -> VehicleState:
        if self.regulated != (steps0 is not None) or self.regulated != (spec.period is not None):
            raise ValueError("steps0 goes with K5 on a regulated road, and only there")
        if self.connected != spec.connected:
            raise ValueError("the connected instantiations take a connected spec, and only "
                             "they do")
        if self.dynamical != spec.dynamical:
            raise ValueError("the dynamical instantiations take a dynamical spec, and only "
                             "they do")
        if not on_cuda(veh.speed):
            self.check_linear(veh, linear)
            return frames_general_plain(veh, spec, slot_actions, frames, steps0, raw)
        _check_raw(slot_actions, raw)
        B, V = veh.kind.shape
        if V > self.max_slots:
            raise ValueError(f"{V} slots > {self.max_slots}: frames_kernel_for picks the "
                             "instantiation of a scene")
        R = veh.route_base.shape[-1]
        dev = veh.speed.device
        action_ptr = None
        if not raw:
            if (slot_actions.shape != (B, V) or slot_actions.dtype != torch.int32
                    or slot_actions.device != dev or not slot_actions.is_contiguous()):
                raise ValueError(f"slot_actions: expected contiguous int32 ({B}, {V}) on {dev}")
            action_ptr = slot_actions.data_ptr()
        ins = checked_fields(veh, _resolve(self.in_fields, R), B, V, dev)
        outs = empty_fields(_resolve(OUT_FIELDS, R), B, V, dev)
        tables, params, order = self._params(spec, V, R, frames, raw, linear, dev)
        # the global layout's slab and lanes' order, past the outputs
        extra = []
        if self.glob:
            slab = torch.empty(B * global_words(spec.geo.num_lanes, V, R, self.regulated),
                               dtype=torch.float32, device=dev)
            extra = [slab.data_ptr(), order.data_ptr()]
        ptrs = (ctypes.c_void_p * (len(ins) + 1 + len(outs) + len(extra)))(
            *[t.data_ptr() for t in ins], action_ptr, *[t.data_ptr() for t in outs], *extra
        )
        args = [ptrs]
        if self.regulated:
            if steps0.shape != (B,) or steps0.dtype != torch.int32 or steps0.device != dev:
                raise ValueError(f"steps0: expected int32 ({B},) on {dev}")
            phase = torch.remainder(steps0, spec.period).contiguous()
            reg_ins = checked_fields(veh, REG_FIELDS, B, V, dev)
            reg_outs = empty_fields(REG_FIELDS, B, V, dev)
            reg = reg_ins + [phase] + reg_outs
            args.append((ctypes.c_void_p * len(reg))(*[t.data_ptr() for t in reg]))
        dyn = []
        if self.dynamical:
            dyn_ins = checked_fields(veh, DYN_FIELDS, B, V, dev)
            dyn_outs = empty_fields(DYN_FIELDS, B, V, dev)
            dyn = [ctypes.byref(DynFields(
                *[t.data_ptr() for t in dyn_ins + dyn_outs],
                *dynamics.kernel_constants(spec.dt),
            ))]
        lib = self._library(scene_tables(spec, R, raw, self.glob)[2])
        with torch.cuda.device(dev):
            err = getattr(lib, self.entry)(
                *args, *tables, ctypes.byref(params),
                B, torch.cuda.current_stream(dev).cuda_stream, *dyn,
            )
        self._launched(self.entry, err)
        out = with_fields(veh, OUT_FIELDS, outs)
        if self.regulated:
            out = with_fields(out, REG_FIELDS, reg_outs)
        return with_fields(out, DYN_FIELDS, dyn_outs) if self.dynamical else out


#: the wrapper instances the env path launches through: K4, and K5 for
#: regulated roads, their connected instantiations for the envs with the
#: connected-lane search, their dynamical ones for a dynamical action and
#: their connected dynamical ones for both, the wide twin of each for
#: scenes of more than NARROW_SLOTS slots, the cluster twin for more than
#: WIDE_SLOTS and the global twin for the scenes no layout of shared memory
#: holds (``layout_for``), each counting its own launches
frames_general_kernel = GeneralFramesKernel()
frames_regulated_kernel = GeneralFramesKernel(regulated=True)
frames_general_connected_kernel = GeneralFramesKernel(connected=True)
frames_regulated_connected_kernel = GeneralFramesKernel(regulated=True, connected=True)
frames_general_dynamical_kernel = GeneralFramesKernel(dynamical=True)
frames_regulated_dynamical_kernel = GeneralFramesKernel(regulated=True, dynamical=True)
frames_general_connected_dynamical_kernel = GeneralFramesKernel(connected=True, dynamical=True)
frames_regulated_connected_dynamical_kernel = GeneralFramesKernel(regulated=True,
                                                                  connected=True, dynamical=True)
frames_general_wide_kernel = GeneralFramesKernel(wide=True)
frames_regulated_wide_kernel = GeneralFramesKernel(regulated=True, wide=True)
frames_general_connected_wide_kernel = GeneralFramesKernel(connected=True, wide=True)
frames_regulated_connected_wide_kernel = GeneralFramesKernel(regulated=True, connected=True,
                                                             wide=True)
frames_general_dynamical_wide_kernel = GeneralFramesKernel(dynamical=True, wide=True)
frames_regulated_dynamical_wide_kernel = GeneralFramesKernel(regulated=True, dynamical=True,
                                                             wide=True)
frames_general_connected_dynamical_wide_kernel = GeneralFramesKernel(
    connected=True, dynamical=True, wide=True)
frames_regulated_connected_dynamical_wide_kernel = GeneralFramesKernel(
    regulated=True, connected=True, dynamical=True, wide=True)
frames_general_cluster_kernel = GeneralFramesKernel(cluster=True)
frames_regulated_cluster_kernel = GeneralFramesKernel(regulated=True, cluster=True)
frames_general_connected_cluster_kernel = GeneralFramesKernel(connected=True, cluster=True)
frames_regulated_connected_cluster_kernel = GeneralFramesKernel(regulated=True, connected=True,
                                                                cluster=True)
frames_general_dynamical_cluster_kernel = GeneralFramesKernel(dynamical=True, cluster=True)
frames_regulated_dynamical_cluster_kernel = GeneralFramesKernel(regulated=True, dynamical=True,
                                                                cluster=True)
frames_general_connected_dynamical_cluster_kernel = GeneralFramesKernel(
    connected=True, dynamical=True, cluster=True)
frames_regulated_connected_dynamical_cluster_kernel = GeneralFramesKernel(
    regulated=True, connected=True, dynamical=True, cluster=True)
frames_general_global_kernel = GeneralFramesKernel(glob=True)
frames_regulated_global_kernel = GeneralFramesKernel(regulated=True, glob=True)
frames_general_connected_global_kernel = GeneralFramesKernel(connected=True, glob=True)
frames_regulated_connected_global_kernel = GeneralFramesKernel(regulated=True, connected=True,
                                                               glob=True)
frames_general_dynamical_global_kernel = GeneralFramesKernel(dynamical=True, glob=True)
frames_regulated_dynamical_global_kernel = GeneralFramesKernel(regulated=True, dynamical=True,
                                                               glob=True)
frames_general_connected_dynamical_global_kernel = GeneralFramesKernel(
    connected=True, dynamical=True, glob=True)
frames_regulated_connected_dynamical_global_kernel = GeneralFramesKernel(
    regulated=True, connected=True, dynamical=True, glob=True)


def store_raw_controls(env, veh: VehicleState, slot_actions: torch.Tensor):
    """``(veh, slot_actions, raw)`` for the frames: under an action type
    that stores raw controls (ContinuousAction, DiscreteAction) its
    commands stored on the egos in torch, as the JAX wrapper does, and no
    slot actions left; else ``veh`` and the meta-actions unchanged."""
    at = env.action_type
    if not at.stores_raw_controls:
        return veh, slot_actions, False
    return at.apply(env.geo, veh, veh.kind == KIND_EGO, slot_actions), None, True


def simulate_general(env, veh: VehicleState, slot_actions: torch.Tensor,
                     frames: int, steps0: torch.Tensor | None = None,
                     linear: bool | None = None) -> VehicleState:
    """Policy-step simulation on the general path: all ``frames`` frames and
    the ego meta-action (inside, on frame 0, after follow_road) through
    ``frames_general_kernel``, or with the envs' frame counters ``steps0``
    (a regulated road) through ``frames_regulated_kernel``; under the
    connected-lane search through their connected instantiations, under a
    dynamical action through their dynamical ones, over ``NARROW_SLOTS``
    slots through the wide twins, over ``WIDE_SLOTS`` through the cluster
    twins and past the layouts of shared memory through the global twins
    (``frames_kernel_for``).
    Raw controls are stored first (``store_raw_controls``) and the launch
    reads none.  ``linear`` (default ``env.linear_rows``): Linear rows
    possible."""
    veh, slot_actions, raw = store_raw_controls(env, veh, slot_actions)
    linear = env.linear_rows if linear is None else linear
    kernel = frames_kernel_for(env._general, steps0 is not None, veh.kind.shape[1])
    return kernel(veh, env._general, slot_actions, frames, steps0, raw, linear)


def scene_layout(spec: GeneralSpec, regulated: bool, slots: int) -> str:
    """``layout_for`` of ``spec``'s scene at ``slots`` slots (its lanes,
    route slots, successor edges, candidates under the connected-lane
    search, target speeds or raw controls and poly lanes), on a regulated
    road or not."""
    geo, at = spec.geo, spec.action_type
    return layout_for(slots, geo.num_lanes, spec.route_slots, geo.succ_edge_base.shape[1],
                      None if at.stores_raw_controls else len(at.target_speeds),
                      geo.conn_lanes.shape[1] if spec.connected else None, regulated,
                      geo.poly is not None)


def frames_kernel_for(spec: GeneralSpec, regulated: bool,
                      slots: int = 1) -> GeneralFramesKernel:
    """The wrapper instance of ``spec``'s instantiation for a scene of
    ``slots`` slots: K4, or K5 on a regulated road, connected, dynamical or
    both as the spec is, its wide twin over ``NARROW_SLOTS`` slots, its
    cluster twin over ``WIDE_SLOTS`` and its global twin where no layout of
    shared memory holds the scene (``scene_layout``).  Looked up by name
    when called, so that a stand-in put in the module's place is taken."""
    layout = scene_layout(spec, regulated, slots)
    law = "_connected" * spec.connected + "_dynamical" * spec.dynamical
    road = "regulated" if regulated else "general"
    return globals()[f"frames_{road}{law}{'_' * bool(layout)}{layout}_kernel"]


def simulate_general_reference(env, veh: VehicleState, slot_actions: torch.Tensor,
                               frames: int, steps0: torch.Tensor | None = None
                               ) -> VehicleState:
    """The same step through ``frames_general_plain`` on any device."""
    veh, slot_actions, raw = store_raw_controls(env, veh, slot_actions)
    return frames_general_plain(veh, env._general, slot_actions, frames, steps0, raw)
