"""All frames of a policy step on a straight network: CUDA kernel + plain torch.

Counterpart of ``highwayenv_tpu/ops/straight_pallas_bm.py`` in dense mode
(``build_pallas_frame(sorted_mode=False)``, ``pallas_simulate_bm``).  One
frame is the straight-road specialization of the reference
``road.act(); road.step(dt)``:

  1. s / lateral projection on the road axis;
  2. front / rear neighbours on the own lane and the lanes +-1
     (front keeps the LAST column among equal keys, rear the FIRST;
     PARITY #3);
  3. IDM acceleration, MOBIL lane change with its timer, abort-on-conflict;
  4. steering / speed P-cascade, dual-lane IDM while changing lanes;
  5. bicycle integration and lane re-localization;
  6. swept-SAT collisions with last-write impacts (PARITY #2).

Every phase reads the frame-start state.  Phases 1 and 3-5 (``project``,
``drive``) are shared with the s-sorted frame of ``ops/straight_sorted.py``,
which replaces the two pair searches 2 and 6 by banded ones, as
``csrc/straight_common.cuh`` shares them between the two CUDA kernels.
``frames_kernel`` runs all
``frames`` frames of a policy step in one launch of
``csrc/straight_frames.cu`` for CUDA tensors, and ``frames_plain`` (batched
torch over (B, V, V) pair tensors) for CPU tensors; the two compute the
same float32 arithmetic in the same order.  The kernel's lean
instantiations cover the scenes the straight highway envs spawn: vehicles
only, IDM and Linear NPCs.  Its objects instantiations (``objects``, the
env path's ``not env.lean``: the TPU kernel's non-``lean`` branch,
``_frame_body`` ``:567-579``, ``:591-595``, ``:993-1019``,
``:1066-1102``) also take obstacle and landmark rows: a landmark occupies
no lane, a pair counts for crashes and impacts only where both members are
solid, an obstacle partner gives the full translation and an obstacle
writes no impact of its own, and a non-solid slot that intersects a
partner is marked ``hit`` (``ops/collision.py``, the plain rule, which
``frames_plain`` always runs).  A lean call on a state with such a row
raises on CPU tensors (``check_objects``) and traps on the card.  A
Linear row (``KIND_LINEAR``: the
Linear-family presets, or ``envs/preprocessors.change_vehicles``) takes
the same MOBIL decisions with LinearVehicle's acceleration wherever it
decides, and LinearVehicle's steering; the law goes by each row's kind, as
the JAX package's XLA frame decides it.  The kernels run their Linear
rows' instantiation where the caller passes ``linear`` (the env path: the
env's ``linear_rows``), else their IDM code alone, which stops on a Linear
row with an error.

Two layouts (``straight_layout_for``): the block layout, one env a thread
block and one thread a slot with its rows in shared memory, for up to
``MAX_SLOTS`` = 1024 slots whose block asks at most ``SMEM_LIMIT``
(``launch_smem``); and past it the global layout
(``csrc/straight_frames_global.cu``, ``frames_global_kernel``), one env a
thread-block cluster of up to 16 blocks with its rows in a slab of global
memory, up to ``STRAIGHT_GLOBAL_SLOTS`` = 8192 slots, the only limit
``make`` names (``kernel_limits``).  ``frames_kernel_for(V, L)`` picks
the wrapper of a scene's layout; a block wrapper refuses a scene of the
global layout.

The ego meta-action is applied once per policy step in torch before the
frames (``simulate_bm``), as ``pallas_simulate_bm`` does.  Under a
ContinuousAction (``raw=True``, the JAX kernel's ``raw_controls`` branch)
that stores the ego's steering and acceleration, and the frames keep them:
the ego takes no P-cascade.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from highwayenv_tpu_torch.ops import collision
from highwayenv_tpu_torch.ops.straight_fast import StraightGeo
from highwayenv_tpu_torch.vehicle import controller, kinematics
from highwayenv_tpu_torch.vehicle.behavior import (
    IDMParams,
    front_pick,
    idm_acceleration,
    is_driven,
    rear_pick,
)
from highwayenv_tpu_torch.vehicle.state import (
    KIND_EGO,
    KIND_LANDMARK,
    KIND_LINEAR,
    KIND_OBSTACLE,
    VEHICLE_LENGTH,
    VehicleState,
)

#: most slots one thread block can hold (one thread per slot): the block layout
MAX_SLOTS = 1024
#: the shared memory a block may ask on an H100 (its opt-in maximum: 227 KB)
SMEM_LIMIT = 232448
#: words of a slot's rows in shared memory (``ROW_WORDS`` in straight_common.cuh)
ROW_WORDS = 22
#: most slots of the global layout (``csrc/straight_global.cuh``): one env a
#: thread-block cluster of up to 16 blocks of up to ``GLOBAL_THREADS`` threads,
#: its rows in a slab of global memory; the general path's cap too
STRAIGHT_GLOBAL_SLOTS = 8192
GLOBAL_THREADS = 512


def lane_members(s, lat0, occupiable, q_off, tol: float):
    """(B, K, V, V) mask: column c is on the lane of query (k, q), i.e.
    ``|lat0_c - q_off| <= tol``, is occupiable, and is not q itself."""
    V = s.shape[-1]
    cols = torch.arange(V, device=s.device)
    return (
        ((lat0[:, None, None, :] - q_off[..., None]).abs() <= tol)
        & occupiable[:, None, None, :]
        & (cols[:, None] != cols[None, :])
    )


def neighbours(s, lat0, occupiable, q_off, tol: float):
    """Front / rear neighbour slots of every query (B, K, V), -1 = none.

    s, lat0, occupiable: (B, V) per slot; q_off: (B, K, V) lateral offset
    of each query's lane.  A column is on the query lane when
    ``|lat0_c - q_off| <= tol``.  Front = smallest s_c >= s_q, keeping the
    LAST column among equal keys; rear = largest s_c < s_q, keeping the
    FIRST (the reference's ``<=`` / strict ``>`` scans, PARITY #3).  A slot
    is never its own neighbour.
    """
    member = lane_members(s, lat0, occupiable, q_off, tol)
    s_q = s[:, None, :, None]
    s_c = s[:, None, None, :]
    return front_pick(member & (s_q <= s_c), s_c), rear_pick(member & (s_c < s_q), s_c)


def mobil_gates(veh: VehicleState, p: IDMParams):
    """Frame-start (idm, mid_change, deciding) masks: uncrashed IDM and
    Linear rows, rows changing lanes, and rows taking a MOBIL decision this
    frame."""
    idm = is_driven(veh)
    mid_change = veh.lane != veh.target_lane
    tick = veh.timer > p.lane_change_delay
    deciding = idm & ~mid_change & tick & veh.enable_lane_change
    return idm, mid_change, deciding


def project(veh: VehicleState, fs: StraightGeo):
    """Frame-start projection on the road axis: s, lateral offset, lane
    occupancy (B, V), and the query lanes own / -1 / +1 (clamped) with their
    offsets (B, 3, V)."""
    off = torch.as_tensor(fs.offsets, device=veh.speed.device)
    L = off.shape[0]
    ox, oy = float(fs.origin[0]), float(fs.origin[1])
    ux, uy = float(fs.u[0]), float(fs.u[1])
    nx, ny = float(fs.n[0]), float(fs.n[1])
    px, py = veh.pos[..., 0], veh.pos[..., 1]
    s = (px - ox) * ux + (py - oy) * uy
    lat0 = (px - ox) * nx + (py - oy) * ny
    occupiable = (
        (-VEHICLE_LENGTH <= s) & (s < fs.length + VEHICLE_LENGTH)
        & veh.active & (veh.kind != KIND_LANDMARK)
    )
    lane = veh.lane.long()
    q_lanes = torch.stack(
        [lane, (lane - 1).clamp(0, L - 1), (lane + 1).clamp(0, L - 1)], dim=1
    )  # (B, 3, V): own lane, lane - 1, lane + 1
    q_off = off[q_lanes.clamp(0, L - 1)]
    return s, lat0, occupiable, q_lanes, q_off


def drive(
    veh: VehicleState, fs: StraightGeo, p: IDMParams, dt: float,
    s, lat0, q_lanes, q_off, front_idx, rear_idx, raw: bool = False,
) -> VehicleState:
    """The frame between the neighbour search and the collision pass: MOBIL
    with its timer, abort-on-conflict, the P-cascade controls with dual-lane
    IDM, bicycle integration and re-localization.  ``front_idx`` /
    ``rear_idx`` (B, 3, V) are the neighbours of the own lane and lanes
    -1 / +1, -1 = none (``csrc/straight_common.cuh::drive``).  With ``raw``
    the ego keeps its stored steering and acceleration.  A Linear row's
    accelerations, its own and its neighbours' in its MOBIL decision, and
    its steering are LinearVehicle's."""
    V = veh.kind.shape[1]
    dev = veh.speed.device
    off = torch.as_tensor(fs.offsets, device=dev)
    L = off.shape[0]
    ox, oy = float(fs.origin[0]), float(fs.origin[1])
    nx, ny = float(fs.n[0]), float(fs.n[1])
    eye = torch.eye(V, dtype=torch.bool, device=dev)

    kind = veh.kind
    is_vehicle = veh.is_vehicle
    lane = veh.lane.long()
    idm, mid_change, deciding = mobil_gates(veh, p)
    cos_h, sin_h = torch.cos(veh.heading), torch.sin(veh.heading)
    vx, vy = veh.speed * cos_h, veh.speed * sin_h
    table = {
        "speed": veh.speed, "target_speed": veh.target_speed, "s": s,
        "vx": vx, "vy": vy, "cos": cos_h, "sin": sin_h,
    }

    def fetch(idx):
        """Rows at ``idx`` (B, V), -1 = none: zero fields, no vehicle."""
        ex = idx >= 0
        g = idx.clamp(min=0)
        row = {
            k: torch.where(ex, torch.gather(v, 1, g), 0.0)
            for k, v in table.items()
        }
        row["ex"] = ex
        row["is_vehicle"] = ex & torch.gather(is_vehicle, 1, g)
        return row

    self_row = dict(table, ex=torch.ones_like(idm), is_vehicle=is_vehicle)
    fronts = [fetch(front_idx[:, k]) for k in range(3)]
    rears = [fetch(rear_idx[:, k]) for k in range(3)]

    linear = kind == KIND_LINEAR
    law = (linear, veh.accel_params)

    def accel(eg, fr):
        a = idm_acceleration(
            p, fs.speed_limit, veh.delta,
            eg["speed"], eg["target_speed"], eg["s"], eg["cos"], eg["sin"],
            fr["s"], fr["vx"], fr["vy"], fr["ex"], law, fr["speed"],
        )
        return torch.where(eg["ex"] & eg["is_vehicle"], a, 0.0)

    a_self = accel(self_row, fronts[0])
    a_of = accel(rears[0], self_row)
    a_of_pred = accel(rears[0], fronts[0])

    # --- MOBIL ------------------------------------------------------------ #
    new_timer = torch.where(deciding, 0.0, veh.timer)
    moving = veh.speed.abs() >= 1.0
    target = veh.target_lane
    for d, k in ((-1, 1), (1, 2)):
        exists = (lane + d >= 0) & (lane + d < L)
        a_nf = accel(rears[k], fronts[k])
        a_nf_pred = accel(rears[k], self_row)
        a_self_pred = accel(self_row, fronts[k])
        safe = a_nf_pred >= -veh.mobil_max_braking
        jerk = a_self_pred - a_self + p.politeness * (
            a_nf_pred - a_nf + a_of_pred - a_of
        )
        reachable = (
            ((lat0 - q_off[:, k]).abs() <= 2 * fs.width)
            & (0 <= s)
            & (s < fs.length + VEHICLE_LENGTH)
        )
        ok = (
            deciding & exists & reachable & moving & safe
            & (jerk >= veh.mobil_gain)
        )
        target = torch.where(ok, q_lanes[:, k].to(torch.int32), target)

    # abort-on-conflict: [b, i, j] = slot i deciding against slot j
    d_ij = s[:, None, :] - s[:, :, None]
    dv_ij = (vx[:, :, None] - vx[:, None, :]) * cos_h[:, :, None] + (
        vy[:, :, None] - vy[:, None, :]
    ) * sin_h[:, :, None]
    d_star_ij = (
        p.distance_wanted
        + veh.speed[:, :, None] * p.time_wanted
        + veh.speed[:, :, None] * dv_ij * p.inv_two_sqrt_ab
    )
    conflict = (
        ~eye
        & veh.is_controlled[:, None, :]
        & (veh.lane[:, None, :] != veh.target_lane[:, :, None])
        & (veh.target_lane[:, None, :] == veh.target_lane[:, :, None])
        & (0.0 < d_ij)
        & (d_ij < d_star_ij)
    )
    abort = idm & mid_change & conflict.any(dim=-1)
    target = torch.where(abort, veh.lane, target)

    # --- low-level controls ------------------------------------------------ #
    lat_t = lat0 - off[target.long().clamp(0, L - 1)]
    steer_pc = torch.where(linear, controller.linear_steering(
        fs.theta, lat_t, veh.heading, veh.speed, veh.length, veh.steer_params
    ), controller.steering_from_coords(
        fs.theta, lat_t, veh.heading, veh.speed, veh.length
    ))
    # dual-lane IDM while changing lanes: the target is within one lane of
    # the current one, so its front neighbour is one of the three queries
    d_t = target - veh.lane
    npt = {
        key: torch.where(
            d_t == 0, fronts[0][key],
            torch.where(d_t < 0, fronts[1][key], fronts[2][key]),
        )
        for key in ("s", "vx", "vy", "speed", "ex")
    }
    a_t = accel(self_row, npt)
    acc = torch.where(target != veh.lane, torch.minimum(a_self, a_t), a_self)
    acc = acc.clamp(-p.acc_max, p.acc_max)

    # the ego's P-cascade, unless it keeps its raw controls
    is_ego = (kind == KIND_EGO) & (not raw)
    new_steer = torch.where(is_ego | idm, steer_pc, veh.steering)
    new_accel = torch.where(
        is_ego,
        controller.speed_control(veh.target_speed, veh.speed),
        torch.where(idm, acc, veh.accel),
    )
    veh = veh.replace(
        target_lane=target, timer=new_timer, steering=new_steer, accel=new_accel
    )

    # --- integrate, re-localize on the nearest lane offset ------------------ #
    veh = kinematics.integrate(veh, dt)
    lat_new = (veh.pos[..., 0] - ox) * nx + (veh.pos[..., 1] - oy) * ny
    new_lane = (lat_new[..., None] - off).abs().argmin(dim=-1).to(torch.int32)
    return veh.replace(lane=torch.where(veh.is_vehicle, new_lane, veh.lane))


def _frame_plain(veh: VehicleState, fs: StraightGeo, p: IDMParams, dt: float,
                 raw: bool = False):
    """One dense frame on (B, V) fields; pair tensors are (B, [3,] V, V)."""
    s, lat0, occupiable, q_lanes, q_off = project(veh, fs)
    front_idx, rear_idx = neighbours(
        s, lat0, occupiable, q_off, fs.width / 2 + 1.0
    )  # (B, 3, V)
    veh = drive(veh, fs, p, dt, s, lat0, q_lanes, q_off, front_idx, rear_idx, raw)
    return collision.handle_collisions(veh, dt)


def frames_plain(
    veh: VehicleState, fs: StraightGeo, p: IDMParams, dt: float, frames: int,
    raw: bool = False,
) -> VehicleState:
    """``frames`` frames in plain batched torch (the kernel's reference);
    ``raw``: the ego keeps its stored controls."""
    for _ in range(frames):
        veh = _frame_plain(veh, fs, p, dt, raw)
    return veh


class _Geo(ctypes.Structure):
    _fields_ = [
        ("ox", ctypes.c_float), ("oy", ctypes.c_float),
        ("ux", ctypes.c_float), ("uy", ctypes.c_float),
        ("nx", ctypes.c_float), ("ny", ctypes.c_float),
        ("theta", ctypes.c_float),
        ("in_range_hi", ctypes.c_float),
        ("member_tol", ctypes.c_float),
        ("reach_lat", ctypes.c_float),
        ("speed_limit", ctypes.c_float),
        ("has_limit", ctypes.c_int),
        ("n_lanes", ctypes.c_int),
        ("offsets", ctypes.c_void_p),  # the device copy of the lane offsets
    ]


class _Params(ctypes.Structure):
    _fields_ = [
        ("dt", ctypes.c_float),
        ("acc_max", ctypes.c_float),
        ("comfort_acc_max", ctypes.c_float),
        ("distance_wanted", ctypes.c_float),
        ("time_wanted", ctypes.c_float),
        ("inv_two_sqrt_ab", ctypes.c_float),
        ("politeness", ctypes.c_float),
        ("lane_change_delay", ctypes.c_float),
        ("kp_a", ctypes.c_float),
        ("kp_heading", ctypes.c_float),
        ("kp_lateral", ctypes.c_float),
        ("raw", ctypes.c_int),
        ("linear", ctypes.c_int),
        ("objects", ctypes.c_int),
        # the objects instantiation's (B, V) hit field, in and out
        ("hit", ctypes.c_void_p),
        ("hit_out", ctypes.c_void_p),
    ]


_IN_FIELDS = [
    # (name, dtype, trailing shape)
    ("pos", torch.float32, (2,)), ("heading", torch.float32, ()),
    ("speed", torch.float32, ()), ("lane", torch.int32, ()),
    ("target_lane", torch.int32, ()), ("target_speed", torch.float32, ()),
    ("timer", torch.float32, ()), ("crashed", torch.bool, ()),
    ("impact_pending", torch.bool, ()), ("impact", torch.float32, (2,)),
    ("steering", torch.float32, ()), ("accel", torch.float32, ()),
    ("delta", torch.float32, ()), ("kind", torch.int32, ()),
    ("length", torch.float32, ()), ("width", torch.float32, ()),
    ("check_collisions", torch.bool, ()), ("collidable", torch.bool, ()),
    ("enable_lane_change", torch.bool, ()), ("mobil_gain", torch.float32, ()),
    ("mobil_max_braking", torch.float32, ()),
    # read on Linear rows only
    ("accel_params", torch.float32, (3,)), ("steer_params", torch.float32, (2,)),
]
_OUT_FIELDS = [
    ("pos", torch.float32, (2,)), ("heading", torch.float32, ()),
    ("speed", torch.float32, ()), ("lane", torch.int32, ()),
    ("target_lane", torch.int32, ()), ("timer", torch.float32, ()),
    ("crashed", torch.bool, ()), ("impact_pending", torch.bool, ()),
    ("impact", torch.float32, (2,)), ("steering", torch.float32, ()),
    ("accel", torch.float32, ()),
]
#: the field K1's objects instantiation reads and writes besides these
#: (through ``Params.hit`` / ``hit_out``)
_HIT = [("hit", torch.bool, ())]


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; any other device raises.
    A kernel wrapper launches its kernel on CUDA tensors and runs its plain
    version on CPU tensors."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cuda"


def checked_fields(state, fields, B: int, V: int, dev) -> list[torch.Tensor]:
    """The tensors of ``fields`` ((name, dtype, trailing shape) triples) in
    ``state``, each checked to be contiguous, of its dtype and (B, V) +
    trailing shape, on ``dev``: what a kernel takes as a raw pointer."""
    out = []
    for name, dtype, trail in fields:
        t = getattr(state, name)
        if t.device != dev or t.dtype != dtype or t.shape != (B, V) + trail:
            raise ValueError(
                f"{name}: expected {dtype} {(B, V) + trail} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        out.append(t)
    return out


def empty_fields(fields, B: int, V: int, dev) -> list[torch.Tensor]:
    return [torch.empty((B, V) + trail, dtype=dtype, device=dev)
            for _, dtype, trail in fields]


def with_fields(state: VehicleState, fields, tensors) -> VehicleState:
    """``state`` with the named ``fields`` replaced by ``tensors``."""
    return state.replace(**{name: t for (name, _, _), t in zip(fields, tensors)})


def launch_smem(V: int, L: int) -> tuple[int, int]:
    """The shared memory, in bytes, a block of K1 and of K3 asks at V slots
    and L lanes (``frames_smem`` in straight_common.cuh: the lane offsets,
    then per thread its rows and per warp its ballot words; each library's
    ``*_smem_bytes``, which chip_smoke.py holds this copy to)."""
    threads = -(-V // 32) * 32
    warps = threads // 32

    def smem(words, warp_words):
        return 4 * (((L + 3) & ~3) + words * threads + warp_words * warps)

    return (smem(ROW_WORDS + warps, 2 * L + 4),
            smem(ROW_WORDS + 2 + L + 1, 2 * L + 4 + 2))


def global_blocks(V: int) -> int:
    """Blocks an env of V slots takes in the global layout (its cluster)."""
    return -(-V // GLOBAL_THREADS)


def global_threads(V: int) -> int:
    """Threads a block of the global launch at V slots: the fewest multiple
    of 32 whose ``global_blocks(V)`` blocks hold V (``global_threads`` of
    straight_global.cuh)."""
    return -(-(-(-V // global_blocks(V))) // 32) * 32


def global_words(V: int, L: int) -> tuple[int, int]:
    """The float32 words of one env's slab in the global layout of K1 and
    of K3 at V slots and L lanes: the block layout's rows and ballot words
    carved for the env's ``global_blocks(V) * global_threads(V)`` threads
    (K1: a word of pre-check bits per warp per thread; K3: the band's s, the
    far-band winners, the pre-check bits and two flag words per block), each
    rounded up to 4 (``frames_env_words`` and ``sorted_env_words`` of the
    .cu files, the libraries' ``*_global_words``, which chip_smoke.py holds
    this copy to)."""
    blocks = global_blocks(V)
    n = blocks * global_threads(V)
    warps = n // 32

    def up4(w):
        return (w + 3) & ~3

    return (up4((ROW_WORDS + warps) * n + (2 * L + 4) * warps),
            up4((ROW_WORDS + 2 + L + 1) * n + (2 * L + 4 + 2) * warps + 2 * blocks))


def straight_layout_for(V: int, L: int) -> str:
    """The layout of K1 and K3 at V slots and L lanes: "block" (one env a
    block, one thread a slot, its rows in shared memory) where
    ``V <= MAX_SLOTS`` and a block of each asks at most ``SMEM_LIMIT``
    (``launch_smem``), else "global"."""
    if V <= MAX_SLOTS and max(launch_smem(V, L)) <= SMEM_LIMIT:
        return "block"
    return "global"


def kernel_limits(V: int, fs: StraightGeo) -> list[str]:
    """The limits of the straight kernels that a scene of V slots on ``fs``
    breaks: the global layout's slots, whatever the lanes (a scene one block
    cannot hold takes the global layout, ``straight_layout_for``)."""
    return [f"{V} slots > {STRAIGHT_GLOBAL_SLOTS}"] if V > STRAIGHT_GLOBAL_SLOTS else []


def check_frame_shape(veh: VehicleState, fs: StraightGeo) -> tuple[int, int]:
    """(B, V) of a state a frame kernel takes; a scene outside the kernels'
    limits raises (``make`` refuses its env)."""
    B, V = veh.kind.shape
    bad = kernel_limits(V, fs)
    if bad:
        raise ValueError(f"outside the straight kernels' limits: {', '.join(bad)}")
    return B, V


_OFFSETS: dict = {}


def offsets_table(fs: StraightGeo, device) -> torch.Tensor:
    """The device copy of the road's lane offsets, which the kernels copy
    to shared memory: built once per set of offsets and device (before a
    graph captures the launch), so that every env of one road layout
    shares it and making envs does not grow the cache."""
    offsets = np.asarray(fs.offsets, np.float32)
    key = (offsets.tobytes(), str(device))
    if key not in _OFFSETS:
        _OFFSETS[key] = torch.as_tensor(offsets, device=device)
    return _OFFSETS[key]


def kernel_params(fs: StraightGeo, p: IDMParams, dt: float, raw: bool = False,
                  linear: bool = True, device=None, objects: bool = False):
    """The (Geo, Params) structures of the frame kernels; ``linear`` picks
    the kernels' Linear rows' instantiation, ``objects`` K1's objects one
    (the caller sets ``Params.hit`` / ``hit_out``); with ``device``,
    ``Geo.offsets`` points to the offsets' copy there."""
    geo = _Geo(
        ox=float(fs.origin[0]), oy=float(fs.origin[1]),
        ux=float(fs.u[0]), uy=float(fs.u[1]),
        nx=float(fs.n[0]), ny=float(fs.n[1]), theta=fs.theta,
        in_range_hi=fs.length + VEHICLE_LENGTH,
        member_tol=fs.width / 2 + 1.0,
        reach_lat=2 * fs.width,
        speed_limit=0.0 if math.isinf(fs.speed_limit) else fs.speed_limit,
        has_limit=0 if math.isinf(fs.speed_limit) else 1,
        n_lanes=len(fs.offsets),
        offsets=None if device is None else offsets_table(fs, device).data_ptr(),
    )
    params = _Params(
        dt=dt, acc_max=p.acc_max, comfort_acc_max=p.comfort_acc_max,
        distance_wanted=p.distance_wanted, time_wanted=p.time_wanted,
        inv_two_sqrt_ab=p.inv_two_sqrt_ab, politeness=p.politeness,
        lane_change_delay=p.lane_change_delay, kp_a=controller.KP_A,
        kp_heading=controller.KP_HEADING, kp_lateral=controller.KP_LATERAL,
        raw=int(raw), linear=int(linear), objects=int(objects),
    )
    return geo, params


class KernelWrapper:
    """A CUDA kernel's wrapper: ``launches`` counts the launches, and the
    library ``csrc/<source>.cu`` is built and bound at the first launch."""

    source: str

    def __init__(self):
        self.launches = 0
        self._lib = None

    def _bind(self, lib) -> None:
        """Declare the ctypes signature of the library's entry point."""
        raise NotImplementedError

    def _library(self):
        if self._lib is None:
            from highwayenv_tpu_torch.ops import _build

            lib = _build.load_kernel_library(self.source)
            self._bind(lib)
            self._lib = lib
        return self._lib

    @staticmethod
    def check_linear(veh: VehicleState, linear: bool) -> None:
        """On CPU tensors, what the kernel's IDM instantiation asserts on the
        card: without ``linear`` the state holds no Linear row."""
        if not linear and bool((veh.kind == KIND_LINEAR).any()):
            raise ValueError(
                "Linear rows (KIND_LINEAR) in a frame call with linear=False: the "
                "kernels' IDM code would trap on the card"
            )

    @staticmethod
    def check_objects(veh: VehicleState, objects: bool) -> None:
        """On CPU tensors, what the kernels' lean instantiations assert on
        the card: without ``objects`` the state holds no obstacle or
        landmark row (a plain ``Vehicle`` row, ``KIND_PLAIN``, is a vehicle)."""
        if not objects and bool(((veh.kind == KIND_OBSTACLE)
                                 | (veh.kind == KIND_LANDMARK)).any()):
            raise ValueError(
                "obstacle or landmark rows (KIND_OBSTACLE, KIND_LANDMARK) in a lean frame "
                "call: make the env with lean=False (the dense kernel's objects "
                "instantiation); the lean kernels would trap on the card"
            )

    def _launched(self, name: str, err: int) -> None:
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        self.launches += 1


def _masked_plain(veh, fs, p, dt, frames, mask, out, raw: bool = False):
    """``frames_plain`` written over the rows of ``out`` where ``mask`` is
    set, in place (``hit`` too, which only obstacle and landmark rows
    move).  It runs the whole batch: the CPU's vectorized libm rounds a row
    differently depending on how many rows run, and the rows must equal
    those of the dense step."""
    if bool(mask.any()):
        dense = frames_plain(veh, fs, p, dt, frames, raw)
        for name, _, _ in _OUT_FIELDS + _HIT:
            t = getattr(out, name)
            m = mask.view((-1,) + (1,) * (t.dim() - 1))
            t.copy_(torch.where(m, getattr(dense, name), t))
    return out


class StraightFramesKernel(KernelWrapper):
    """Wrapper of the dense ``straight_frames`` CUDA kernel (K1).

    Called on CUDA tensors it launches the kernel once for all frames and
    adds one to ``launches``; on CPU tensors it runs ``frames_plain``.

    With a (B,) bool ``mask`` and an ``out`` state, only the envs where the
    mask is set are simulated, from ``veh``: their rows of ``out``'s mutated
    fields are overwritten in place and the other rows are left as they
    are; ``out`` is returned.  The sorted path uses this as its per-env
    exact fallback, one launch whatever the number of envs that fire.
    ``raw``: the ego keeps its stored controls (ContinuousAction).
    ``linear``: Linear rows are possible, and the kernel's instantiation
    that reads each row's kind runs; without it the IDM code alone runs,
    which traps on a Linear row (cudaErrorLaunchFailure; on CPU tensors a
    ValueError).  ``objects``: obstacle and landmark rows are possible, and
    the objects instantiation runs, which also steps ``hit`` (with a mask,
    in ``out.hit``); without it such a row traps (on CPU tensors a
    ValueError).

    ``glob=True`` is the wrapper of the global layout's K1
    (``csrc/straight_frames_global.cu``, entry ``straight_frames_global``):
    scenes of up to ``STRAIGHT_GLOBAL_SLOTS`` slots and any lanes, one env a
    cluster of ``global_blocks(V)`` blocks of ``global_threads(V)`` threads,
    its rows in a slab of ``global_words(V, L)[0]`` floats an env that each
    call takes from torch's allocator (from the graph's pool when
    captured).  ``frames_kernel_for`` picks the wrapper of a scene's
    layout; the block wrapper raises on a CUDA scene of the global layout.
    """

    #: the fields the kernel reads, in the order of its arguments
    in_fields = _IN_FIELDS
    #: the ctypes mirror of the library's Geo block, and its (Geo, Params)
    #: for a launch on a device
    geo_type = _Geo
    _kernel_params = staticmethod(kernel_params)

    def __init__(self, glob: bool = False):
        super().__init__()
        self.glob = glob
        self.source = self.entry = "straight_frames_global" if glob else "straight_frames"

    def _bind(self, lib):
        fn = getattr(lib, self.entry)
        fn.argtypes = (
            [ctypes.c_void_p] * (len(self.in_fields) + len(_OUT_FIELDS) + 1 + self.glob)
            + [
                ctypes.POINTER(self.geo_type), ctypes.POINTER(_Params),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
        )
        fn.restype = ctypes.c_int

    def smem_bytes(self, V: int, L: int) -> int:
        """The shared memory a block of the launch asks at V slots and L
        lanes (the library's ``straight_frames_smem_bytes``), for a check of
        ``straight_frames.launch_smem``."""
        fn = getattr(self._library(), "straight_frames_smem_bytes")
        fn.argtypes = [ctypes.c_int] * 2
        fn.restype = ctypes.c_longlong
        return int(fn(V, L))

    def global_words(self, V: int, L: int) -> int:
        """The words of one env's slab that the global launch takes at V
        slots and L lanes (the library's ``straight_frames_global_words``),
        for a check of ``straight_frames.global_words``."""
        return _library_words(self, "straight_frames_global_words", V, L)

    def cluster_fit(self, blocks: int, threads: int, L: int, linear: bool = False,
                    objects: bool = False) -> int:
        """Clusters of ``blocks`` blocks of ``threads`` threads of the global
        launch (its ``linear`` / ``objects`` instantiation) the card holds at
        once (the library's ``straight_frames_cluster_fit``;
        tools/cluster_fit.py)."""
        return _library_fit(self, "straight_frames_cluster_fit", blocks, threads, L,
                            linear + 2 * objects)

    def __call__(
        self, veh: VehicleState, fs: StraightGeo, p: IDMParams, dt: float,
        frames: int, mask: torch.Tensor | None = None,
        out: VehicleState | None = None, raw: bool = False, linear: bool = True,
        objects: bool = False,
    ) -> VehicleState:
        if (mask is None) != (out is None):
            raise ValueError("mask and out are given together")
        if not on_cuda(veh.speed):
            self.check_linear(veh, linear)
            self.check_objects(veh, objects)
            if mask is None:
                return frames_plain(veh, fs, p, dt, frames, raw)
            return _masked_plain(veh, fs, p, dt, frames, mask, out, raw)
        B, V = check_frame_shape(veh, fs)
        L = len(fs.offsets)
        check_layout(self, V, L)
        dev = veh.speed.device
        ins = checked_fields(veh, self.in_fields, B, V, dev)
        if mask is None:
            outs = empty_fields(_OUT_FIELDS, B, V, dev)
        else:
            if (mask.dtype != torch.bool or mask.shape != (B,)
                    or mask.device != dev or not mask.is_contiguous()):
                raise ValueError(f"mask: expected contiguous bool ({B},) on {dev}")
            outs = checked_fields(out, _OUT_FIELDS, B, V, dev)
        slab = _slab(self.glob, B, global_words(V, L)[0], dev)
        geo, params = self._kernel_params(fs, p, dt, raw, linear, dev, objects)
        hit = []  # with objects: hit in and out
        if objects:
            hit = checked_fields(veh, _HIT, B, V, dev)
            hit += (empty_fields(_HIT, B, V, dev) if mask is None
                    else checked_fields(out, _HIT, B, V, dev))
            params.hit, params.hit_out = hit[0].data_ptr(), hit[1].data_ptr()
        lib = self._library()
        with torch.cuda.device(dev):
            err = getattr(lib, self.entry)(
                *[t.data_ptr() for t in ins + outs],
                None if mask is None else mask.data_ptr(), *[t.data_ptr() for t in slab],
                ctypes.byref(geo), ctypes.byref(params), B, V, frames,
                torch.cuda.current_stream(dev).cuda_stream,
            )
        self._launched(self.entry, err)
        if mask is not None:
            return out
        return with_fields(veh, _OUT_FIELDS + _HIT * objects, outs + hit[1:])


def check_layout(wrapper, V: int, L: int) -> None:
    """A block wrapper refuses a scene of V slots and L lanes that one block
    cannot hold (``straight_layout_for``); the global wrapper takes any."""
    if not wrapper.glob and straight_layout_for(V, L) == "global":
        raise ValueError(f"{V} slots and {L} lanes take the global layout, which "
                         f"{wrapper.source} does not launch: call the *_kernel_for wrapper")


def _slab(glob: bool, B: int, words: int, dev) -> list[torch.Tensor]:
    """The slab a global launch takes (B envs of ``words`` floats), as the
    list of the entry's extra arguments; none for a block launch.  The
    caller holds it until the launch is queued: freed after it, torch's
    allocator hands its memory only to work queued behind the kernel on the
    same stream."""
    if not glob:
        return []
    return [torch.empty(B * words, dtype=torch.float32, device=dev)]


def _library_words(wrapper, name: str, V: int, L: int) -> int:
    if not wrapper.glob:
        raise ValueError(f"{name} asks the global library")
    fn = getattr(wrapper._library(), name)
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_longlong
    return int(fn(V, L))


def _library_fit(wrapper, name: str, blocks: int, threads: int, L: int, variant: int) -> int:
    """The library's ``*_cluster_fit`` of its ``variant`` instantiation
    (bit 0: the Linear rows', bit 1: K1's objects one)."""
    if not wrapper.glob:
        raise ValueError(f"{name} asks the global library")
    if not 1 <= blocks <= 16 or threads % 32 or not 32 <= threads <= GLOBAL_THREADS:
        raise ValueError(f"clusters of 1 to 16 blocks of 32 to {GLOBAL_THREADS} threads, a "
                         f"multiple of 32 (got {blocks} blocks of {threads} threads)")
    fn = getattr(wrapper._library(), name)
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return int(fn(blocks, threads, L, int(variant)))


#: the wrapper instances the env path launches through, one a layout
frames_kernel = StraightFramesKernel()
frames_global_kernel = StraightFramesKernel(glob=True)


def frames_kernel_for(V: int, L: int) -> StraightFramesKernel:
    """K1's wrapper for a scene of V slots and L lanes: ``frames_kernel``,
    or ``frames_global_kernel`` where ``straight_layout_for`` says "global".
    Looked up by name when called, so that a stand-in put in the module's
    place is taken."""
    return globals()["frames_global_kernel" if straight_layout_for(V, L) == "global"
                     else "frames_kernel"]


def simulate_bm(
    env, veh: VehicleState, slot_actions: torch.Tensor, frames: int
) -> VehicleState:
    """Policy-step simulation: the ego's action in torch (frame 0), then
    all ``frames`` frames through K1 in the scene's layout
    (``frames_kernel_for``), its objects instantiation where the env was
    made with ``lean=False``."""
    veh = env.action_type.apply(env.geo, veh, veh.kind == KIND_EGO, slot_actions)
    k1 = frames_kernel_for(veh.kind.shape[1], len(env._straight.offsets))
    return k1(veh, env._straight, env.idm_params, env.dt, frames,
              raw=env.action_type.stores_raw_controls, linear=env.linear_rows,
              objects=not env.lean)
