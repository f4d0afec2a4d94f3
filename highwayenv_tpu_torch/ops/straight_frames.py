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

Every phase reads the frame-start state.  ``frames_kernel`` runs all
``frames`` frames of a policy step in one launch of
``csrc/straight_frames.cu`` for CUDA tensors, and ``frames_plain`` (batched
torch over (B, V, V) pair tensors) for CPU tensors; the two compute the
same float32 arithmetic in the same order.  The kernel covers the scenes
the straight highway envs spawn: vehicles only (no obstacles or landmarks)
and IDM NPCs (no Linear-family presets); ``envs/base.py`` refuses other
configurations when the env is made.

The ego meta-action is applied once per policy step in torch before the
frames (``simulate_bm``), as ``pallas_simulate_bm`` does.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from highwayenv_tpu_torch.ops import collision
from highwayenv_tpu_torch.ops.straight_fast import StraightGeo
from highwayenv_tpu_torch.vehicle import controller, kinematics
from highwayenv_tpu_torch.vehicle.behavior import IDMParams, idm_acceleration
from highwayenv_tpu_torch.vehicle.state import (
    KIND_EGO,
    KIND_IDM,
    KIND_LANDMARK,
    VEHICLE_LENGTH,
    VehicleState,
)

#: most lanes the kernel's constant block holds (``MAX_LANES`` in the .cu)
MAX_LANES = 16
#: most slots one thread block can hold (one thread per slot)
MAX_SLOTS = 1024


def neighbours(s, lat0, occupiable, q_off, tol: float):
    """Front / rear neighbour slots of every query (B, K, V), -1 = none.

    s, lat0, occupiable: (B, V) per slot; q_off: (B, K, V) lateral offset
    of each query's lane.  A column is on the query lane when
    ``|lat0_c - q_off| <= tol``.  Front = smallest s_c >= s_q, keeping the
    LAST column among equal keys; rear = largest s_c < s_q, keeping the
    FIRST (the reference's ``<=`` / strict ``>`` scans, PARITY #3).  A slot
    is never its own neighbour.
    """
    V = s.shape[-1]
    cols = torch.arange(V, device=s.device)
    member = (
        ((lat0[:, None, None, :] - q_off[..., None]).abs() <= tol)
        & occupiable[:, None, None, :]
        & (cols[:, None] != cols[None, :])
    )  # (B, K, V, V)
    s_q = s[:, None, :, None]
    s_c = s[:, None, None, :]
    front_ok = member & (s_q <= s_c)
    f_key = torch.where(front_ok, s_c, math.inf)
    f_hit = front_ok & (f_key == f_key.amin(dim=-1, keepdim=True))
    front_idx = torch.where(f_hit, cols, -1).amax(dim=-1)
    rear_ok = member & (s_c < s_q)
    r_key = torch.where(rear_ok, s_c, -math.inf)
    r_hit = rear_ok & (r_key == r_key.amax(dim=-1, keepdim=True))
    rear_idx = torch.where(r_hit, cols, V).amin(dim=-1)
    return front_idx, torch.where(rear_idx == V, -1, rear_idx)


def _frame_plain(veh: VehicleState, fs: StraightGeo, p: IDMParams, dt: float):
    """One frame on (B, V) fields; pair tensors are (B, [3,] V, V)."""
    B, V = veh.kind.shape
    dev = veh.speed.device
    off = torch.as_tensor(fs.offsets, device=dev)
    L = off.shape[0]
    ox, oy = float(fs.origin[0]), float(fs.origin[1])
    ux, uy = float(fs.u[0]), float(fs.u[1])
    nx, ny = float(fs.n[0]), float(fs.n[1])
    eye = torch.eye(V, dtype=torch.bool, device=dev)

    kind = veh.kind
    px, py = veh.pos[..., 0], veh.pos[..., 1]
    s = (px - ox) * ux + (py - oy) * uy
    lat0 = (px - ox) * nx + (py - oy) * ny
    is_vehicle = veh.is_vehicle
    idm = (kind == KIND_IDM) & ~veh.crashed
    occupiable = (
        (-VEHICLE_LENGTH <= s) & (s < fs.length + VEHICLE_LENGTH)
        & veh.active & (kind != KIND_LANDMARK)
    )
    lane = veh.lane.long()
    q_lanes = torch.stack(
        [lane, (lane - 1).clamp(0, L - 1), (lane + 1).clamp(0, L - 1)], dim=1
    )  # (B, 3, V): own lane, lane - 1, lane + 1
    q_off = off[q_lanes.clamp(0, L - 1)]

    front_idx, rear_idx = neighbours(
        s, lat0, occupiable, q_off, fs.width / 2 + 1.0
    )  # (B, 3, V)
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

    def accel(eg, fr):
        a = idm_acceleration(
            p, fs.speed_limit, veh.delta,
            eg["speed"], eg["target_speed"], eg["s"], eg["cos"], eg["sin"],
            fr["s"], fr["vx"], fr["vy"], fr["ex"],
        )
        return torch.where(eg["ex"] & eg["is_vehicle"], a, 0.0)

    a_self = accel(self_row, fronts[0])
    a_of = accel(rears[0], self_row)
    a_of_pred = accel(rears[0], fronts[0])

    # --- MOBIL ------------------------------------------------------------ #
    mid_change = veh.lane != veh.target_lane
    tick = veh.timer > p.lane_change_delay
    deciding = idm & ~mid_change & tick & veh.enable_lane_change
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
    steer_pc = controller.steering_from_coords(
        fs.theta, lat_t, veh.heading, veh.speed, veh.length
    )
    # dual-lane IDM while changing lanes: the target is within one lane of
    # the current one, so its front neighbour is one of the three queries
    d_t = target - veh.lane
    npt = {
        key: torch.where(
            d_t == 0, fronts[0][key],
            torch.where(d_t < 0, fronts[1][key], fronts[2][key]),
        )
        for key in ("s", "vx", "vy", "ex")
    }
    a_t = accel(self_row, npt)
    acc = torch.where(target != veh.lane, torch.minimum(a_self, a_t), a_self)
    acc = acc.clamp(-p.acc_max, p.acc_max)

    is_ego = kind == KIND_EGO
    new_steer = torch.where(is_ego | idm, steer_pc, veh.steering)
    new_accel = torch.where(
        is_ego,
        controller.speed_control(veh.target_speed, veh.speed),
        torch.where(idm, acc, veh.accel),
    )
    veh = veh.replace(
        target_lane=target, timer=new_timer, steering=new_steer, accel=new_accel
    )

    # --- integrate, re-localize on the nearest lane offset, collide -------- #
    veh = kinematics.integrate(veh, dt)
    lat_new = (veh.pos[..., 0] - ox) * nx + (veh.pos[..., 1] - oy) * ny
    new_lane = (lat_new[..., None] - off).abs().argmin(dim=-1).to(torch.int32)
    veh = veh.replace(lane=torch.where(veh.is_vehicle, new_lane, veh.lane))
    return collision.handle_collisions(veh, dt)


def frames_plain(
    veh: VehicleState, fs: StraightGeo, p: IDMParams, dt: float, frames: int
) -> VehicleState:
    """``frames`` frames in plain batched torch (the kernel's reference)."""
    for _ in range(frames):
        veh = _frame_plain(veh, fs, p, dt)
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
        ("offsets", ctypes.c_float * MAX_LANES),
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
]
_OUT_FIELDS = [
    ("pos", torch.float32, (2,)), ("heading", torch.float32, ()),
    ("speed", torch.float32, ()), ("lane", torch.int32, ()),
    ("target_lane", torch.int32, ()), ("timer", torch.float32, ()),
    ("crashed", torch.bool, ()), ("impact_pending", torch.bool, ()),
    ("impact", torch.float32, (2,)), ("steering", torch.float32, ()),
    ("accel", torch.float32, ()),
]


class StraightFramesKernel:
    """Wrapper of the ``straight_frames`` CUDA kernel.

    Called on CUDA tensors it launches the kernel once for all frames and
    adds one to ``launches``; on CPU tensors it runs ``frames_plain``.  The
    shared library is built from ``csrc/straight_frames.cu`` at first use.
    """

    def __init__(self):
        self.launches = 0
        self._lib = None

    def _library(self):
        if self._lib is None:
            from highwayenv_tpu_torch.ops import _build

            lib = _build.load_kernel_library("straight_frames")
            lib.straight_frames.argtypes = (
                [ctypes.c_void_p] * (len(_IN_FIELDS) + len(_OUT_FIELDS))
                + [
                    ctypes.POINTER(_Geo), ctypes.POINTER(_Params),
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ]
            )
            lib.straight_frames.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def __call__(
        self, veh: VehicleState, fs: StraightGeo, p: IDMParams, dt: float,
        frames: int,
    ) -> VehicleState:
        if veh.speed.device.type == "cpu":
            return frames_plain(veh, fs, p, dt, frames)
        if veh.speed.device.type != "cuda":
            raise ValueError(f"unsupported device {veh.speed.device}")
        B, V = veh.kind.shape
        L = len(fs.offsets)
        if V > MAX_SLOTS:
            raise ValueError(f"{V} slots > {MAX_SLOTS}: one thread per slot")
        if L > MAX_LANES:
            raise ValueError(f"{L} lanes > {MAX_LANES}")
        dev = veh.speed.device
        ins = []
        for name, dtype, trail in _IN_FIELDS:
            t = getattr(veh, name)
            if t.device != dev or t.dtype != dtype or t.shape != (B, V) + trail:
                raise ValueError(
                    f"{name}: expected {dtype} {(B, V) + trail} on {dev}, got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device}"
                )
            if not t.is_contiguous():
                raise ValueError(f"{name} is not contiguous")
            ins.append(t)
        outs = {
            name: torch.empty((B, V) + trail, dtype=dtype, device=dev)
            for name, dtype, trail in _OUT_FIELDS
        }
        geo = _Geo(
            ox=float(fs.origin[0]), oy=float(fs.origin[1]),
            ux=float(fs.u[0]), uy=float(fs.u[1]),
            nx=float(fs.n[0]), ny=float(fs.n[1]), theta=fs.theta,
            in_range_hi=fs.length + VEHICLE_LENGTH,
            member_tol=fs.width / 2 + 1.0,
            reach_lat=2 * fs.width,
            speed_limit=0.0 if math.isinf(fs.speed_limit) else fs.speed_limit,
            has_limit=0 if math.isinf(fs.speed_limit) else 1,
            n_lanes=L,
        )
        for i, o in enumerate(fs.offsets):
            geo.offsets[i] = float(o)
        params = _Params(
            dt=dt, acc_max=p.acc_max, comfort_acc_max=p.comfort_acc_max,
            distance_wanted=p.distance_wanted, time_wanted=p.time_wanted,
            inv_two_sqrt_ab=p.inv_two_sqrt_ab, politeness=p.politeness,
            lane_change_delay=p.lane_change_delay, kp_a=controller.KP_A,
            kp_heading=controller.KP_HEADING, kp_lateral=controller.KP_LATERAL,
        )
        lib = self._library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.straight_frames(
                *[t.data_ptr() for t in ins],
                *[t.data_ptr() for t in outs.values()],
                ctypes.byref(geo), ctypes.byref(params),
                B, V, frames, stream,
            )
        if err != 0:
            raise RuntimeError(f"straight_frames launch failed: CUDA error {err}")
        self.launches += 1
        return veh.replace(**outs)


#: the one wrapper instance the env path launches through
frames_kernel = StraightFramesKernel()


def simulate_bm(
    env, veh: VehicleState, slot_actions: torch.Tensor, frames: int
) -> VehicleState:
    """Policy-step simulation: the ego meta-action in torch (frame 0), then
    all ``frames`` frames through ``frames_kernel``."""
    veh = env.action_type.apply(env.geo, veh, veh.kind == KIND_EGO, slot_actions)
    return frames_kernel(veh, env._straight, env.idm_params, env.dt, frames)
