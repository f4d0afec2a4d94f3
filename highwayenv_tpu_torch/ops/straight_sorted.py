"""The s-sorted straight-road policy step: sort, banded frames, unsort, and
the dense K1 as the per-env exact fallback.

Counterpart of the sorted half of ``highwayenv_tpu/ops/straight_pallas_bm.py``
(``pallas_simulate_bm_sorted`` :1302-1393 and its kernels), the JAX package's
default step for lean straight scenes.  ``simulate_bm_sorted``:

  1. applies the ego meta-action (frame 0), as the dense path does;
  2. K2a ``sort_kernel``: every env's rows in ascending s at the start of the
     policy step (a stable rank, ties by slot), with ``idx`` the original
     slot of each rank (``csrc/straight_sort.cu``);
  3. K3 ``frames_sorted_kernel``: all frames on that layout, with banded
     neighbour and collision searches and two sticky per-env flags that
     rise when the band may have missed something
     (``csrc/straight_frames_sorted.cu``);
  4. K2b ``unsort_kernel``: the mutated fields back to slot order;
  5. K1 (``straight_frames.frames_kernel_for``) with the per-env mask of the
     flags: the flagged envs re-run densely from the pre-step state and
     overwrite their banded rows, so the result is the dense step's for
     every env (up to the order of a SAT's two rectangles, a few ulp).

Each kernel's plain torch version sits beside it (``sort_plain``,
``frames_sorted_plain``, ``unsort_plain``); a wrapper launches its kernel
on CUDA tensors and runs the plain version on CPU tensors.  K2a and K2b
take every scene of up to 8192 slots (one block an env, each thread
looping over its slots).  K3 and K1 have a wrapper a layout: past one
block (``straight_frames.straight_layout_for``: over 1024 slots, or a
block over its shared memory) ``frames_sorted_kernel_for`` and
``straight_frames.frames_kernel_for`` pick the global ones
(``frames_sorted_global_kernel``: ``csrc/straight_frames_sorted_global.cu``,
one env a cluster of blocks with its rows in global memory).

The bands: collisions are checked on the ``SORT_WINDOW`` nearest rank
diagonals, neighbours searched ``NEIGH_WINDOW`` ranks either side, both
clipped to V - 1 as the JAX package clips them.  Beyond the band, each lane
keeps the winner of a suffix argmin / prefix argmax of s, so the neighbour
search is exact unless a far member crossed the query in s within the step.

The sorted kernels are lean, as the JAX package's are: its sorted step
runs only where ``pallas_lean`` holds (``envs/base.py:1124-1129``), and
its lean kernel drives an obstacle row as IDM.  Here K3 refuses obstacle
and landmark rows (a ValueError on CPU tensors, a trap on the card), and an
env made with ``lean=False`` steps ``straight_frames.simulate_bm`` instead.

One difference from the JAX kernel, on purpose: the collision flag's reach
R = max diag + max speed * dt is taken over the env's own slots, where the
TPU kernel takes it over its whole tile of envs (``:196-198``), which makes
one env's flag depend on its neighbours in the batch.  Both bounds are
conservative, so the results are the same; the port's flag fires on the
same envs or fewer.
"""

from __future__ import annotations

import ctypes
import math

import torch

from highwayenv_tpu_torch.ops import straight_frames
from highwayenv_tpu_torch.ops.straight_fast import StraightGeo
from highwayenv_tpu_torch.ops.straight_frames import (
    KernelWrapper,
    _Geo,
    _library_fit,
    _library_words,
    _Params,
    _slab,
    check_frame_shape,
    check_layout,
    checked_fields,
    empty_fields,
    frames_kernel_for,
    global_words,
    kernel_params,
    on_cuda,
    straight_layout_for,
    with_fields,
)
from highwayenv_tpu_torch.utils.math import rects_intersecting_xy_folded
from highwayenv_tpu_torch.vehicle.behavior import IDMParams
from highwayenv_tpu_torch.vehicle.state import KIND_EGO, VehicleState

#: rank window of the banded collision pass (JAX ``SORT_WINDOW``)
SORT_WINDOW = 12
#: rank window of the banded neighbour search (JAX ``NEIGH_WINDOW``)
NEIGH_WINDOW = 6

#: the fields the sorted frames read, in rank order after the sort
SORT_FIELDS = straight_frames._IN_FIELDS
#: the fields the frames write, back in slot order after the unsort
MUT_FIELDS = straight_frames._OUT_FIELDS


def windows(V: int) -> tuple[int, int]:
    """(collision window, neighbour window) for V slots, clipped to V - 1."""
    return min(SORT_WINDOW, V - 1), min(NEIGH_WINDOW, V - 1)


def s_coordinate(pos: torch.Tensor, fs: StraightGeo) -> torch.Tensor:
    """Longitudinal coordinate (px - ox) ux + (py - oy) uy of (..., 2) positions."""
    ox, oy = float(fs.origin[0]), float(fs.origin[1])
    ux, uy = float(fs.u[0]), float(fs.u[1])
    return (pos[..., 0] - ox) * ux + (pos[..., 1] - oy) * uy


def _per_row(index: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(B, V) ``index`` broadcast over the trailing dims of ``t``."""
    return index.view(index.shape + (1,) * (t.dim() - 2)).expand_as(t)


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #
def sort_plain(veh: VehicleState, fs: StraightGeo):
    """K2a's plain version: ``(veh in rank order, idx)``.

    The rank of a slot is its place in ascending s at the start of the
    step, ties kept in slot order: the count rule of the kernel, which sees
    -0.0 and 0.0 as equal (the ``+ 0.0`` turns -0.0 into 0.0 for the sort).
    The ``SORT_FIELDS`` of the returned state are in rank order; its other
    fields keep slot order and are not read by the sorted frames.  ``idx``
    (B, V) int32 is the original slot of each rank.
    """
    order = torch.sort(s_coordinate(veh.pos, fs) + 0.0, dim=1, stable=True).indices
    return veh.replace(**{
        name: torch.gather(getattr(veh, name), 1, _per_row(order, getattr(veh, name)))
        for name, _, _ in SORT_FIELDS
    }), order.to(torch.int32)


def unsort_plain(srt: VehicleState, idx: torch.Tensor, veh: VehicleState) -> VehicleState:
    """K2b's plain version: ``veh`` with the ``MUT_FIELDS`` of the rank-order
    state ``srt`` moved back to slot order (rank r to slot ``idx[r]``)."""
    index = idx.long()
    out = {}
    for name, _, _ in MUT_FIELDS:
        t = getattr(srt, name)
        out[name] = torch.empty_like(t).scatter_(1, _per_row(index, t), t)
    return veh.replace(**out)


def neigh_banded_plain(s, lat0, occupiable, q_off, tol: float, Wn: int):
    """Banded neighbour search on the rank layout: ``(front, rear, crossed)``,
    each (B, K, V) for K query lanes of (B, K, V) offsets ``q_off``.

    In band (ranks r-Wn..r+Wn) the candidates are the lane's members as in
    ``straight_frames.neighbours``; beyond it, only the far-ahead winner
    (least s over ranks > r+Wn, ties to the larger rank) and the far-behind
    winner (greatest s over ranks < r-Wn, ties to the smaller rank).  Front
    is the least s >= s_r with ties to the larger rank, rear the greatest
    s < s_r with ties to the smaller rank; -1 = none.  ``crossed`` marks the
    queries whose far-ahead winner lies behind s_r or far-behind winner at or
    ahead of it: a far member crossed the query since the sort, and the band
    may have missed the true neighbour.
    """
    V = s.shape[-1]
    ranks = torch.arange(V, device=s.device)
    gap = ranks[None, :] - ranks[:, None]  # [r, c] = c - r
    member = straight_frames.lane_members(s, lat0, occupiable, q_off, tol)
    s_q = s[:, None, :, None]
    s_c = s[:, None, None, :]
    ahead = straight_frames.front_pick(member & (gap > Wn), s_c)
    behind = straight_frames.rear_pick(member & (gap < -Wn), s_c)

    def key(idx):
        return torch.gather(s[:, None, :].expand_as(idx), 2, idx.clamp(min=0))

    s_r = s[:, None, :]
    crossed = ((ahead >= 0) & (key(ahead) < s_r)) | ((behind >= 0) & (key(behind) >= s_r))
    band = gap.abs() <= Wn
    front = straight_frames.front_pick(
        member & (s_q <= s_c) & (band | (ranks == ahead[..., None])), s_c
    )
    rear = straight_frames.rear_pick(
        member & (s_c < s_q) & (band | (ranks == behind[..., None])), s_c
    )
    return front, rear, crossed


def collisions_banded_plain(veh: VehicleState, idx: torch.Tensor, fs: StraightGeo,
                            dt: float, W: int):
    """Banded collision pass on the rank layout: ``(veh, flag)``.

    Pairs at rank distance 1..W behind the dense pass's gate and sphere
    pre-check, with the reach of the member of lower original slot; the
    lower rank is the SAT's first rectangle.  Each slot's impact is the half
    translation toward it of its last-written pair: the largest partner
    original slot among pairs where it is the ``self`` (the lower original
    slot), else among the others (PARITY #2).  ``flag`` (B,) rises where an
    active rank beyond r+W is within R = max diag + max speed * dt of s_r,
    so a pair beyond the band could be within reach.
    """
    V = veh.kind.shape[-1]
    ranks = torch.arange(V, device=veh.speed.device)
    gap = ranks[None, :] - ranks[:, None]

    def rows(x):
        return x[..., :, None]

    def cols(x):
        return x[..., None, :]

    active, is_veh = veh.active, veh.is_vehicle
    chk, coll = veh.check_collisions, veh.collidable
    px, py = veh.pos[..., 0], veh.pos[..., 1]
    diag = veh.diagonal
    speed_lo = torch.where(rows(idx) < cols(idx), rows(veh.speed), cols(veh.speed))
    reach = (rows(diag) + cols(diag)) / 2 + speed_lo * dt
    dx = rows(px) - cols(px)
    dy = rows(py) - cols(py)
    pair_ok = (
        (gap >= 1) & (gap <= W)
        & rows(active) & cols(active)
        & (rows(is_veh) | cols(is_veh))
        & (rows(chk) | cols(chk))
        & rows(coll) & cols(coll)
        & (dx * dx + dy * dy <= reach * reach)
    )
    velx = veh.speed * torch.cos(veh.heading)
    vely = veh.speed * torch.sin(veh.heading)
    inter, will, tx, ty = rects_intersecting_xy_folded(
        rows(px), rows(py), rows(veh.length), rows(veh.width), rows(veh.heading),
        cols(px), cols(py), cols(veh.length), cols(veh.width), cols(veh.heading),
        relx=(rows(velx) - cols(velx)) * dt,
        rely=(rows(vely) - cols(vely)) * dt,
    )
    inter = inter & pair_ok
    will = will & pair_ok

    # [v, u]: slot v's side of its pair with u; +half toward the lower rank
    upper = gap > 0
    writes = will | will.transpose(-1, -2)
    hx, hy = 0.5 * tx, 0.5 * ty
    to_x = torch.where(upper, hx, -hx.transpose(-1, -2))
    to_y = torch.where(upper, hy, -hy.transpose(-1, -2))
    partner = cols(idx).expand_as(writes)
    row_side = rows(idx) < cols(idx)

    def last(side):
        key = torch.where(writes & side, partner, -1)
        at = key.argmax(dim=-1, keepdim=True)
        return key.amax(dim=-1) >= 0, to_x.gather(-1, at)[..., 0], to_y.gather(-1, at)[..., 0]

    any_row, row_x, row_y = last(row_side)
    any_col, col_x, col_y = last(~row_side)
    imp_x = torch.where(any_row, row_x, torch.where(any_col, col_x, veh.impact[..., 0]))
    imp_y = torch.where(any_row, row_y, torch.where(any_col, col_y, veh.impact[..., 1]))
    veh = veh.replace(
        crashed=veh.crashed | inter.any(dim=-1) | inter.any(dim=-2),
        impact=torch.stack([imp_x, imp_y], dim=-1),
        impact_pending=veh.impact_pending | writes.any(dim=-1),
    )

    # a pair beyond the band within reach: suffix min / max of s over ranks
    # > r + W against R of this env
    s = s_coordinate(veh.pos, fs)
    R = (torch.where(active, diag, 0.0).amax(dim=-1)
         + torch.where(active, veh.speed, 0.0).amax(dim=-1) * dt)[:, None]

    def beyond(x, reduce, fill):
        sfx = reduce(x.flip(-1), dim=-1).values.flip(-1)[:, W + 1:]
        return torch.cat([sfx, torch.full_like(x[:, : W + 1], fill)], dim=-1)

    far_min = beyond(torch.where(active, s, torch.inf), torch.cummin, torch.inf)
    far_max = beyond(torch.where(active, s, -torch.inf), torch.cummax, -torch.inf)
    flag = active & (far_min <= s + R) & (far_max >= s - R)
    return veh, flag.any(dim=-1)


def frames_sorted_plain(srt: VehicleState, idx: torch.Tensor, fs: StraightGeo,
                        p: IDMParams, dt: float, frames: int, raw: bool = False):
    """K3's plain version: ``frames`` frames of the rank-order state ``srt``
    with the banded searches; ``(srt, flags)`` with ``flags`` (B, 2) bool,
    sticky over the frames: [:, 0] the collision band's, [:, 1] the
    neighbour band's.  The neighbour flag counts only rows that consume the
    query: the own lane for uncrashed IDM rows, lanes -1 / +1 for deciding
    or mid-change rows.  ``raw``: the ego keeps its stored controls."""
    B, V = srt.kind.shape
    W, Wn = windows(V)
    flags = torch.zeros(B, 2, dtype=torch.bool, device=srt.speed.device)
    for _ in range(frames):
        s, lat0, occupiable, q_lanes, q_off = straight_frames.project(srt, fs)
        front, rear, crossed = neigh_banded_plain(
            s, lat0, occupiable, q_off, fs.width / 2 + 1.0, Wn
        )
        idm, mid_change, deciding = straight_frames.mobil_gates(srt, p)
        side = deciding | mid_change
        consumes = torch.stack([idm, side, side], dim=1)
        srt = straight_frames.drive(
            srt, fs, p, dt, s, lat0, q_lanes, q_off, front, rear, raw
        )
        srt, coll = collisions_banded_plain(srt, idx, fs, dt, W)
        neigh = (crossed & consumes).flatten(1).any(dim=-1)
        flags = flags | torch.stack([coll, neigh], dim=-1)
    return srt, flags


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #
def _perm_args(ins, outs):
    """The ctypes arrays of a permutation launch: input and output
    pointers and the bytes of one slot of each field."""
    n = len(ins)
    return (
        (ctypes.c_void_p * n)(*[t.data_ptr() for t in ins]),
        (ctypes.c_void_p * n)(*[t.data_ptr() for t in outs]),
        (ctypes.c_int * n)(*[math.prod(t.shape[2:]) * t.element_size() for t in ins]),
        n,
    )


_PERM_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]


def _checked_idx(idx: torch.Tensor, B: int, V: int, dev) -> torch.Tensor:
    if (idx.dtype != torch.int32 or idx.shape != (B, V) or idx.device != dev
            or not idx.is_contiguous()):
        raise ValueError(f"idx: expected contiguous int32 ({B}, {V}) on {dev}")
    return idx


class SortKernel(KernelWrapper):
    """Wrapper of K2a, ``sort_kernel`` of ``csrc/straight_sort.cu``:
    ``(veh, fs) -> (veh in rank order, idx)`` as ``sort_plain``."""

    source = "straight_sort"

    def _bind(self, lib):
        lib.straight_sort.argtypes = _PERM_ARGTYPES + [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.straight_sort.restype = ctypes.c_int

    def __call__(self, veh: VehicleState, fs: StraightGeo):
        if not on_cuda(veh.speed):
            return sort_plain(veh, fs)
        B, V = check_frame_shape(veh, fs)
        dev = veh.speed.device
        ins = checked_fields(veh, SORT_FIELDS, B, V, dev)
        outs = empty_fields(SORT_FIELDS, B, V, dev)
        idx = torch.empty((B, V), dtype=torch.int32, device=dev)
        lib = self._library()
        with torch.cuda.device(dev):
            err = lib.straight_sort(
                *_perm_args(ins, outs), veh.pos.data_ptr(), idx.data_ptr(),
                float(fs.origin[0]), float(fs.origin[1]),
                float(fs.u[0]), float(fs.u[1]), B, V,
                torch.cuda.current_stream(dev).cuda_stream,
            )
        self._launched("straight_sort", err)
        return with_fields(veh, SORT_FIELDS, outs), idx


class UnsortKernel(KernelWrapper):
    """Wrapper of K2b, ``unsort_kernel`` of ``csrc/straight_sort.cu``:
    ``(srt, idx, veh) -> veh`` with the mutated fields back in slot order,
    as ``unsort_plain``."""

    source = "straight_sort"

    def _bind(self, lib):
        lib.straight_unsort.argtypes = _PERM_ARGTYPES + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.straight_unsort.restype = ctypes.c_int

    def __call__(self, srt: VehicleState, idx: torch.Tensor, veh: VehicleState):
        if not on_cuda(srt.speed):
            return unsort_plain(srt, idx, veh)
        B, V = srt.kind.shape
        dev = srt.speed.device
        ins = checked_fields(srt, MUT_FIELDS, B, V, dev)
        index = _checked_idx(idx, B, V, dev)
        outs = empty_fields(MUT_FIELDS, B, V, dev)
        lib = self._library()
        with torch.cuda.device(dev):
            err = lib.straight_unsort(
                *_perm_args(ins, outs), index.data_ptr(), B, V,
                torch.cuda.current_stream(dev).cuda_stream,
            )
        self._launched("straight_unsort", err)
        return with_fields(veh, MUT_FIELDS, outs)


class FramesSortedKernel(KernelWrapper):
    """Wrapper of K3, ``csrc/straight_frames_sorted.cu``: ``(srt, idx, fs,
    p, dt, frames) -> (srt, flags)`` as ``frames_sorted_plain``, all frames
    in one launch; ``raw`` and ``linear`` as for K1.  It is lean, as the JAX
    package's sorted step is: an obstacle or landmark row raises on CPU
    tensors (``check_objects``) and traps on the card.  With ``glob`` the
    global layout's K3 (``csrc/straight_frames_sorted_global.cu``, entry
    ``straight_frames_sorted_global``), its rows in a slab of
    ``global_words(V, L)[1]`` floats an env; ``frames_sorted_kernel_for``
    picks the wrapper of a scene's layout, and the block wrapper refuses a
    CUDA scene of the global layout, as K1's does."""

    #: the fields the kernel reads, in the order of its arguments
    in_fields = SORT_FIELDS
    #: the ctypes mirror of the library's Geo block, and its (Geo, Params)
    #: for a launch on a device
    geo_type = _Geo
    _kernel_params = staticmethod(kernel_params)

    def __init__(self, glob: bool = False):
        super().__init__()
        self.glob = glob
        self.source = self.entry = ("straight_frames_sorted_global" if glob
                                    else "straight_frames_sorted")

    def _bind(self, lib):
        fn = getattr(lib, self.entry)
        fn.argtypes = (
            [ctypes.c_void_p] * (len(self.in_fields) + len(MUT_FIELDS) + 2 + self.glob)
            + [
                ctypes.POINTER(self.geo_type), ctypes.POINTER(_Params),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p,
            ]
        )
        fn.restype = ctypes.c_int

    def smem_bytes(self, V: int, L: int) -> int:
        """The shared memory a block of the launch asks at V slots and L
        lanes (the library's ``straight_frames_sorted_smem_bytes``), for a check of
        ``straight_frames.launch_smem``."""
        fn = getattr(self._library(), "straight_frames_sorted_smem_bytes")
        fn.argtypes = [ctypes.c_int] * 2
        fn.restype = ctypes.c_longlong
        return int(fn(V, L))

    def global_words(self, V: int, L: int) -> int:
        """The words of one env's slab that the global launch takes at V
        slots and L lanes (``straight_frames_sorted_global_words``), for a
        check of ``straight_frames.global_words``."""
        return _library_words(self, "straight_frames_sorted_global_words", V, L)

    def cluster_fit(self, blocks: int, threads: int, L: int, linear: bool = False) -> int:
        """Clusters of ``blocks`` blocks of ``threads`` threads of the global
        launch the card holds at once (``straight_frames_sorted_cluster_fit``)."""
        return _library_fit(self, "straight_frames_sorted_cluster_fit", blocks, threads, L,
                            linear)

    def __call__(self, srt: VehicleState, idx: torch.Tensor, fs: StraightGeo,
                 p: IDMParams, dt: float, frames: int, raw: bool = False,
                 linear: bool = True):
        if not on_cuda(srt.speed):
            self.check_linear(srt, linear)
            self.check_objects(srt, False)
            return frames_sorted_plain(srt, idx, fs, p, dt, frames, raw)
        B, V = check_frame_shape(srt, fs)
        L = len(fs.offsets)
        check_layout(self, V, L)
        dev = srt.speed.device
        ins = checked_fields(srt, self.in_fields, B, V, dev)
        index = _checked_idx(idx, B, V, dev)
        outs = empty_fields(MUT_FIELDS, B, V, dev)
        flags = torch.empty((B, 2), dtype=torch.bool, device=dev)
        slab = _slab(self.glob, B, global_words(V, L)[1], dev)
        geo, params = self._kernel_params(fs, p, dt, raw, linear, dev)
        W, Wn = windows(V)
        lib = self._library()
        with torch.cuda.device(dev):
            err = getattr(lib, self.entry)(
                *[t.data_ptr() for t in ins + outs],
                index.data_ptr(), flags.data_ptr(), *[t.data_ptr() for t in slab],
                ctypes.byref(geo), ctypes.byref(params), B, V, frames, W, Wn,
                torch.cuda.current_stream(dev).cuda_stream,
            )
        self._launched(self.entry, err)
        return with_fields(srt, MUT_FIELDS, outs), flags


#: the wrapper instances the env path launches through (K3: one a layout)
sort_kernel = SortKernel()
frames_sorted_kernel = FramesSortedKernel()
frames_sorted_global_kernel = FramesSortedKernel(glob=True)
unsort_kernel = UnsortKernel()


def frames_sorted_kernel_for(V: int, L: int) -> FramesSortedKernel:
    """K3's wrapper for a scene of V slots and L lanes, as
    ``straight_frames.frames_kernel_for`` picks K1's."""
    return globals()["frames_sorted_global_kernel" if straight_layout_for(V, L) == "global"
                     else "frames_sorted_kernel"]


def simulate_bm_sorted(env, veh: VehicleState, slot_actions: torch.Tensor,
                       frames: int, return_flags: bool = False):
    """Policy-step simulation on the s-sorted layout: the ego's action
    (a meta-action, or a ContinuousAction's stored controls, which the
    frames then keep), K2a, K3, K2b, then K1 on the envs whose band flags
    fired.  With ``return_flags`` also returns the (B, 2) flags (collision,
    neighbour) for diagnostics, as ``return_viol`` does in JAX."""
    veh = env.action_type.apply(env.geo, veh, veh.kind == KIND_EGO, slot_actions)
    fs, p, dt = env._straight, env.idm_params, env.dt
    raw, linear = env.action_type.stores_raw_controls, env.linear_rows
    V, L = veh.kind.shape[1], len(fs.offsets)
    srt, idx = sort_kernel(veh, fs)
    srt, flags = frames_sorted_kernel_for(V, L)(srt, idx, fs, p, dt, frames, raw=raw,
                                                linear=linear)
    out = unsort_kernel(srt, idx, veh)
    out = frames_kernel_for(V, L)(veh, fs, p, dt, frames, mask=flags.any(dim=1), out=out,
                                  raw=raw, linear=linear)
    return (out, flags) if return_flags else out
