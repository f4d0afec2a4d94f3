"""Interval arithmetic and LPV interval predictors.

PyTorch counterpart of ``highwayenv_tpu/ops/interval.py`` (reference
highway_env/interval.py: interval products and scalings, the integrator
interval, vector sections, local <-> absolute boxes, matrix polytopes, the
Metzler test and the LPV predictors).  Two layers:

- the batched core (``box_*``, ``LPVParams``, ``lpv_step``) in torch on
  interval boxes shaped ``(..., 2, N)`` with any leading batch dims, on the
  device of the tensors it is given.  A matrix-vector product is written out
  as a sum over its (2 to 4) columns, left to right, so that it adds its
  terms in the same order on every device and never meets TF32;
- the host helpers and the stateful ``LPV`` in float64 numpy, as the JAX
  package keeps them.  Where the JAX package's host code goes through its
  float32 device ops (``integrator_interval``, ``vector_interval_section``,
  the local <-> absolute boxes, and ``LPV``'s float32 ``LPVParams``, whose
  ``da_pos`` / ``da_neg`` its float64 ``step`` reads back), the port rounds
  through float32 at the same places, so that both give the same floats.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Sequence

import numpy as np
import torch

from highwayenv_tpu_torch.road import lane as lane_ops

F32 = torch.float32


# --------------------------------------------------------------------------- #
# the batched core: interval boxes (..., 2, N)
# --------------------------------------------------------------------------- #
def _split(m: torch.Tensor):
    """(positive part, negative part) of a tensor: m = p - n, p, n >= 0."""
    return m.clamp(min=0), (-m).clamp(min=0)


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m (..., N, K) times v (..., K) -> (..., N), the K products summed
    left to right."""
    out = m[..., 0] * v[..., None, 0]
    for k in range(1, m.shape[-1]):
        out = out + m[..., k] * v[..., None, k]
    return out


def box_scale(m: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Interval of a known matrix m (..., N, K) times a box b (..., 2, K)."""
    mp, mn = _split(m)
    lo = _mv(mp, b[..., 0, :]) - _mv(mn, b[..., 1, :])
    hi = _mv(mp, b[..., 1, :]) - _mv(mn, b[..., 0, :])
    return torch.stack([lo, hi], dim=-2)


def box_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Interval difference a - b of boxes (..., 2, N)."""
    return torch.stack([a[..., 0, :] - b[..., 1, :], a[..., 1, :] - b[..., 0, :]], dim=-2)


def box_negative_part(a: torch.Tensor) -> torch.Tensor:
    return a.clamp(max=0)


def box_integrator(x, k) -> torch.Tensor:
    """Interval of dx = -k x for a positive gain interval k (..., 2), in
    float32, over the sign cases of the interval x (..., 2)."""
    x = torch.as_tensor(x).to(F32)
    k = torch.as_tensor(k).to(F32)
    gain_pos = torch.stack([-k[..., 1], -k[..., 0]], dim=-1)  # x >= 0
    gain_neg = -k  # x <= 0
    gain_mix = torch.stack([-k[..., 0], -k[..., 0]], dim=-1)
    nonneg = (x[..., 0] >= 0)[..., None]
    nonpos = (x[..., 1] <= 0)[..., None]
    gain = torch.where(nonneg, gain_pos, torch.where(nonpos, gain_neg, gain_mix))
    return gain * x


def box_section(v_box: torch.Tensor, direction) -> torch.Tensor:
    """Interval (..., 2) of <v, direction> over a 2-D box (..., 2, 2)."""
    lo, hi = v_box[..., 0, :], v_box[..., 1, :]
    d = torch.as_tensor(direction, dtype=v_box.dtype, device=v_box.device)
    term_lo = torch.minimum(lo * d, hi * d)
    term_hi = torch.maximum(lo * d, hi * d)
    return torch.stack([term_lo[..., 0] + term_lo[..., 1],
                        term_hi[..., 0] + term_hi[..., 1]], dim=-1)


def box_corners2(box: torch.Tensor) -> torch.Tensor:
    """The 4 corners (..., 4, 2) of a 2-D box (..., 2, 2)."""
    lo, hi = box[..., 0, :], box[..., 1, :]
    return torch.stack([
        torch.stack([lo[..., 0], lo[..., 1]], dim=-1),
        torch.stack([lo[..., 0], hi[..., 1]], dim=-1),
        torch.stack([hi[..., 0], lo[..., 1]], dim=-1),
        torch.stack([hi[..., 0], hi[..., 1]], dim=-1),
    ], dim=-2)


def box_absolute_to_local(geo, lane: torch.Tensor, box: torch.Tensor):
    """An absolute position box (..., 2, 2) as (s, lat) intervals (..., 2)
    on ``lane`` (...,)."""
    s, lat = lane_ops.local_coordinates(geo, lane[..., None], box_corners2(box))
    return (torch.stack([s.amin(-1), s.amax(-1)], dim=-1),
            torch.stack([lat.amin(-1), lat.amax(-1)], dim=-1))


def box_local_to_absolute(geo, lane: torch.Tensor, s_i: torch.Tensor,
                          lat_i: torch.Tensor) -> torch.Tensor:
    """(s, lat) intervals (..., 2) on ``lane`` as an absolute position box
    (..., 2, 2)."""
    s_c = torch.stack([s_i[..., 0], s_i[..., 0], s_i[..., 1], s_i[..., 1]], dim=-1)
    l_c = torch.stack([lat_i[..., 0], lat_i[..., 1], lat_i[..., 0], lat_i[..., 1]], dim=-1)
    pos = lane_ops.position(geo, lane[..., None], s_c, l_c)  # (..., 4, 2)
    return torch.stack([pos.amin(-2), pos.amax(-2)], dim=-2)


# --------------------------------------------------------------------------- #
# the LPV system and its step
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class LPVParams:
    """The fixed data of dx = (a0 + sum da)(x - center) + b u + d w, in
    predictor coordinates: ``da_pos`` / ``da_neg`` are the sums of the
    polytope vertices' positive and negative parts; ``metzler`` picks the
    tight predictor."""

    a0: torch.Tensor  # (N, N)
    da_pos: torch.Tensor  # (N, N)
    da_neg: torch.Tensor  # (N, N)
    b: torch.Tensor  # (N, U)
    d: torch.Tensor  # (N, W)
    metzler: bool = True

    def to(self, device) -> "LPVParams":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "metzler"})


def lpv_step(p: LPVParams, x_i: torch.Tensor, u: torch.Tensor,
             omega_i: torch.Tensor, dt: float) -> torch.Tensor:
    """One interval-predictor step over any leading batch dims: x_i
    (..., 2, N) the interval state, u (..., U) the control, omega_i
    (..., 2, W) the disturbance box.  A Metzler system takes the tight
    cooperative predictor, any other the naive product bound."""
    x_m, x_M = x_i[..., 0, :], x_i[..., 1, :]
    o_m, o_M = omega_i[..., 0, :], omega_i[..., 1, :]
    dp, dn = _split(p.d)
    bu = _mv(p.b, u)
    if p.metzler:
        xmp, xmn = _split(x_m)
        xMp, xMn = _split(x_M)
        dx_m = (_mv(p.a0, x_m) - _mv(p.da_pos, xmn) - _mv(p.da_neg, xMp)
                + _mv(dp, o_m) - _mv(dn, o_M) + bu)
        dx_M = (_mv(p.a0, x_M) + _mv(p.da_pos, xMp) + _mv(p.da_neg, xmn)
                + _mv(dp, o_M) - _mv(dn, o_m) + bu)
    else:
        # a_i = a0 + sum([0, 1] da) = [a0 - da_neg, a0 + da_pos]
        a_box = torch.stack([p.a0 - p.da_neg, p.a0 + p.da_pos], dim=-3)
        prod = _box_mat_vec(a_box, torch.stack([x_m, x_M], dim=-2))
        dwo = box_scale(p.d, torch.stack([o_m, o_M], dim=-2))
        dx_m = prod[..., 0, :] + dwo[..., 0, :] + bu
        dx_M = prod[..., 1, :] + dwo[..., 1, :] + bu
    return x_i + torch.stack([dx_m, dx_M], dim=-2) * dt


def _box_mat_vec(a_box: torch.Tensor, x_box: torch.Tensor) -> torch.Tensor:
    """Interval matrix (..., 2, N, N) times interval vector (..., 2, N)."""
    alp, aln = _split(a_box[..., 0, :, :])
    ahp, ahn = _split(a_box[..., 1, :, :])
    xlp, xln = _split(x_box[..., 0, :])
    xhp, xhn = _split(x_box[..., 1, :])
    lo = _mv(alp, xlp) - _mv(ahp, xln) - _mv(aln, xhp) + _mv(ahn, xhn)
    hi = _mv(ahp, xhp) - _mv(alp, xhn) - _mv(ahn, xlp) + _mv(aln, xln)
    return torch.stack([lo, hi], dim=-2)


def lpv_step_batch(p: LPVParams, x_i, u, omega_i, dt) -> torch.Tensor:
    """The predictor of a fleet: x_i (B, 2, N), u (B, U), omega_i (B, 2, W)
    in one batched call (``lpv_step`` itself is batched)."""
    return lpv_step(p, x_i, u, omega_i, dt)


# --------------------------------------------------------------------------- #
# host helpers (float64 numpy, reference-shaped (2, ...) intervals)
# --------------------------------------------------------------------------- #
def _pos(x):
    return np.maximum(x, 0)


def _neg(x):
    return np.maximum(-x, 0)


def intervals_product(a, b) -> np.ndarray:
    """Interval of the product ab of two (2, ...) intervals."""
    a, b = np.asarray(a), np.asarray(b)
    # np.dot, not @: operands may be 0-d
    return np.array([
        np.dot(_pos(a[0]), _pos(b[0])) - np.dot(_pos(a[1]), _neg(b[0]))
        - np.dot(_neg(a[0]), _pos(b[1])) + np.dot(_neg(a[1]), _neg(b[1])),
        np.dot(_pos(a[1]), _pos(b[1])) - np.dot(_pos(a[0]), _neg(b[1]))
        - np.dot(_neg(a[1]), _pos(b[0])) + np.dot(_neg(a[0]), _neg(b[0])),
    ])


def intervals_scaling(a, b) -> np.ndarray:
    """Interval of a known a times an interval b."""
    a, b = np.asarray(a), np.asarray(b)
    return np.array([np.dot(_pos(a), b[0]) - np.dot(_neg(a), b[1]),
                     np.dot(_pos(a), b[1]) - np.dot(_neg(a), b[0])])


def intervals_diff(a, b) -> np.ndarray:
    a, b = np.asarray(a), np.asarray(b)
    return np.array([a[0] - b[1], a[1] - b[0]])


def interval_negative_part(a) -> np.ndarray:
    return np.minimum(np.asarray(a), 0)


def integrator_interval(x, k) -> np.ndarray:
    """``box_integrator`` on the CPU: float32, as the JAX package's."""
    return box_integrator(torch.from_numpy(np.asarray(x, float)),
                          torch.from_numpy(np.asarray(k, float))).numpy()


def vector_interval_section(v_i, direction) -> np.ndarray:
    """``box_section`` on the CPU: float32, as the JAX package's."""
    box = torch.from_numpy(np.asarray(v_i, float)).to(F32)
    return box_section(box, torch.from_numpy(np.asarray(direction, float)).to(F32)).numpy()


def _geo_tensor(geo, value, dtype=F32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(value), device=geo.kind.device).to(dtype)


def interval_absolute_to_local(position_i, geo, lane: int):
    """(s, lat) intervals of an absolute box on ``lane``, float32 lane ops
    on the tables' device."""
    s_i, lat_i = box_absolute_to_local(geo, _geo_tensor(geo, lane, torch.int32),
                                       _geo_tensor(geo, position_i))
    return s_i.cpu().numpy(), lat_i.cpu().numpy()


def interval_local_to_absolute(longitudinal_i, lateral_i, geo, lane: int) -> np.ndarray:
    """The absolute box of (s, lat) intervals on ``lane``, float32 lane ops
    on the tables' device."""
    return box_local_to_absolute(
        geo, _geo_tensor(geo, lane, torch.int32), _geo_tensor(geo, longitudinal_i),
        _geo_tensor(geo, lateral_i)).cpu().numpy()


def polytope(parametrized_f: Callable[[np.ndarray], np.ndarray], params_intervals):
    """Matrix polytope (a0, [da ...]) of a parametrized matrix over a box."""
    params_intervals = np.asarray(params_intervals)
    params_means = params_intervals.mean(axis=0)
    a0 = parametrized_f(params_means)
    d_a = []
    for vertex_id in itertools.product([0, 1], repeat=params_intervals.shape[1]):
        params_vertex = params_intervals[vertex_id, np.arange(len(vertex_id))]
        d_a.append(parametrized_f(params_vertex) - a0)
    d_a = list({str(m): m for m in d_a}.values())
    return a0, d_a


def is_metzler(matrix, eps: float = 1e-9) -> bool:
    matrix = np.asarray(matrix)
    return bool((matrix - np.diag(np.diag(matrix)) >= -eps).all())


class LPV:
    """A linear parameter-varying system with its interval predictor
    (reference ``interval.LPV``): float64 on the host, and its float32
    ``params`` for ``lpv_step`` on a batch."""

    def __init__(self, x0, a0, da: Sequence, b=None, d=None, omega_i=None,
                 u=None, k=None, center=None, x_i=None):
        self.x0 = np.array(x0, dtype=float)
        a0 = np.array(a0, dtype=float)
        da = [np.array(m, dtype=float) for m in da]
        self.b = np.array(b, dtype=float) if b is not None else np.zeros((*self.x0.shape, 1))
        self.d = np.array(d, dtype=float) if d is not None else np.zeros((*self.x0.shape, 1))
        self.omega_i = (np.array(omega_i, dtype=float) if omega_i is not None
                        else np.zeros((2, 1)))
        self.u = np.array(u, dtype=float) if u is not None else np.zeros((1,))
        self.k = (np.array(k, dtype=float) if k is not None
                  else np.zeros((self.b.shape[1], self.b.shape[0])))
        self.center = (np.array(center, dtype=float) if center is not None
                       else np.zeros(self.x0.shape))
        a0 = a0 + self.b @ self.k  # closed loop
        self.x_t = self.x0
        self.x_i = (np.array(x_i, dtype=float) if x_i is not None
                    else np.array([self.x0, self.x0]))

        # the predictor's coordinates: the identity if a0 is Metzler, else
        # its real eigenbasis where there is one
        self.coordinates = None
        if is_metzler(a0):
            eye = np.eye(a0.shape[0])
            self.coordinates = (eye, eye)
        else:
            eig_v, tr = np.linalg.eig(a0)
            if np.isreal(eig_v).all():
                try:
                    self.coordinates = (tr, np.linalg.inv(tr))
                except np.linalg.LinAlgError:
                    pass
        self.a0 = self.change_coordinates(a0, matrix=True)
        self.da = self.change_coordinates(da, matrix=True)
        self.b = self.change_coordinates(self.b, offset=False)
        self.x_i_t = np.array(self.change_coordinates([x for x in self.x_i]))

        def f32(m):
            return torch.from_numpy(np.asarray(m, float)).to(F32)

        self._params = LPVParams(
            a0=f32(self.a0),
            da_pos=f32(sum(_pos(m) for m in self.da)),
            da_neg=f32(sum(_neg(m) for m in self.da)),
            b=f32(self.b), d=f32(self.d), metzler=is_metzler(self.a0),
        )

    def set_control(self, control, state=None) -> None:
        if state is not None:
            control = control - self.k @ state
        self.u = np.asarray(control, dtype=float)

    def change_coordinates(self, value, matrix=False, back=False, interval=False,
                           offset=True):
        """Map values between world and predictor coordinates."""
        if self.coordinates is None:
            return value
        tr, tr_inv = self.coordinates
        if interval:
            if back:
                return intervals_scaling(tr, value[:, :, np.newaxis]).squeeze() + (
                    offset * np.array([self.center, self.center]))
            value = value - offset * np.array([self.center, self.center])
            return intervals_scaling(tr_inv, value[:, :, np.newaxis]).squeeze()
        if matrix:
            if isinstance(value, list):
                return [self.change_coordinates(m, matrix=True, back=back) for m in value]
            return tr @ value @ tr_inv if back else tr_inv @ value @ tr
        if isinstance(value, list):
            return [self.change_coordinates(v, back=back) for v in value]
        if back:
            value = tr @ value
            return value + self.center if offset else value
        if offset:
            value = value - self.center
        return tr_inv @ value

    def step(self, dt: float) -> None:
        """One float64 step of the predictor and of the nominal state; the
        vertex sums come from the float32 ``params``, as in the JAX
        package."""
        u = np.atleast_1d(np.squeeze(np.asarray(self.u, dtype=float)))
        da_p = self._params.da_pos.numpy().astype(float)
        da_n = self._params.da_neg.numpy().astype(float)
        d = self.d
        x_m, x_M = self.x_i_t[0], self.x_i_t[1]
        o_m, o_M = self.omega_i[0], self.omega_i[1]
        bu = self.b @ u
        if self._params.metzler:
            dx_m = (self.a0 @ x_m - da_p @ _neg(x_m) - da_n @ _pos(x_M)
                    + _pos(d) @ o_m - _neg(d) @ o_M + bu)
            dx_M = (self.a0 @ x_M + da_p @ _pos(x_M) + da_n @ _neg(x_m)
                    + _pos(d) @ o_M - _neg(d) @ o_m + bu)
            self.x_i_t = self.x_i_t + np.array([dx_m, dx_M]) * dt
        else:
            a_i = np.array([self.a0 - da_n, self.a0 + da_p])
            dx_i = (intervals_product(a_i, self.x_i_t)
                    + intervals_product(np.array([d, d]), self.omega_i)
                    + np.array([bu, bu]))
            self.x_i_t = self.x_i_t + dx_i * dt
        dx = self.a0 @ self.x_t + bu
        self.x_t = self.x_t + dx * dt

    @property
    def params(self) -> LPVParams:
        """The float32 ``LPVParams`` (CPU) of ``lpv_step``."""
        return self._params
