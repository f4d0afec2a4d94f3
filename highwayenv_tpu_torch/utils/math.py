"""Elementwise geometry helpers on float32 tensors.

PyTorch counterparts of ``highwayenv_tpu/utils/math.py``: every function
broadcasts over leading batch dimensions.  Only the helpers the port's
paths need are here.
"""

from __future__ import annotations

import math

import torch


def wrap_to_pi(x: torch.Tensor) -> torch.Tensor:
    """Wrap angles to [-pi, pi) (``((x + pi) mod 2 pi) - pi``, floored mod)."""
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


def lmap(v, x, y):
    """Linear map of value v from range x=[x0,x1] to range y=[y0,y1]."""
    return y[0] + (v - x[0]) * (y[1] - y[0]) / (x[1] - x[0])


def not_zero(x: torch.Tensor, eps: float = 1e-2) -> torch.Tensor:
    """Replace near-zero values with +/-eps, keeping the sign (0 -> +eps)."""
    return torch.where(
        x.abs() > eps,
        x,
        torch.where(x >= 0, torch.full_like(x, eps), torch.full_like(x, -eps)),
    )


def do_every(duration: float, timer: torch.Tensor) -> torch.Tensor:
    return duration < timer


def rects_intersecting(
    center_a, length_a, width_a, angle_a,
    center_b, length_b, width_b, angle_b,
    displacement_a=None, displacement_b=None,
):
    """Separating-axis test between two rotated rectangles with a velocity
    sweep (reference ``utils.are_polygons_intersecting`` on rectangles).

    ``center_*``/``displacement_*`` are (..., 2); the rest (...,).  Returns
    (intersecting, will_intersect, translation (..., 2)); translation is the
    minimum-translation vector, valid where will_intersect holds.
    """
    if displacement_a is None:
        displacement_a = torch.zeros_like(center_a)
    if displacement_b is None:
        displacement_b = torch.zeros_like(center_b)
    inter, will, tx, ty = rects_intersecting_xy_folded(
        center_a[..., 0], center_a[..., 1], length_a, width_a, angle_a,
        center_b[..., 0], center_b[..., 1], length_b, width_b, angle_b,
        displacement_a[..., 0] - displacement_b[..., 0],
        displacement_a[..., 1] - displacement_b[..., 1],
    )
    return inter, will, torch.stack([tx, ty], dim=-1)


def rects_intersecting_xy_folded(
    dax, day, length_a, width_a, angle_a,
    dbx, dby, length_b, width_b, angle_b,
    relx=None, rely=None,
):
    """Rectangle SAT over the 4 unique edge axes with the reference's 8
    signed minimum-translation candidates, component-wise.

    The +/- version of an axis share every projection and overlap test;
    only the signed swept depth differs, and both depths are the same two
    interval gaps under mirrored selection.  The candidates are scanned in
    the reference's winding order (rect A: -len, +wid, +len, -wid, then
    rect B) with a strict ``<`` so the first minimum wins.  ``relx/rely``
    is the displacement of a relative to b over the frame.  Returns
    (intersecting, will_intersect, tx, ty).  The CUDA frame kernel
    (csrc/straight_frames.cu, ``sat``) repeats this arithmetic in the same
    order.
    """
    if relx is None:
        relx = torch.zeros_like(dax)
    if rely is None:
        rely = torch.zeros_like(day)

    ca, sa = torch.cos(angle_a), torch.sin(angle_a)
    cb, sb = torch.cos(angle_b), torch.sin(angle_b)
    norm_a = ca * ca + sa * sa
    norm_b = cb * cb + sb * sb
    adcc = (ca * cb + sa * sb).abs()
    adcs = (ca * sb - sa * cb).abs()
    ha_l, ha_w = length_a / 2, width_a / 2
    hb_l, hb_w = length_b / 2, width_b / 2

    # (cp_a, cp_b, vp, ext_a, ext_b) for the listed (negative) version of
    # each unique axis
    axes = [
        (-(ca * dax + sa * day), -(ca * dbx + sa * dby),
         -(ca * relx + sa * rely),
         ha_l * norm_a, hb_l * adcc + hb_w * adcs),
        (ca * day - sa * dax, ca * dby - sa * dbx,
         ca * rely - sa * relx,
         ha_w * norm_a, hb_l * adcs + hb_w * adcc),
        (-(cb * dax + sb * day), -(cb * dbx + sb * dby),
         -(cb * relx + sb * rely),
         ha_l * adcc + ha_w * adcs, hb_l * norm_b),
        (cb * day - sb * dax, cb * dby - sb * dbx,
         cb * rely - sb * relx,
         ha_l * adcs + ha_w * adcc, hb_w * norm_b),
    ]

    intersecting = None
    will_intersect = None
    neg_d, pos_d = [], []
    for cp_a, cp_b, vp, ext_a, ext_b in axes:
        min_a, max_a = cp_a - ext_a, cp_a + ext_a
        min_b, max_b = cp_b - ext_b, cp_b + ext_b
        now_ok = (min_b - max_a <= 0) & (min_a - max_b <= 0)
        intersecting = now_ok if intersecting is None else intersecting & now_ok
        as_lo = min_a + torch.clamp(vp, max=0.0)
        as_hi = max_a + torch.clamp(vp, min=0.0)
        v1 = min_b - as_hi
        v2 = as_lo - max_b
        swept_ok = (v1 <= 0) & (v2 <= 0)
        will_intersect = (
            swept_ok if will_intersect is None else will_intersect & swept_ok
        )
        neg_d.append(torch.where(as_lo < min_b, v1, v2))
        pos_d.append(torch.where(max_b < as_hi, v2, v1))

    candidates = [
        (neg_d[0], -ca, -sa), (neg_d[1], -sa, ca),
        (pos_d[0], ca, sa), (pos_d[1], sa, -ca),
        (neg_d[2], -cb, -sb), (neg_d[3], -sb, cb),
        (pos_d[2], cb, sb), (pos_d[3], sb, -cb),
    ]
    min_dist = best_ax = best_ay = None
    for d_swept, ax, ay in candidates:
        ad = d_swept.abs()
        if min_dist is None:
            min_dist, best_ax, best_ay = ad, ax, ay
        else:
            better = ad < min_dist  # strict: first minimum wins
            min_dist = torch.where(better, ad, min_dist)
            best_ax = torch.where(better, ax, best_ax)
            best_ay = torch.where(better, ay, best_ay)

    # orient from b towards a
    dcx = dax - dbx
    dcy = day - dby
    sign = torch.where(dcx * best_ax + dcy * best_ay > 0, 1.0, -1.0)
    return (
        intersecting,
        will_intersect,
        min_dist * sign * best_ax,
        min_dist * sign * best_ay,
    )


def rect_corners(center, length, width, angle):
    """Corners of rotated rectangles: ``center`` (..., 2), the rest (...,);
    (..., 4, 2) in the reference polygon's order, the (-l, -w), (-l, +w),
    (+l, +w), (+l, -w) half extents."""
    hl = length[..., None] / 2.0
    hw = width[..., None] / 2.0
    lx = torch.cat([-hl, -hl, hl, hl], dim=-1)
    ly = torch.cat([-hw, hw, hw, -hw], dim=-1)
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    return center[..., None, :] + torch.stack([c * lx - s * ly, s * lx + c * ly], dim=-1)
