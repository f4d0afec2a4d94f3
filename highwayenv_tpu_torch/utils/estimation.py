"""Confidence-region parameter estimation, on the host in float64 numpy.

The port's copy of ``highwayenv_tpu/utils/estimation.py`` (reference
highway_env/utils.py ``confidence_ellipsoid``, ``confidence_polytope``,
``is_valid_observation``, ``is_consistent_dataset``, ``solve_trinom``,
``distance_to_circle``), with the same numpy operations in the same order,
so that both give the same floats.  The robust-control tools of
``ops/uncertainty.py`` call it between steps on data read from the state.

The polytope's radius matrix is the reference's
``sqrt(beta) * inv(pp) @ diag(sqrt(1 / w))`` from ``np.linalg.eig``: its
vertex set changes when the eigenpairs are reordered or their signs flip, so
a rewrite with ``eigh`` (or ``torch.linalg.eig``) gives another polytope.
"""

from __future__ import annotations

import numpy as np


def _design(data: dict) -> tuple[np.ndarray, np.ndarray]:
    return np.asarray(data["features"]), np.asarray(data["outputs"])


def confidence_ellipsoid(data: dict, lambda_: float = 1e-5, delta: float = 0.1,
                         sigma: float = 0.1, param_bound: float = 1.0):
    """Regularized least squares with a self-normalized confidence radius:
    ``(theta, gramian, beta)`` such that with probability 1 - delta the
    true parameter lies in ``{t : |t - theta|_gramian <= beta}``."""
    phi, y = _design(data)
    d = phi.shape[-1]
    gramian = phi.T @ phi / sigma + lambda_ * np.eye(d)
    theta = np.linalg.solve(gramian, phi.T @ y) / sigma
    _, logdet = np.linalg.slogdet(gramian)
    beta = (
        np.sqrt(2.0 * (0.5 * (logdet - d * np.log(lambda_)) - np.log(delta)))
        + np.sqrt(lambda_ * d) * param_bound
    )
    return theta, gramian, beta


def confidence_polytope(data: dict, parameter_box):
    """The 2^d vertices of the confidence ellipsoid's radius fan, clipped to
    the prior box: ``(theta, d_theta, gramian, beta)``, ``d_theta`` (2^d, d)
    in the order of ``itertools.product([-1, 1], repeat=d)``."""
    box = np.asarray(parameter_box, dtype=float)
    theta, gramian, beta = confidence_ellipsoid(
        data, param_bound=float(np.max(np.abs(box)))
    )
    w, pp = np.linalg.eig(gramian)
    radius = np.sqrt(beta) * np.linalg.inv(pp) @ np.diag(np.sqrt(1.0 / w))
    d = theta.shape[0]
    bits = (np.arange(2**d)[:, None] >> np.arange(d - 1, -1, -1)) & 1
    signs = 2.0 * bits - 1.0
    d_theta = signs @ radius.T  # row k = radius @ signs[k]

    theta = np.clip(theta, box[0], box[1])
    d_theta = np.clip(d_theta, box[0] - theta, box[1] - theta)
    return theta, d_theta, gramian, beta


def is_valid_observation(y, phi, theta, gramian, beta, sigma: float = 0.1) -> bool:
    """Whether one observation's residual stays within the worst parameter
    error amplified through phi, plus the noise."""
    phi = np.asarray(phi)
    residual = np.linalg.norm(np.asarray(y) - np.tensordot(theta, phi, [0, 0]))
    phi_gain = np.linalg.eigvalsh(phi.T @ phi)[-1]
    g_floor = np.linalg.eigvalsh(gramian)[0]
    return bool(residual < np.sqrt(phi_gain / g_floor) * beta + sigma)


def is_consistent_dataset(data: dict, parameter_box=None) -> bool:
    """Leave-last-out consistency: fit on all but the newest sample and test
    the newest against the fitted region.  The caller's lists stay as they
    are."""
    feats, outs = data["features"], data["outputs"]
    if len(feats) < 2 or len(outs) < 2:
        return True
    train = {"features": feats[:-1], "outputs": outs[:-1]}
    y = np.asarray(outs[-1])[..., None]
    phi = np.asarray(feats[-1])[..., None]
    theta, _, gramian, beta = confidence_polytope(train, parameter_box)
    return is_valid_observation(y, phi, theta, gramian, beta)


def solve_trinom(a, b, c):
    """Real roots of ``a x^2 + b x + c`` in ascending order, or
    ``(None, None)``."""
    disc = b * b - 4.0 * a * c
    if disc < 0:
        return None, None
    sq = np.sqrt(disc)
    return (-b - sq) / (2.0 * a), (-b + sq) / (2.0 * a)


def distance_to_circle(center, radius, direction):
    """Distance along ``direction`` from the origin to a circle, 0 from
    inside it, +inf on a miss."""
    center = np.asarray(center, float).reshape(-1)
    direction = np.asarray(direction, float).reshape(-1)
    u = direction / radius
    p = center / radius
    near, far = solve_trinom(u @ u, -2.0 * (p @ u), p @ p - 1.0)
    if near and near > 0:
        return near
    if far and far > 0:
        return 0
    return np.inf
