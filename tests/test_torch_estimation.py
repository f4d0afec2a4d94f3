"""The port's confidence-region estimation (``utils/estimation.py``) against
the JAX package's (``highwayenv_tpu/utils/estimation.py``), on the CPU.

Both are float64 numpy with the same operations in the same order, so each
of the six functions agrees within 1e-12 relative at five seeds, and the
confidence polytope's vertex set is equal as a set (it rests on
``np.linalg.eig``'s eigenpair order and signs).
"""

import numpy as np
import pytest
import torch

from highwayenv_tpu.utils import estimation as j_est
from highwayenv_tpu_torch.utils import estimation as t_est

torch.set_num_threads(1)

SEEDS = [0, 1, 2, 3, 4]
RTOL = 1e-12


def _dataset(rng, n=40, d=3):
    theta_true = rng.uniform(-1, 1, size=(d,))
    phi = rng.normal(size=(n, d))
    y = phi @ theta_true + 0.05 * rng.normal(size=(n,))
    return {"features": list(phi), "outputs": list(y)}


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float), rtol=RTOL,
                               atol=RTOL * max(1.0, float(np.abs(b).max())))


@pytest.mark.parametrize("seed", SEEDS)
def test_confidence_ellipsoid_matches_jax(seed):
    data = _dataset(np.random.default_rng(seed))
    for got, want in zip(t_est.confidence_ellipsoid(data), j_est.confidence_ellipsoid(data)):
        _close(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_confidence_polytope_vertex_set_matches_jax(seed):
    rng = np.random.default_rng(seed)
    d = 2 + seed % 2
    data = _dataset(rng, d=d)
    box = np.array([[-1.5] * d, [1.5] * d])
    got = t_est.confidence_polytope(data, box)
    want = j_est.confidence_polytope(data, box)
    for a, b in zip(got, want):
        _close(a, b)
    assert got[1].shape == (2**d, d)
    # the vertex set, as a set of rows rounded far below the tolerance
    key = lambda v: {tuple(np.round(r, 9)) for r in v}  # noqa: E731
    assert key(got[1]) == key(want[1])


@pytest.mark.parametrize("seed", SEEDS)
def test_observation_validity_and_consistency_match_jax(seed):
    rng = np.random.default_rng(seed)
    data = _dataset(rng, n=12, d=2)
    box = np.array([[-2.0, -2.0], [2.0, 2.0]])
    theta, _, gramian, beta = t_est.confidence_polytope(data, box)
    for k in range(6):
        phi = rng.normal(size=(2, 1))
        y = rng.normal(size=(1,)) * (0.1 if k % 2 else 5.0)
        assert (t_est.is_valid_observation(y, phi, theta, gramian, beta)
                == j_est.is_valid_observation(y, phi, theta, gramian, beta))
    outs = []
    for bad in (False, True):
        d = {"features": list(data["features"]), "outputs": list(data["outputs"])}
        if bad:
            d["outputs"][-1] = d["outputs"][-1] + 50.0
        got = t_est.is_consistent_dataset(d, box)
        assert got == j_est.is_consistent_dataset(d, box)
        outs.append(got)
    assert outs[1] is False  # the outlier is caught
    # fewer than two samples: consistent
    one = {"features": data["features"][:1], "outputs": data["outputs"][:1]}
    assert t_est.is_consistent_dataset(one, box) is True


@pytest.mark.parametrize("seed", SEEDS)
def test_trinom_and_distance_to_circle_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        a, b, c = rng.normal(size=3)
        got, want = t_est.solve_trinom(a, b, c), j_est.solve_trinom(a, b, c)
        assert (got[0] is None) == (want[0] is None)
        if got[0] is not None:
            _close(got, want)
        center, radius, direction = rng.normal(size=2) * 5, rng.uniform(0.5, 3), rng.normal(size=2)
        dg = t_est.distance_to_circle(center, radius, direction)
        dw = j_est.distance_to_circle(center, radius, direction)
        assert dg == dw or abs(dg - dw) <= RTOL * abs(dw)
    # inside the circle: 0; a miss: inf
    assert t_est.distance_to_circle([0.0, 0.0], 2.0, [1.0, 0.0]) == 0
    assert t_est.distance_to_circle([0.0, 10.0], 1.0, [1.0, 0.0]) == np.inf
