"""Asymptotic convergence-order validation (the accuracy analysis, executable).

The reference documents (reference: doc/wlsqm_gen.pdf via README.md:226-231)
derive that an order-``q`` WLSQM fit of a smooth function recovers the
``d``-th derivative at the reference point with error O(h^(q+1-d)) as the
neighborhood radius ``h`` shrinks — one extra order over plain Taylor
truncation for the function value, and the classical least-squares rates for
the derivatives.  The reference ships this as a PDF; here it is a test: fit
the same *unit* neighbor cloud scaled by a geometric ladder of radii, measure
the DOF errors against analytic derivatives, and pin the log-log slope.

Using one fixed unit cloud scaled by ``h`` keeps the scaled-space Gram matrix
(and hence conditioning) EXACTLY constant across the ladder, so the measured
slope isolates the truncation term of the error model (docs/theory.md §7)
from the rounding terms.  The f64 engine path is used so the floor sits at
``eps * kappa * h^(-d)``, far below the truncation error over the tested
radii.
"""

import numpy as np
import pytest

import wlsqm_tpu as wt

# geometric radius ladder: large enough that truncation dominates rounding,
# small enough that the asymptotic regime is reached
HS = 0.5 * 2.0 ** -np.arange(5, dtype=np.float64)

# measured slopes sit within ~0.3 of the theoretical rate on these ladders;
# 0.6 of slack catches a lost order without flaking on preasymptotics
SLACK = 0.6

# errors below this are at the f64 rounding floor and no longer measure
# truncation; such points are excluded from the slope fit
FLOOR = 1e-12


def _unit_cloud(rng, K, dim):
    """K unit-scale neighbor offsets, bounded away from the origin."""
    u = rng.uniform(-1.0, 1.0, (K, dim))
    r = np.linalg.norm(u, axis=1, keepdims=True)
    # keep radii in [0.3, 1]: collapsing points would change conditioning
    u *= (0.3 + 0.7 * r / r.max()) / np.maximum(r, 1e-12)
    return u


def _slopes(errs, degrees):
    """Log-log slope of the max error per derivative degree.

    Per-DOF slopes are fragile — a single DOF whose leading truncation
    coefficient happens to vanish for the chosen function superconverges
    (or plateaus on its next term) — so the rate is asserted on the max
    error over each degree group, which tracks the dominant term.
    """
    degrees = np.asarray(degrees)
    out = {}
    for d in np.unique(degrees):
        e = errs[:, degrees == d].max(axis=1)
        keep = e > FLOOR
        if keep.sum() < 3:     # everything at the floor: infinitely fast
            out[int(d)] = np.inf
            continue
        out[int(d)] = np.polyfit(np.log(HS[keep]), np.log(e[keep]), 1)[0]
    return out


def _fit_ladder(f, xi, uk, order, dim):
    """Fit f on xi + h*uk for every h in HS; returns (len(HS), NO) DOFs."""
    B, K = len(HS), uk.shape[0]
    xk = xi[None, None, :] + HS[:, None, None] * uk[None, :, :]
    fk = f(xk)
    res = wt.fit_many(xk, fk, np.broadcast_to(xi, (B, dim)).copy(),
                      order=order, weighting=wt.WEIGHT_UNIFORM,
                      precision="f64")
    return np.asarray(res.fi)


def test_rates_2d_order2(rng):
    """Order-2 2D fit of sin(x)·e^(y/2): F at h³, gradient h², Hessian h¹."""
    xi = np.array([0.3, -0.2])

    def f(p):
        return np.sin(p[..., 0]) * np.exp(0.5 * p[..., 1])

    s, c, e = np.sin(xi[0]), np.cos(xi[0]), np.exp(0.5 * xi[1])
    truth = np.array([s * e, c * e, 0.5 * s * e,        # F, X, Y
                      -s * e, 0.5 * c * e, 0.25 * s * e])  # X2, XY, Y2
    fi = _fit_ladder(f, xi, _unit_cloud(rng, 40, 2), order=2, dim=2)
    slopes = _slopes(np.abs(fi - truth), [0, 1, 1, 2, 2, 2])
    assert all(slopes[d] >= (3 - d) - SLACK for d in slopes), slopes


def test_rates_2d_order3(rng):
    """Order-3 2D fit: one order higher across every derivative."""
    xi = np.array([0.3, -0.2])

    def f(p):
        return np.sin(p[..., 0]) * np.exp(0.5 * p[..., 1])

    s, c, e = np.sin(xi[0]), np.cos(xi[0]), np.exp(0.5 * xi[1])
    truth = np.array([s * e, c * e, 0.5 * s * e,
                      -s * e, 0.5 * c * e, 0.25 * s * e,
                      -c * e, -0.5 * s * e, 0.25 * c * e, 0.125 * s * e])
    fi = _fit_ladder(f, xi, _unit_cloud(rng, 60, 2), order=3, dim=2)
    slopes = _slopes(np.abs(fi - truth), [0, 1, 1, 2, 2, 2, 3, 3, 3, 3])
    assert all(slopes[d] >= (4 - d) - SLACK for d in slopes), slopes


def test_rates_1d_order3(rng):
    """Order-3 1D fit of sin: rates 4, 3, 2, 1 down the DOF vector."""
    xi = np.array([0.4])
    fi = _fit_ladder(lambda p: np.sin(p[..., 0]), xi,
                     _unit_cloud(rng, 20, 1), order=3, dim=1)
    s, c = np.sin(xi[0]), np.cos(xi[0])
    truth = np.array([s, c, -s, -c])
    slopes = _slopes(np.abs(fi - truth), [0, 1, 2, 3])
    assert all(slopes[d] >= (4 - d) - SLACK for d in slopes), slopes


def test_rates_3d_order2(rng):
    """Order-2 3D fit of sin(x)cos(y)e^(z/2): F h³, gradient h²."""
    xi = np.array([0.3, -0.2, 0.1])

    def f(p):
        return np.sin(p[..., 0]) * np.cos(p[..., 1]) * np.exp(0.5 * p[..., 2])

    sx, cx = np.sin(xi[0]), np.cos(xi[0])
    sy, cy = np.sin(xi[1]), np.cos(xi[1])
    e = np.exp(0.5 * xi[2])
    truth_grad = np.array([sx * cy * e,                       # F
                           cx * cy * e, -sx * sy * e, 0.5 * sx * cy * e])
    fi = _fit_ladder(f, xi, _unit_cloud(rng, 60, 3), order=2, dim=3)
    slopes = _slopes(np.abs(fi[:, :4] - truth_grad), [0, 1, 1, 1])
    assert all(slopes[d] >= (3 - d) - SLACK for d in slopes), slopes


@pytest.mark.parametrize("order", [2, 3])
def test_center_weighting_preserves_rates(rng, order):
    """WEIGHT_CENTER changes constants, not asymptotic orders."""
    xi = np.array([0.3, -0.2])

    def f(p):
        return np.sin(p[..., 0]) * np.exp(0.5 * p[..., 1])

    uk = _unit_cloud(rng, 50, 2)
    B = len(HS)
    xk = xi[None, None, :] + HS[:, None, None] * uk[None, :, :]
    res = wt.fit_many(xk, f(xk), np.broadcast_to(xi, (B, 2)).copy(),
                      order=order, weighting=wt.WEIGHT_CENTER,
                      precision="f64")
    s, c, e = np.sin(xi[0]), np.cos(xi[0]), np.exp(0.5 * xi[1])
    truth = np.array([s * e, c * e, 0.5 * s * e])
    slopes = _slopes(np.abs(np.asarray(res.fi)[:, :3] - truth), [0, 1, 1])
    assert all(slopes[d] >= (order + 1 - d) - SLACK for d in slopes), slopes
