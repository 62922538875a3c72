"""Direct tests of the polyeval compat surface (taylor_*/general_*).

The reference exposes taylor_{1,2,3}D (partially-baked coefficients: DOF
entries ARE derivative values, the 1/m! normalization lives in the
evaluator) and general_{1,2,3}D (plain polynomial coefficients) as public
evaluators (reference: wlsqm/fitter/polyeval.pyx).  The fit/interp tests
exercise these indirectly; here the two coefficient conventions are pinned
directly against closed-form polynomials, plus the batched
``interpolate_many`` wrapper.
"""

import numpy as np

import wlsqm_tpu as wt
from wlsqm_tpu.fitter import interp, polyeval

from conftest import quadratic_1d, quadratic_2d


def test_taylor_2d_reproduces_the_polynomial(rng):
    f, fi_deriv = quadratic_2d()        # derivative values at the origin
    x = rng.uniform(-2, 2, (32, 2))
    got = np.asarray(polyeval.taylor_2D(2, fi_deriv, np.zeros(2), x))
    np.testing.assert_allclose(got, f(x), rtol=0, atol=1e-12)


def test_general_2d_plain_coefficients(rng):
    f, _ = quadratic_2d()               # 1 + 2x + 3y + 4xy + 5x^2 + 6y^2
    plain = np.array([1.0, 2.0, 3.0, 5.0, 4.0, 6.0])   # F X Y X2 XY Y2
    x = rng.uniform(-2, 2, (32, 2))
    got = np.asarray(polyeval.general_2D(2, plain, np.zeros(2), x))
    np.testing.assert_allclose(got, f(x), rtol=0, atol=1e-12)


def test_taylor_general_1d(rng):
    f, fi_deriv = quadratic_1d()        # 1 + 2x + 3x^2 -> (1, 2, 6)
    x = rng.uniform(-2, 2, 17)
    got_t = np.asarray(polyeval.taylor_1D(2, fi_deriv, np.zeros(1), x))
    got_g = np.asarray(polyeval.general_1D(2, np.array([1.0, 2.0, 3.0]),
                                           np.zeros(1), x))
    np.testing.assert_allclose(got_t, f(x), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_g, f(x), rtol=0, atol=1e-12)


def test_taylor_general_3d_bake_factor(rng):
    """3D with a squared term: the 1/2! bake factor separates the modes."""
    def f(p):
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        return 1.0 + 2.0 * x - y + 3.0 * z + x * y + 2.0 * z**2

    NO = wt.number_of_dofs(3, 2)
    fi_deriv = np.zeros(NO)
    fi_deriv[[wt.i3_F, wt.i3_X, wt.i3_Y, wt.i3_Z]] = [1.0, 2.0, -1.0, 3.0]
    fi_deriv[wt.i3_XY] = 1.0            # d2f/dxdy
    fi_deriv[wt.i3_Z2] = 4.0            # d2f/dz2 = 2 * plain coefficient
    plain = fi_deriv.copy()
    plain[wt.i3_Z2] = 2.0

    x = rng.uniform(-1.5, 1.5, (24, 3))
    np.testing.assert_allclose(
        np.asarray(polyeval.taylor_3D(2, fi_deriv, np.zeros(3), x)),
        f(x), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(polyeval.general_3D(2, plain, np.zeros(3), x)),
        f(x), rtol=0, atol=1e-12)


def test_taylor_respects_nonzero_origin(rng):
    """Coefficients are derivatives AT xi; evaluation offsets by x - xi."""
    f, fi_deriv = quadratic_1d()
    # derivatives of 1 + 2x + 3x^2 at xi = 0.5: f=2.75, f'=5, f''=6
    xi = np.array([0.5])
    fi_at = np.array([2.75, 5.0, 6.0])
    x = rng.uniform(-2, 2, 9)
    got = np.asarray(polyeval.taylor_1D(2, fi_at, xi, x))
    np.testing.assert_allclose(got, f(x), rtol=0, atol=1e-12)


def test_interpolate_many_batches_per_case(rng):
    """interpolate_many: case b's model at x[b] == per-case eval_fit loop."""
    f, fi_deriv = quadratic_2d()
    B, M = 6, 5
    xi = rng.uniform(-1, 1, (B, 2))
    # derivative values of the same polynomial at each xi (via one fit)
    xk = xi[:, None, :] + rng.uniform(-0.4, 0.4, (B, 12, 2))
    res = wt.fit_many(xk, f(xk), xi, order=2, precision="f64")
    fi = np.asarray(res.fi)
    x = rng.uniform(-1, 1, (B, M, 2))
    got = np.asarray(interp.interpolate_many(fi, xi, x, dimension=2,
                                             order=2))
    assert got.shape == (B, M)
    np.testing.assert_allclose(got, f(x), rtol=0, atol=1e-9)
    # a derivative channel too
    gx = np.asarray(interp.interpolate_many(fi, xi, x, dimension=2, order=2,
                                            diff=wt.i2_X))
    want = 2.0 + 4.0 * x[..., 1] + 10.0 * x[..., 0]
    np.testing.assert_allclose(gx, want, rtol=0, atol=1e-8)
