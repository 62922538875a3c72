"""Edge cases: boundary orders, minimum neighbor counts, knowns preservation."""

import numpy as np
import pytest

import wlsqm_tpu as wt


def test_order0_is_weighted_mean(rng):
    """Order 0's single DOF solves min_F sum_k (F - fk)^2 -> the mean."""
    xk = rng.uniform(-1, 1, (20, 2))
    fk = rng.standard_normal(20)
    fi = np.zeros(wt.number_of_dofs(2, 0))
    assert fi.shape == (1,)
    wt.fit_2D(xk=xk, fk=fk, xi=np.zeros(2), fi=fi, sens=None, do_sens=False,
              order=0, knowns=0, weighting_method=wt.WEIGHT_UNIFORM,
              debug=False)
    assert abs(fi[0] - fk.mean()) < 1e-12


def test_order4_quartic_recovery(rng):
    """d4/dx4 of x^4 + y^4 is 24 in both axes; everything lower vanishes."""
    def f(xy):
        return xy[..., 0] ** 4 + xy[..., 1] ** 4
    xk = rng.uniform(-1, 1, (40, 2))
    fi = np.zeros(wt.number_of_dofs(2, 4))
    wt.fit_2D(xk=xk, fk=f(xk), xi=np.zeros(2), fi=fi, sens=None, do_sens=False,
              order=4, knowns=0, weighting_method=wt.WEIGHT_UNIFORM,
              debug=False)
    assert abs(fi[wt.i2_X4] - 24.0) < 1e-8
    assert abs(fi[wt.i2_Y4] - 24.0) < 1e-8
    for idx in (wt.i2_F, wt.i2_X, wt.i2_Y):
        assert abs(fi[idx]) < 1e-10
    for idx in (wt.i2_X2, wt.i2_XY, wt.i2_Y2):
        assert abs(fi[idx]) < 1e-9


def test_known_f_is_preserved_exactly(rng):
    """A known DOF must come back bit-identical, even if it is 'wrong'."""
    def f(xy):
        return 1.0 + 2.0 * xy[..., 0] + 3.0 * xy[..., 1]
    xk = rng.uniform(-1, 1, (15, 2))
    fi = np.zeros(wt.number_of_dofs(2, 1))
    fi[wt.i2_F] = 999.0
    wt.fit_2D(xk=xk, fk=f(xk), xi=np.zeros(2), fi=fi, sens=None, do_sens=False,
              order=1, knowns=wt.b2_F, weighting_method=wt.WEIGHT_UNIFORM,
              debug=False)
    assert fi[wt.i2_F] == 999.0


def test_all_dofs_known_is_a_noop(rng):
    """Every DOF tagged known -> nothing to solve; fi passes through."""
    xk = rng.uniform(-1, 1, (10, 1)).ravel()
    fi = np.array([5.0, -1.0])
    fi_orig = fi.copy()
    wt.fit_1D(xk=xk, fk=np.ones(10), xi=0.0, fi=fi, sens=None, do_sens=False,
              order=1, knowns=wt.b1_F | wt.b1_X,
              weighting_method=wt.WEIGHT_UNIFORM, debug=False)
    np.testing.assert_array_equal(fi, fi_orig)


def test_minimum_neighbor_count_1d_order2():
    """3 points for 3 DOFs: the determined system is the classical stencil."""
    h = 0.1
    xk = np.array([-h, 0.0, h])
    fk = np.array([1.0, 0.5, 2.0])
    fi = np.zeros(3)
    wt.fit_1D(xk=xk, fk=fk, xi=0.0, fi=fi, sens=None, do_sens=False,
              order=2, knowns=0, weighting_method=wt.WEIGHT_UNIFORM,
              debug=False)
    assert abs(fi[wt.i1_F] - 0.5) < 1e-12
    assert abs(fi[wt.i1_X] - (2.0 - 1.0) / (2 * h)) < 1e-12
    assert abs(fi[wt.i1_X2] - (1.0 + 2.0 - 1.0) / h**2) < 1e-10


def test_number_of_dofs_table():
    assert [wt.number_of_dofs(1, k) for k in range(5)] == [1, 2, 3, 4, 5]
    assert [wt.number_of_dofs(2, k) for k in range(5)] == [1, 3, 6, 10, 15]
    assert [wt.number_of_dofs(3, k) for k in range(5)] == [1, 4, 10, 20, 35]


def test_fit_many_validates_inputs(rng):
    """Shape/enum mistakes raise clean ValueErrors, not broadcast noise."""
    import pytest

    from wlsqm_tpu import api

    xk = rng.uniform(-1, 1, (8, 20, 2))
    fk = np.sin(xk[..., 0])
    with pytest.raises(ValueError, match="fk must have shape"):
        api.fit_many(xk, fk[:, :19], order=2)
    with pytest.raises(ValueError, match="nk must have shape"):
        api.fit_many(xk, fk, order=2, nk=np.full(7, 20))
    with pytest.raises(ValueError, match="fi_init must have shape"):
        api.fit_many(xk, fk, order=2, fi_init=np.zeros((8, 3)))
    with pytest.raises(ValueError, match="backend must be"):
        api.fit_many(xk, fk, order=2, backend="gpu")
    with pytest.raises(ValueError, match="precision must be"):
        api.fit_many(xk, fk, order=2, precision="f128")


def test_prepare_solve_validate_inputs(rng):
    import pytest

    import wlsqm_tpu as wt

    xk = rng.uniform(-1, 1, (8, 20, 2))
    prep = wt.prepare(xk, np.zeros((8, 2)), order=2)
    with pytest.raises(ValueError, match="fk must have shape"):
        wt.solve(prep, np.zeros((8, 19)))
    with pytest.raises(ValueError, match="fk must have shape"):
        wt.solve(prep, np.zeros((7, 20)))
    with pytest.raises(ValueError, match="xi must have shape"):
        wt.prepare(xk, np.zeros((7, 2)), order=2)
    with pytest.raises(ValueError, match="nk must have shape"):
        wt.prepare(xk, np.zeros((8, 2)), order=2, nk=np.full(3, 20))


def test_unknown_weighting_id_rejected():
    rng = np.random.default_rng(0)
    xk = rng.uniform(-1, 1, (8, 12, 2))
    fk = xk[..., 0]
    with pytest.raises(ValueError, match="weighting must be"):
        wt.fit_many(xk, fk, order=2, weighting=7)
    with pytest.raises(ValueError, match="weighting must be"):
        wt.prepare(xk, np.zeros((8, 2)), order=2, weighting=7)


def test_degenerate_neighborhood_is_flagged_not_silent(rng):
    """Collinear neighbors (rank-deficient A) set ok=False, others unaffected.

    The reference silently ignores LAPACK failures inside its OpenMP
    regions (reference: TODO_DEFERRED.md:5-22); per-case status flags are
    the batched improvement SURVEY §5 prescribes.
    """
    B, K = 8, 12
    xi = np.zeros((B, 2))
    xk = rng.uniform(-1, 1, (B, K, 2))
    t = np.linspace(-1, 1, K)
    xk[3] = np.stack([t, 2 * t], -1)      # exactly collinear: rank < NO
    fk = np.sin(xk[..., 0]) + xk[..., 1]
    res = wt.fit_many(xk, fk, xi, order=2)
    ok = np.asarray(res.ok)
    assert not ok[3]
    assert ok[np.arange(B) != 3].all()
    assert not np.isfinite(np.asarray(res.fi)[3]).all()
