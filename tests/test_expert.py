"""ExpertSolver: prepare/solve split, guest mode, global interpolation."""

import numpy as np
import pytest

import wlsqm_tpu as wt

from conftest import quadratic_2d, quadratic_3d


def _solver_2d(ncases, npts, order=2, algorithm=None, do_sens=False,
               debug=False, host=None):
    algorithm = wt.ALGO_BASIC if algorithm is None else algorithm
    return wt.ExpertSolver(
        dimension=2,
        nk=np.full(ncases, npts, np.int32),
        order=np.full(ncases, order, np.int32),
        knowns=np.zeros(ncases, np.int64),
        weighting_method=np.full(ncases, wt.WEIGHT_UNIFORM, np.int32),
        algorithm=algorithm, do_sens=do_sens, ntasks=1, debug=debug,
        host=host,
    )


def test_single_case_matches_fit_2d(rng):
    f, expected = quadratic_2d()
    xk = rng.uniform(-1, 1, (30, 2))
    fk = f(xk)

    fi_ref = np.zeros(6)
    wt.fit_2D(xk=xk, fk=fk, xi=np.zeros(2), fi=fi_ref, sens=None,
              do_sens=False, order=2, knowns=0,
              weighting_method=wt.WEIGHT_UNIFORM, debug=False)

    es = _solver_2d(1, 30)
    es.prepare(xi=np.zeros((1, 2)), xk=xk[None])
    fi = np.zeros((1, 6))
    es.solve(fk=fk[None], fi=fi)

    np.testing.assert_allclose(fi[0], fi_ref, atol=1e-13)
    np.testing.assert_allclose(fi[0], expected, atol=1e-10)


def test_prepare_once_solve_twice(rng):
    f1, e1 = quadratic_2d()
    shift = 7.5
    npts = 30
    xk = rng.uniform(-1, 1, (1, npts, 2))

    es = _solver_2d(1, npts)
    es.prepare(xi=np.zeros((1, 2)), xk=xk)
    fi = np.zeros((1, 6))

    es.solve(fk=f1(xk[0])[None], fi=fi)
    np.testing.assert_allclose(fi[0], e1, atol=1e-10)

    es.solve(fk=(f1(xk[0]) + shift)[None], fi=fi)
    e2 = e1.copy()
    e2[wt.i2_F] += shift
    np.testing.assert_allclose(fi[0], e2, atol=1e-10)


def test_iterative_matches_basic(rng):
    f, expected = quadratic_2d()
    npts = 30
    xk = rng.uniform(-1, 1, (1, npts, 2))
    fk = f(xk[0])[None]

    out = {}
    for name, algo in (("basic", wt.ALGO_BASIC),
                       ("iter", wt.ALGO_ITERATIVE)):
        es = _solver_2d(1, npts, algorithm=algo)
        es.prepare(xi=np.zeros((1, 2)), xk=xk)
        fi = np.zeros((1, 6))
        es.solve(fk=fk, fi=fi)
        out[name] = fi.copy()
    np.testing.assert_allclose(out["basic"], out["iter"], atol=1e-12)
    np.testing.assert_allclose(out["basic"][0], expected, atol=1e-10)


def test_3d_case(rng):
    f, expected = quadratic_3d()
    npts = 40
    xk = rng.uniform(-1, 1, (1, npts, 3))
    es = wt.ExpertSolver(
        dimension=3, nk=np.array([npts], np.int32),
        order=np.array([2], np.int32), knowns=np.zeros(1, np.int64),
        weighting_method=np.array([wt.WEIGHT_UNIFORM], np.int32),
        algorithm=wt.ALGO_BASIC, do_sens=False, ntasks=1, debug=False)
    es.prepare(xi=np.zeros((1, 3)), xk=xk)
    fi = np.zeros((1, 10))
    es.solve(fk=f(xk[0])[None], fi=fi)
    np.testing.assert_allclose(fi[0], expected, atol=1e-10)


def test_guest_mode_shares_geometry(rng):
    f, expected = quadratic_2d()
    ncases, npts = 4, 25
    xk = rng.uniform(-1, 1, (ncases, npts, 2))
    fk = np.stack([f(xk[j]) for j in range(ncases)])

    host = _solver_2d(ncases, npts)
    host.prepare(xi=np.zeros((ncases, 2)), xk=xk)

    guest = _solver_2d(ncases, npts, host=host)
    guest.prepare(xi=np.zeros((ncases, 2)), xk=xk)
    assert guest.prepared is host.prepared  # shared, not recomputed

    fi = np.zeros((ncases, 6))
    guest.solve(fk=fk, fi=fi)
    for j in range(ncases):
        np.testing.assert_allclose(fi[j], expected, atol=1e-10)


def test_guest_mode_requires_ready_host(rng):
    host = _solver_2d(2, 10)
    with pytest.raises(RuntimeError):
        _solver_2d(2, 10, host=host)


def test_guest_mode_validates_config(rng):
    host = _solver_2d(2, 10)
    host.prepare(xi=np.zeros((2, 2)), xk=rng.uniform(-1, 1, (2, 10, 2)))
    with pytest.raises(RuntimeError):
        _solver_2d(3, 10, host=host)  # ncases mismatch
    with pytest.raises(ValueError):
        _solver_2d(2, 10, order=3, host=host)  # order mismatch


def test_scalar_case_params_raise_cleanly():
    # Per-case arrays are the contract (reference expects (ncases,) arrays);
    # a scalar must produce a clear ValueError, not an IndexError.
    nk = np.full(4, 10, dtype=np.int64)
    with pytest.raises(ValueError, match="order must be a 1D per-case array"):
        wt.ExpertSolver(dimension=2, nk=nk, order=2,
                               knowns=np.zeros(4, np.int64),
                               weighting_method=np.full(4, 1, np.int32))
    with pytest.raises(ValueError, match="knowns must be a 1D per-case array"):
        wt.ExpertSolver(dimension=2, nk=nk,
                               order=np.full(4, 2, np.int32), knowns=0,
                               weighting_method=np.full(4, 1, np.int32))


def test_algorithm_is_scalar_like_the_reference():
    # The reference takes ONE `int algorithm` for the whole solver
    # (wlsqm/fitter/expert.pyx:93); a per-case array must raise a clear
    # TypeError, not numpy's ambiguous-truth-value error.  Size-1 arrays
    # and numpy integer scalars coerce like the reference's int() would.
    mk = dict(dimension=2, nk=np.full(4, 10, np.int64),
              order=np.full(4, 2, np.int32), knowns=np.zeros(4, np.int64),
              weighting_method=np.full(4, 1, np.int32))
    with pytest.raises(TypeError, match="single ALGO_"):
        wt.ExpertSolver(algorithm=np.full(4, wt.ALGO_BASIC), **mk)
    wt.ExpertSolver(algorithm=np.int32(wt.ALGO_ITERATIVE), **mk)
    wt.ExpertSolver(algorithm=np.array([wt.ALGO_BASIC]), **mk)
    with pytest.raises(ValueError, match="Unknown algorithm"):
        wt.ExpertSolver(algorithm=7, **mk)


def test_conds_requires_debug(rng):
    es = _solver_2d(1, 20)
    es.prepare(xi=np.zeros((1, 2)), xk=rng.uniform(-1, 1, (1, 20, 2)))
    with pytest.raises(RuntimeError):
        es.conds()

    es_dbg = _solver_2d(1, 20, debug=True)
    es_dbg.prepare(xi=np.zeros((1, 2)), xk=rng.uniform(-1, 1, (1, 20, 2)))
    conds = es_dbg.conds()
    assert conds.shape == (1,)
    assert np.isfinite(conds).all() and (conds >= 1.0).all()


def test_solve_before_prepare_raises(rng):
    es = _solver_2d(1, 20)
    with pytest.raises(RuntimeError):
        es.solve(fk=np.zeros((1, 20)), fi=np.zeros((1, 6)))


def test_interpolate_nearest_and_continuous(rng):
    f, _ = quadratic_2d()
    ncases, npts = 9, 25
    # distinct origins on a grid so every local model is exact around its xi
    gx, gy = np.meshgrid(np.linspace(-1, 1, 3), np.linspace(-1, 1, 3))
    xi = np.stack([gx.ravel(), gy.ravel()], axis=-1)
    xk = xi[:, None, :] + rng.uniform(-0.5, 0.5, (ncases, npts, 2))
    fk = f(xk)

    es = _solver_2d(ncases, npts)
    es.prepare(xi=xi, xk=xk)
    fi = np.zeros((ncases, 6))
    es.solve(fk=fk, fi=fi)
    es.prep_interpolate()

    q = rng.uniform(-0.9, 0.9, (40, 2))
    out, idx = es.interpolate(q, mode="nearest")
    np.testing.assert_allclose(out, f(q), atol=1e-9)
    assert idx.shape == (40,)

    # reusing the returned index set skips the search and matches
    out2, _ = es.interpolate(q, mode="nearest", I=idx)
    np.testing.assert_allclose(out2, out, atol=0)

    outc, idxc = es.interpolate(q, mode="continuous", r=1.5)
    assert idxc is None
    np.testing.assert_allclose(outc, f(q), atol=1e-9)

    # derivative interpolation through the global patched model
    ddx, _ = es.interpolate(q, mode="nearest", diff=wt.i2_X)
    np.testing.assert_allclose(ddx, 2 + 4 * q[:, 1] + 10 * q[:, 0], atol=1e-9)


def test_memory_used_reports_bytes(rng):
    es = _solver_2d(3, 20)
    assert es.memory_used() == (0, 0)
    es.prepare(xi=np.zeros((3, 2)), xk=rng.uniform(-1, 1, (3, 20, 2)))
    used, total = es.memory_used()
    assert used == total and used > 0


def test_conds_estimate_matches_debug(rng):
    """Power-iteration estimates track the SVD condition numbers."""
    B, K = 32, 18
    xi = rng.uniform(-1, 1, (B, 2))
    xk = xi[:, None, :] + rng.uniform(-0.3, 0.3, (B, K, 2))

    kw = dict(dimension=2, nk=np.full(B, K, np.int32),
              order=np.full(B, 2, np.int32), knowns=np.zeros(B, np.int64),
              weighting_method=np.full(B, wt.WEIGHT_UNIFORM, np.int32))
    dbg = wt.ExpertSolver(debug=True, **kw)
    dbg.prepare(xi=xi, xk=xk)
    exact = dbg.conds()

    plain = wt.ExpertSolver(**kw)
    plain.prepare(xi=xi, xk=xk)
    with pytest.raises(RuntimeError):
        plain.conds()           # reference behavior preserved
    est = plain.conds(estimate=True)

    assert est.shape == exact.shape
    # power iteration gives a lower bound converging from below
    assert np.all(est <= exact * 1.01)
    assert np.all(est >= exact * 0.5), (est / exact).min()


def test_interpolate_continuous_device_mode(rng):
    """device=True blending == host-tree blending, no prep_interpolate."""
    B, K = 48, 14
    xi = rng.uniform(-1, 1, (B, 2))
    xk = xi[:, None, :] + rng.uniform(-0.3, 0.3, (B, K, 2))
    f, _ = quadratic_2d()
    fk = f(xk.reshape(-1, 2)).reshape(B, K)

    kw = dict(dimension=2, nk=np.full(B, K, np.int32),
              order=np.full(B, 2, np.int32), knowns=np.zeros(B, np.int64),
              weighting_method=np.full(B, wt.WEIGHT_UNIFORM, np.int32))
    s = wt.ExpertSolver(**kw)
    s.prepare(xi=xi, xk=xk)
    fi = np.zeros((B, 6))
    s.solve(fk=fk, fi=fi)

    q = rng.uniform(-0.9, 0.9, (31, 2))
    got, idx = s.interpolate(q, mode="continuous", r=0.5, device=True)
    assert idx is None

    s.prep_interpolate()
    ref, _ = s.interpolate(q, mode="continuous", r=0.5)
    mask = np.isfinite(ref)
    np.testing.assert_allclose(got[mask], ref[mask], rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(np.isfinite(got), mask)


def test_precision_f64_bit_identical_under_compat_knob(rng):
    """The default precision (None) is the native-f64 engine: its output
    is bit-identical to an explicit precision='f64' solver."""
    B, K = 8, 30
    xk = rng.uniform(-1, 1, (B, K, 2))
    fk = np.sin(xk[..., 0]) * np.cos(xk[..., 1])

    def run(**kw):
        es = wt.ExpertSolver(
            dimension=2, nk=np.full(B, K, np.int32),
            order=np.full(B, 4, np.int32), knowns=np.zeros(B, np.int64),
            weighting_method=np.full(B, wt.WEIGHT_CENTER, np.int32), **kw)
        es.prepare(xi=np.zeros((B, 2)), xk=xk)
        assert es.prepared.precision == "f64"
        fi = np.zeros((B, 15))
        es.solve(fk=fk, fi=fi)
        return fi

    np.testing.assert_array_equal(run(), run(precision="f64"))


def test_iterative_with_sens_matches_basic_sens(rng):
    """ALGO_ITERATIVE + do_sens: the sensitivity matrix is a property of
    the linear solve and must equal ALGO_BASIC's (the reference computes
    sens in the initial solve; refinement only updates fi,
    reference: wlsqm/fitter/impl.pyx:986-1083)."""
    f, expected = quadratic_2d()
    ncases, npts = 6, 26
    xk = rng.uniform(-1, 1, (ncases, npts, 2))
    fk = f(xk)

    out = {}
    for algo in (wt.ALGO_BASIC, wt.ALGO_ITERATIVE):
        es = _solver_2d(ncases, npts, algorithm=algo, do_sens=True)
        es.prepare(xi=np.zeros((ncases, 2)), xk=xk)
        fi = np.zeros((ncases, 6))
        sens = np.zeros((ncases, npts, 6))
        iters = es.solve(fk=fk, fi=fi, sens=sens)
        out[algo] = (fi.copy(), sens.copy(), iters)

    fi_b, sens_b, _ = out[wt.ALGO_BASIC]
    fi_i, sens_i, _ = out[wt.ALGO_ITERATIVE]
    np.testing.assert_array_equal(sens_i, sens_b)
    # exact polynomial: refinement is a no-op beyond roundoff
    np.testing.assert_allclose(fi_i, fi_b, atol=1e-12)
    np.testing.assert_allclose(fi_i, np.tile(expected, (ncases, 1)),
                               atol=1e-9)


def test_solve_device_matches_solve(rng):
    """The device-resident extension returns the same DOFs as the NumPy
    in-place contract (round-3 boundary work)."""
    import jax.numpy as jnp

    f, expected = quadratic_2d()
    B, K = 24, 30
    xi = rng.uniform(-1, 1, (B, 2))
    xk = xi[:, None, :] + rng.uniform(-0.6, 0.6, (B, K, 2))
    fk = f(xk)
    es = _solver_2d(B, K)
    es.prepare(xi=xi, xk=xk)
    fi = np.zeros((B, 6))
    es.solve(fk=fk, fi=fi)
    fi_d, sens_d, iters_d = es.solve_device(jnp.asarray(fk))
    # different jit wrappers compile separately; agreement is to rounding
    np.testing.assert_allclose(np.asarray(fi_d), fi, rtol=0, atol=1e-12)
    assert sens_d is None
    assert np.asarray(iters_d).max() == 0
    # multi-field form reuses the same factorizations
    fks = jnp.stack([jnp.asarray(fk), 2.0 * jnp.asarray(fk)])
    fi_m, _, _ = es.solve_device(fks)
    np.testing.assert_allclose(np.asarray(fi_m[0]), fi, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(fi_m[1]), 2.0 * fi, rtol=1e-11,
                               atol=1e-11)


def test_solve_stream_matches_sequential_solves(rng):
    """solve_stream pipelines repeated solves (one in flight) and yields
    per-step results identical to back-to-back solve_device calls, in
    input order — including the drained last step."""
    f, _ = quadratic_2d()
    B, K = 20, 26
    xi = rng.uniform(-1, 1, (B, 2))
    xk = xi[:, None, :] + rng.uniform(-0.6, 0.6, (B, K, 2))
    es = _solver_2d(B, K)
    es.prepare(xi=xi, xk=xk)

    steps = [f(xk) * (1.0 + 0.1 * t) for t in range(5)]
    got = list(es.solve_stream(iter(steps)))
    assert len(got) == len(steps)
    for fk_t, (fi_t, it_t) in zip(steps, got):
        fi_ref = np.zeros((B, 6))
        it_ref = es.solve(fk=fk_t, fi=fi_ref)
        np.testing.assert_allclose(fi_t, fi_ref, rtol=0, atol=1e-12)
        assert it_t == it_ref
        assert isinstance(fi_t, np.ndarray) and fi_t.dtype == np.float64


def test_solve_stream_guards(rng):
    f, _ = quadratic_2d()
    B, K = 8, 20
    es = _solver_2d(B, K)
    with pytest.raises(RuntimeError, match="prepare"):
        next(es.solve_stream(iter([np.zeros((B, K))])))
    xi = rng.uniform(-1, 1, (B, 2))
    xk = xi[:, None, :] + rng.uniform(-0.6, 0.6, (B, K, 2))
    es2 = _solver_2d(B, K, do_sens=True)
    es2.prepare(xi=xi, xk=xk)
    with pytest.raises(ValueError, match="do_sens"):
        next(es2.solve_stream(iter([f(xk)])))


def test_solve_accepts_device_fk(rng):
    import jax.numpy as jnp

    f, _ = quadratic_2d()
    B, K = 16, 25
    xi = rng.uniform(-1, 1, (B, 2))
    xk = xi[:, None, :] + rng.uniform(-0.5, 0.5, (B, K, 2))
    fk = f(xk)
    es = _solver_2d(B, K)
    es.prepare(xi=xi, xk=xk)
    fi_np = np.zeros((B, 6))
    es.solve(fk=fk, fi=fi_np)
    fi_dev = np.zeros((B, 6))
    es.solve(fk=jnp.asarray(fk), fi=fi_dev)
    np.testing.assert_array_equal(fi_np, fi_dev)


def test_solve_preserves_inactive_trailing_dofs(rng):
    """Per-case orders below max: the in/out fi keeps the caller's values
    on inactive trailing DOFs (reference Case_get_fi copies active DOFs
    only; round-3 write-back honors that without uploading fi)."""
    f, _ = quadratic_2d()
    B, K = 12, 30
    xi = rng.uniform(-1, 1, (B, 2))
    xk = xi[:, None, :] + rng.uniform(-0.6, 0.6, (B, K, 2))
    order = np.full(B, 2, np.int32)
    order[::2] = 1                      # half the cases are order 1
    es = wt.ExpertSolver(
        dimension=2, nk=np.full(B, K, np.int32), order=order,
        knowns=np.zeros(B, np.int64),
        weighting_method=np.full(B, wt.WEIGHT_UNIFORM, np.int32))
    es.prepare(xi=xi, xk=xk)
    fi = np.full((B, 6), 123.0)
    es.solve(fk=f(xk), fi=fi)
    no1 = wt.number_of_dofs(2, 1)
    assert np.all(fi[::2, no1:] == 123.0)     # untouched trailing DOFs
    assert np.all(fi[1::2] != 123.0)
