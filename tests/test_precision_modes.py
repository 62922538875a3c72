"""Precision modes: mixed and fast must agree with the f64 reference path.

These are explicit emulation modes for devices whose f64 rate is low;
"mixed" keeps the f64 assembly but factors in f32 with f64-residual refinement, and "fast" runs
assembly/Ruiz/Cholesky all in f32, recovering f64-class accuracy by
refinement through the f64 basis rows.  Both must match the all-f64 path to
well inside the 1e-10 parity bar.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import wlsqm_tpu as wt
from wlsqm_tpu.fitter import defs, engine


def _args(rng, B=64, K=30, order=4, NO=15):
    xk = jnp.asarray(rng.uniform(-1, 1, (B, K, 2)))
    fk = jnp.asarray(rng.standard_normal((B, K)))
    return (
        xk, fk,
        jnp.full((B,), K, jnp.int32),
        jnp.zeros((B, 2)),
        jnp.zeros((B, NO)),
        jnp.full((B,), order, jnp.int32),
        jnp.zeros((B,), jnp.int64),
        jnp.full((B,), defs.WEIGHT_CENTER, jnp.int32),
    )


@pytest.mark.parametrize("precision", ["mixed", "fast"])
def test_matches_f64_order4(rng, precision):
    args = _args(rng)
    fi64, _, _, _ = engine.fit_batch(*args, dimension=2, NO=15)
    fip, _, _, _ = engine.fit_batch(
        *args, dimension=2, NO=15, precision=precision, ruiz_max_iter=10)
    a, b = np.asarray(fi64), np.asarray(fip)
    rel = np.abs(a - b).max() / np.abs(a).max()
    assert rel < 1e-10, f"{precision} deviates from f64 by {rel:.2e}"


@pytest.mark.parametrize("precision", ["mixed", "fast"])
def test_polynomial_recovery(rng, precision):
    def f(xy):
        x, y = xy[..., 0], xy[..., 1]
        return 1.0 + 2.0 * x + 3.0 * y + 4.0 * x * y + 5.0 * x**2 + 6.0 * y**2
    xk = rng.uniform(-1, 1, (16, 30, 2))
    res = wt.fit_many(xk, f(xk), order=2, precision=precision,
                      ruiz_max_iter=10)
    np.testing.assert_allclose(
        np.asarray(res.fi), np.tile([1., 2, 3, 10, 4, 12], (16, 1)),
        atol=1e-10)


@pytest.mark.parametrize("precision", ["mixed", "fast"])
def test_sensitivity_and_knowns(rng, precision):
    args = list(_args(rng, B=8, order=2, NO=6))
    args[6] = jnp.full((8,), defs.b2_F, jnp.int64)  # F known
    fi64, s64, _, _ = engine.fit_batch(
        *args, dimension=2, NO=6, do_sens=True)
    fip, sp, _, _ = engine.fit_batch(
        *args, dimension=2, NO=6, do_sens=True,
        precision=precision, ruiz_max_iter=10)
    np.testing.assert_allclose(np.asarray(fip), np.asarray(fi64), atol=1e-10)
    # NaN pattern identical; finite parts agree
    assert np.array_equal(np.isnan(np.asarray(sp)), np.isnan(np.asarray(s64)))
    m = ~np.isnan(np.asarray(s64))
    np.testing.assert_allclose(
        np.asarray(sp)[m], np.asarray(s64)[m], atol=1e-9)


@pytest.mark.parametrize("precision", ["mixed", "fast"])
def test_iterative_refinement_mode(rng, precision):
    args = _args(rng, B=8, order=3, NO=10)
    fi64, _, _, _ = engine.fit_batch(
        *args, dimension=2, NO=10, iterative=True, max_iter=5)
    fip, _, _, _ = engine.fit_batch(
        *args, dimension=2, NO=10, iterative=True, max_iter=5,
        precision=precision, ruiz_max_iter=10)
    np.testing.assert_allclose(np.asarray(fip), np.asarray(fi64), atol=1e-10)


def test_lu_solver_matches_cholesky(rng):
    """SOLVER_LU is the reference-parity debug mode (the reference
    LU-factors the scaled normal matrix via dgetrf,
    reference: wlsqm/fitter/impl.pyx:686); it must agree with the default
    Cholesky path at f64 roundoff, including sensitivities."""
    args = _args(rng)
    fi_c, s_c, _, _ = engine.fit_batch(*args, dimension=2, NO=15,
                                       solver="chol", do_sens=True)
    fi_l, s_l, _, _ = engine.fit_batch(*args, dimension=2, NO=15,
                                       solver="lu", do_sens=True)
    rel = (np.abs(np.asarray(fi_l) - np.asarray(fi_c)).max()
           / np.abs(np.asarray(fi_c)).max())
    assert rel < 1e-11
    srel = (np.abs(np.asarray(s_l) - np.asarray(s_c)).max()
            / np.abs(np.asarray(s_c)).max())
    assert srel < 1e-11


@pytest.mark.full
def test_pair_solve_matches_ds_boundary(rng, monkeypatch):
    """solve_prepared_ds_pair (pair in/out, zero f64 ops) renders to the
    same values as the f64-boundary solve_prepared_ds at the ds
    representation floor, with and without prescribed knowns."""
    # mechanics/consistency only — both paths share the same (possibly
    # CPU-degraded) pair arithmetic, so the comparison is backend-valid
    monkeypatch.setenv("WLSQM_TPU_ALLOW_DEGRADED_DS", "1")
    from wlsqm_tpu.fitter import engine_ds
    from wlsqm_tpu.ops import twofloat as tf

    B, K = 48, 25
    xi = rng.uniform(-1, 1, (B, 2))
    xk = xi[:, None, :] + rng.uniform(-0.3, 0.3, (B, K, 2))
    fk = jnp.asarray(np.sin(xk[..., 0]) * np.cos(xk[..., 1]))

    prep = wt.prepare(xk, xi, order=3, precision="ds",
                      scaling="jacobi", solver="chol_unrolled")
    fi_ref, _ = engine_ds.solve_prepared_ds(
        prep, fk, jnp.zeros((B, prep.no_max)), False)
    pair = engine_ds.solve_prepared_ds_pair(prep, tf.from_f64(fk))
    np.testing.assert_allclose(np.asarray(tf.to_f64(pair)),
                               np.asarray(fi_ref), atol=2e-15)

    # knowns: pin F (Neumann-style seed), known slots pass through
    kn = np.full(B, defs.b2_F, np.int64)
    prep2 = wt.prepare(xk, xi, order=3, knowns=kn, precision="ds",
                       scaling="jacobi", solver="chol_unrolled")
    fi_seed = np.zeros((B, prep2.no_max))
    fi_seed[:, defs.i2_F] = np.sin(xi[:, 0]) * np.cos(xi[:, 1])
    fi_seed = jnp.asarray(fi_seed)
    fi_ref2, _ = engine_ds.solve_prepared_ds(prep2, fk, fi_seed, False)
    pair2 = engine_ds.solve_prepared_ds_pair(
        prep2, tf.from_f64(fk), tf.from_f64(fi_seed))
    out2 = np.asarray(tf.to_f64(pair2))
    np.testing.assert_allclose(out2, np.asarray(fi_ref2), atol=2e-14)
    # known slots pass through bitwise AS THE PAIR GIVEN (the f64 render
    # differs from the seed only by the ds representation's ~2^-48 split)
    seed_pair = tf.from_f64(fi_seed)
    np.testing.assert_array_equal(np.asarray(pair2[0][:, defs.i2_F]),
                                  np.asarray(seed_pair[0][:, defs.i2_F]))
    np.testing.assert_array_equal(np.asarray(pair2[1][:, defs.i2_F]),
                                  np.asarray(seed_pair[1][:, defs.i2_F]))


@pytest.mark.full
def test_pair_solve_extreme_radius(rng, monkeypatch):
    """dof_scale beyond the f32 exponent range must not corrupt the
    pair solve (regression: the single f32 cast of 2^(e_s*deg) overflowed
    for |e_s|*deg > ~126; now applied as two balanced pow2 factors)."""
    monkeypatch.setenv("WLSQM_TPU_ALLOW_DEGRADED_DS", "1")
    from wlsqm_tpu.fitter import engine_ds
    from wlsqm_tpu.ops import twofloat as tf

    B, K = 16, 20
    # nearly-flat data, so the DOF values themselves stay representable
    # in an f32 pair while dof_scale = 2^(|e_s|*deg) ~ 2^±160 does not
    # survive a single f32 cast (old code: inf/0 -> inf or NaN output).
    for spacing in (1e-12, 1e12):
        xi = rng.uniform(-1, 1, (B, 2)) * spacing
        xk = xi[:, None, :] + rng.uniform(-1, 1, (B, K, 2)) * spacing
        # exactly quadratic in the scaled coordinate: deg>=3 DOFs are pure
        # solve-noise (identical x-hat in both paths), deg<=2 DOFs are
        # large-but-f32-representable true values
        t = xk[..., 0] / spacing
        fk = jnp.asarray(1.0 + 0.5 * t + 0.25 * t * t)
        prep = wt.prepare(xk, xi, order=4, precision="ds",
                          scaling="jacobi", solver="chol_unrolled")
        fi_ref, _ = engine_ds.solve_prepared_ds(
            prep, fk, jnp.zeros((B, prep.no_max)), False)
        pair = engine_ds.solve_prepared_ds_pair(prep, tf.from_f64(fk))
        out = np.asarray(tf.to_f64(pair))
        ref = np.asarray(fi_ref)
        assert np.isfinite(out).all(), spacing
        # F (and every pair-representable DOF) must match the
        # f64-boundary path.  Below ~1e-30 the pair's lo plane falls into
        # f32 subnormals (hi ~ 2^-101 => lo subnormal), so full ~2^-48
        # pair precision only exists above that floor; judge columns
        # against it (smaller magnitudes may flush or round f32-grade).
        den = np.maximum(np.abs(ref).max(axis=0), 1e-30)
        rel = (np.abs(out - ref) / den[None, :]).max()
        assert rel < 1e-9, (spacing, rel)
