"""Package surface: version, submodules, re-exports, constants."""

import re

import wlsqm_tpu as wt


def test_version_pep440():
    v = wt.__version__
    assert isinstance(v, str) and v
    assert re.match(r"^\d+\.\d+\.\d+(\.(dev|a|b|rc|post)\d+)?$", v)


def test_submodules_importable():
    from wlsqm_tpu.fitter import (  # noqa: F401
        defs, engine, expert, interp, polyeval, simple, tables,
    )
    from wlsqm_tpu.ops import ruiz, solve  # noqa: F401
    from wlsqm_tpu.utils import lapackdrivers  # noqa: F401
    from wlsqm_tpu import api, parallel  # noqa: F401


def test_public_reexports():
    for name in (
        "fit_1D", "fit_2D", "fit_3D",
        "fit_1D_iterative", "fit_2D_iterative", "fit_3D_iterative",
        "fit_1D_many", "fit_2D_many", "fit_3D_many",
        "fit_1D_many_parallel", "fit_2D_many_parallel", "fit_3D_many_parallel",
        "fit_1D_iterative_many", "fit_2D_iterative_many",
        "fit_3D_iterative_many",
        "fit_1D_iterative_many_parallel", "fit_2D_iterative_many_parallel",
        "fit_3D_iterative_many_parallel",
        "ExpertSolver", "interpolate_fit", "lambdify_fit",
        "WEIGHT_UNIFORM", "WEIGHT_CENTER", "ALGO_BASIC", "ALGO_ITERATIVE",
        "number_of_dofs",
        # JAX-native layer
        "fit", "fit_many", "prepare", "solve", "interpolate", "FitResult",
        "Prepared",
    ):
        assert hasattr(wt, name), "wlsqm_tpu.%s missing" % name


def test_dof_constants_consistent():
    # prefix property: every end marker equals number_of_dofs
    assert wt.i2_1st_end == wt.number_of_dofs(2, 1) == 3
    assert wt.i3_3rd_end == wt.number_of_dofs(3, 3) == 20
    assert wt.SIZE1 == 5 and wt.SIZE2 == 15 and wt.SIZE3 == 35
    # bitmasks are 1 << index
    assert wt.b2_XY == 1 << wt.i2_XY
    assert wt.b3_XYZ2 == 1 << wt.i3_XYZ2


def test_exponent_tables_match_dof_ordering():
    from wlsqm_tpu.fitter import tables
    import numpy as np

    # spot-check a few well-known slots
    assert tuple(tables.EXP2[wt.i2_X2Y2]) == (2, 2)
    assert tuple(tables.EXP3[wt.i3_XYZ]) == (1, 1, 1)
    assert tuple(tables.EXP3[wt.i3_XZ3]) == (1, 0, 3)
    # factorial normalization: X4 slot carries 1/24
    assert tables.INV_FACT[2][wt.i2_X4] == 1.0 / 24.0
    assert tables.INV_FACT[3][wt.i3_X2Y2] == 0.25
    # degrees grouped in nondecreasing order (prefix-truncation property)
    for d in (1, 2, 3):
        deg = tables.DEGREE[d]
        assert (np.diff(deg) >= 0).all()


def test_number_of_reduced_dofs():
    from wlsqm_tpu.fitter.defs import number_of_reduced_dofs
    assert number_of_reduced_dofs(6, 0) == 6
    assert number_of_reduced_dofs(6, wt.b2_F) == 5
    assert number_of_reduced_dofs(6, wt.b2_F | wt.b2_XY) == 4


def test_fit_stream_matches_fit_many(rng):
    """Chunked streaming == one-shot batch, including a ragged last chunk."""
    import numpy as np

    B, K = 300, 12
    xi = rng.uniform(-1, 1, (B, 2))
    xk = xi[:, None, :] + rng.uniform(-0.3, 0.3, (B, K, 2))
    fk = np.sin(xk[..., 0]) + xk[..., 1]

    want = np.asarray(wt.fit_many(xk, fk, xi, order=2).fi)
    got = wt.fit_stream(xk, fk, xi, order=2, chunk=128)
    assert isinstance(got.fi, np.ndarray)
    np.testing.assert_allclose(got.fi, want, rtol=0, atol=1e-12)

    # per-case parameter arrays are sliced along with the geometry
    order = np.full(B, 2, np.int32)
    want2 = np.asarray(wt.fit_many(xk, fk, xi, order=order).fi)
    got2 = wt.fit_stream(xk, fk, xi, order=order, chunk=128)
    np.testing.assert_allclose(got2.fi, want2, rtol=0, atol=1e-12)

    # preallocated output buffer
    out = np.empty((B, 6))
    res = wt.fit_stream(xk, fk, xi, order=2, chunk=128, out=out)
    assert res.fi is out
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-12)


def test_solve_multifield(rng):
    """fk (F, B, K): one call solves all fields on shared geometry."""
    import numpy as np
    import wlsqm_tpu as wt

    B, K, F = 40, 14, 3
    xi = rng.uniform(-1, 1, (B, 2))
    xk = xi[:, None, :] + rng.uniform(-0.3, 0.3, (B, K, 2))
    prep = wt.prepare(xk - xi[:, None, :], np.zeros((B, 2)), order=2)

    fks = np.stack([np.sin(xk[..., 0]) * (f + 1) + xk[..., 1] ** 2
                    for f in range(F)])
    fi_all, _ = wt.solve(prep, fks)
    assert fi_all.shape == (F, B, 6)
    for f in range(F):
        fi_f, _ = wt.solve(prep, fks[f])
        # vmap batches the einsums, which may reassociate contractions;
        # agreement is to f64 roundoff, not bitwise
        np.testing.assert_allclose(np.asarray(fi_all[f]), np.asarray(fi_f),
                                   rtol=1e-11, atol=1e-13)

    # iterative variant keeps the same stacking
    fi_it, _, iters = wt.solve(prep, fks, iterative=True, max_iter=3)
    assert fi_it.shape == (F, B, 6) and iters.shape[0] == F


