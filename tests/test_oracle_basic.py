"""The f64 engine through ``fit_many`` against an independent SciPy solve.

Covers every dimension and order with both weightings, with no knowns and
with the function value F prescribed (a Dirichlet boundary case), at the
1e-10 parity bar.
"""

import numpy as np
import pytest

import wlsqm_tpu as wt
from wlsqm_tpu.fitter import defs
import scipy_reference as so

F_KNOWN = {1: int(defs.b1_F), 2: int(defs.b2_F), 3: int(defs.b3_F)}


@pytest.mark.parametrize("f_known", [False, True], ids=["free", "F_known"])
@pytest.mark.parametrize("weighting", [defs.WEIGHT_UNIFORM, defs.WEIGHT_CENTER],
                         ids=["uniform", "center"])
@pytest.mark.parametrize("order", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("dimension", [1, 2, 3])
def test_fit_many_matches_scipy(rng, dimension, order, weighting, f_known):
    xk, fk, xi, _ = so.problem(rng, dimension, order)
    B = xk.shape[0]
    no = defs.number_of_dofs(dimension, order)
    knowns = F_KNOWN[dimension] if f_known else 0
    fi_init = np.zeros((B, no))
    if f_known:
        fi_init[:, 0] = rng.uniform(-1, 1, B)
    res = wt.fit_many(xk, fk, xi, order=order, knowns=knowns,
                      weighting=weighting, fi_init=fi_init)
    got = np.asarray(res.fi)
    assert got.shape == (B, no)
    for b in range(B):
        want = so.fit_case(xk[b], fk[b], xi[b], order, knowns, weighting,
                           dimension, fi_init[b])
        assert so.linf_rel(got[b], want) <= 1e-10, (b, got[b], want)
    if f_known:
        np.testing.assert_array_equal(got[:, 0], fi_init[:, 0])


@pytest.mark.parametrize("f_known", [False, True], ids=["free", "F_known"])
@pytest.mark.parametrize("order", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("dimension", [1, 2, 3])
def test_long_double_witness_matches_scipy(rng, dimension, order, f_known):
    """The long-double witness solves the same problem as ``fit_case``."""
    xk, fk, xi, _ = so.problem(rng, dimension, order)
    B = xk.shape[0]
    no = defs.number_of_dofs(dimension, order)
    knowns = F_KNOWN[dimension] if f_known else 0
    fi_init = np.zeros((B, no))
    fi_init[:, 0] = rng.uniform(-1, 1, B)
    ld = so.fit_cases_ld(xk, fk, xi, order, knowns, defs.WEIGHT_CENTER,
                         dimension, fi_init)
    assert ld.shape == (B, no) and ld.dtype == np.float64
    for b in range(B):
        want = so.fit_case(xk[b], fk[b], xi[b], order, knowns,
                           defs.WEIGHT_CENTER, dimension, fi_init[b])
        assert so.linf_rel(ld[b], want) <= 1e-12, (b, ld[b], want)
    if f_known:
        np.testing.assert_array_equal(ld[:, 0], fi_init[:, 0])
