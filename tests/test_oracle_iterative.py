"""ALGO_ITERATIVE (``iterative=True, max_iter=3``) against SciPy.

The corrective fits converge to the same least-squares solution, so the
DOFs must match the independent SciPy solve at the 1e-10 parity bar for
every dimension, order and weighting, within the iteration budget.
"""

import numpy as np
import pytest

import wlsqm_tpu as wt
from wlsqm_tpu.fitter import defs
import scipy_reference as so


@pytest.mark.parametrize("weighting", [defs.WEIGHT_UNIFORM, defs.WEIGHT_CENTER],
                         ids=["uniform", "center"])
@pytest.mark.parametrize("order", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("dimension", [1, 2, 3])
def test_iterative_matches_scipy(rng, dimension, order, weighting):
    xk, fk, xi, _ = so.problem(rng, dimension, order)
    B = xk.shape[0]
    no = defs.number_of_dofs(dimension, order)
    res = wt.fit_many(xk, fk, xi, order=order, weighting=weighting,
                      iterative=True, max_iter=3)
    fi = np.asarray(res.fi)
    iters = np.asarray(res.iterations)
    assert iters.shape == (B,)
    assert ((iters >= 0) & (iters <= 3)).all()
    for b in range(B):
        want = so.fit_case(xk[b], fk[b], xi[b], order, 0, weighting,
                           dimension, np.zeros(no))
        assert so.linf_rel(fi[b], want) <= 1e-10, b
