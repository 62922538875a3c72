"""``fit_many(do_sens=True)`` sensitivities against SciPy's A⁻¹CᵀW.

Every dimension, order and weighting, at the 1e-10 parity bar; the DOFs
of the same call are checked too.
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
def test_sensitivities_match_scipy(rng, dimension, order, weighting):
    xk, fk, xi, K = so.problem(rng, dimension, order)
    B = xk.shape[0]
    no = defs.number_of_dofs(dimension, order)
    res = wt.fit_many(xk, fk, xi, order=order, weighting=weighting,
                      do_sens=True)
    sens = np.asarray(res.sens)
    fi = np.asarray(res.fi)
    assert sens.shape == (B, K, no)
    for b in range(B):
        want = so.sens_case(xk[b], xi[b], order, weighting, dimension)
        assert so.linf_rel(sens[b], want) <= 1e-10, b
        want_fi = so.fit_case(xk[b], fk[b], xi[b], order, 0, weighting,
                              dimension, np.zeros(no))
        assert so.linf_rel(fi[b], want_fi) <= 1e-10, b
