"""Randomized cross-check of the batched engine against the per-case
SciPy reference (tests/scipy_reference.py).

The reference solves each case on its own, sliced to its valid
neighbours, by a column-scaled SVD least-squares solve with algebraic
knowns elimination (reference: wlsqm/fitter/impl.pyx — make_c / make_A /
solve, wlsqm/fitter/infra.pyx:668-702 weights), i.e. structurally UNLIKE
the engine's masked static-shape formulation — shared bugs are unlikely.
Random configurations sweep dimension, order, neighbor count, raggedness,
weighting, and knowns bitmasks.
"""

import numpy as np
import pytest

import scipy_reference
import wlsqm_tpu as wt
from wlsqm_tpu.fitter import defs


def _oracle_case(xk, fk, xi, nk, order, knowns, weighting, dimension,
                 fi_init=None):
    """The reference's DOFs of one (possibly ragged) case; known DOFs keep
    their ``fi_init`` values (zeros if None)."""
    no = defs.number_of_dofs(dimension, order)
    fi_init = np.zeros(no) if fi_init is None else fi_init
    return scipy_reference.fit_case(xk[:nk], fk[:nk], xi, order, knowns,
                                    weighting, dimension, fi_init)


CONFIGS = [
    # (dimension, order, K, ragged, weighting, knowns)
    (1, 2, 8, False, defs.WEIGHT_UNIFORM, 0),
    (1, 4, 12, True, defs.WEIGHT_CENTER, 0),
    (2, 1, 6, False, defs.WEIGHT_UNIFORM, 0),
    (2, 2, 12, True, defs.WEIGHT_CENTER, 0),
    (2, 3, 18, False, defs.WEIGHT_CENTER, int(defs.b2_F)),
    (2, 4, 26, True, defs.WEIGHT_UNIFORM, 0),
    (2, 2, 10, True, defs.WEIGHT_UNIFORM, int(defs.b2_F | defs.b2_X)),
    (3, 2, 16, False, defs.WEIGHT_CENTER, 0),
    (3, 3, 28, True, defs.WEIGHT_UNIFORM, 0),
    (3, 2, 14, False, defs.WEIGHT_UNIFORM, int(defs.b3_F)),
    # 3D order 4: all 35 DOFs (reference example coverage:
    # examples/wlsqm_example.py:278)
    (3, 4, 52, True, defs.WEIGHT_CENTER, 0),
    (3, 4, 48, False, defs.WEIGHT_UNIFORM, int(defs.b3_F | defs.b3_Z)),
]

# configurations whose knowns carry NONZERO prescribed values, so the
# oracle's RHS elimination term is genuinely exercised
NONZERO_KNOWN_CONFIGS = [c for c in CONFIGS if c[5]]


def _problem(rng, dimension, order, K, ragged):
    B = 17
    xi = rng.uniform(-1, 1, (B, dimension))
    xk = xi[:, None, :] + rng.uniform(-0.4, 0.4, (B, K, dimension))
    fk = np.cos(xk.sum(-1)) + 0.3 * xk[..., 0] ** 2
    nk = (rng.integers(max(K - 3, defs.number_of_dofs(dimension, order)),
                       K + 1, B).astype(np.int32)
          if ragged else np.full(B, K, np.int32))
    return B, xi, xk, fk, nk


def _check(got, xk, fk, xi, nk, order, knowns, weighting, dimension,
           fi_init=None):
    no = defs.number_of_dofs(dimension, order)
    # at order 4 the normal equations' conditioning (cond ~ 1e7+) admits
    # ~1e-9 f64 discrepancy between two correct algorithms, so the bar
    # loosens with the order
    rtol = 1e-9 if order < 4 else 5e-8
    for b in range(len(got)):
        want = _oracle_case(xk[b], fk[b], xi[b], int(nk[b]), order, knowns,
                            weighting, dimension,
                            None if fi_init is None else fi_init[b])
        np.testing.assert_allclose(
            got[b, :no], want, rtol=rtol, atol=1e-11,
            err_msg=f"case {b} (dim={dimension} order={order} "
                    f"knowns={knowns:#x} wm={weighting} nk={nk[b]})")


@pytest.mark.parametrize("dimension,order,K,ragged,weighting,knowns", CONFIGS)
def test_engine_matches_numpy_oracle(rng, dimension, order, K, ragged,
                                     weighting, knowns):
    B, xi, xk, fk, nk = _problem(rng, dimension, order, K, ragged)
    res = wt.fit_many(xk, fk, xi, nk=nk, order=order, knowns=knowns,
                      weighting=weighting)
    _check(np.asarray(res.fi), xk, fk, xi, nk, order, knowns, weighting,
           dimension)


@pytest.mark.parametrize("dimension,order,K,ragged,weighting,knowns",
                         NONZERO_KNOWN_CONFIGS)
def test_nonzero_prescribed_knowns_match_oracle(rng, dimension, order, K,
                                                ragged, weighting, knowns):
    """Prescribed known-DOF values (e.g. Neumann BC data) must flow through
    the RHS elimination; with zeros the elimination term is vacuous."""
    B, xi, xk, fk, nk = _problem(rng, dimension, order, K, ragged)
    no = defs.number_of_dofs(dimension, order)
    fi_init = np.zeros((B, no))
    for j in range(no):
        if (knowns >> j) & 1:
            fi_init[:, j] = rng.uniform(-2, 2, B)
    res = wt.fit_many(xk, fk, xi, nk=nk, order=order, knowns=knowns,
                      weighting=weighting, fi_init=fi_init)
    got = np.asarray(res.fi)
    _check(got, xk, fk, xi, nk, order, knowns, weighting, dimension,
           fi_init=fi_init)
    # the prescribed values pass through untouched
    for j in range(no):
        if (knowns >> j) & 1:
            np.testing.assert_array_equal(got[:, j], fi_init[:, j])
