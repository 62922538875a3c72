"""Independent SciPy float64 reference for the engine's fit semantics.

The plain per-case reference that the tests, ``chip_smoke.py`` and
``bench.py`` compare the batched engine with.  Each case is solved the
textbook way, without the engine's masking, Ruiz equilibration or
Cholesky: the weighted design matrix sqrt(W)·C over the unknown DOFs, its
columns scaled to unit norm, goes to ``scipy.linalg.lstsq`` (an SVD
solve, whose error grows with the scaled cond(C) rather than
cond(CᵀWC)), with known DOFs eliminated into the data (reference:
wlsqm/fitter/impl.pyx:789-818).  The column scaling is exact algebra;
without it, small neighbourhoods (radius h) leave the degree-d columns
O(h^d) and the SVD's error on high-order DOFs grows as h^-d.
Sensitivities are (CᵀWC)⁻¹CᵀW = pinv(sqrt(W)·C)·sqrt(W) (reference:
impl.pyx:768-846).

``fit_cases_ld`` is a second witness for cases where two f64 solvers
disagree: the same least-squares problem, built from the same f64 inputs
but solved entirely in ``np.longdouble`` by Householder QR, so its own
rounding sits orders of magnitude below either f64 solver's.
"""

import numpy as np
import scipy.linalg

from wlsqm_tpu.fitter import defs, tables

WEIGHT_ALPHA = 1e-4


def problem(rng, dimension, order, B=8):
    """A well-conditioned random test batch: (xk, fk, xi, K)."""
    no = defs.number_of_dofs(dimension, order)
    K = max(no + no // 2 + 2, 4)
    xi = rng.uniform(-1, 1, (B, dimension))
    xk = xi[:, None, :] + rng.uniform(-1, 1, (B, K, dimension))
    fk = np.sin(1.3 * xk[..., 0]) * np.cos(0.7 * xk.sum(-1)) + 0.2
    return xk, fk, xi, K


def _design(xk, xi, order, weighting, dimension):
    """(C, w) of a batch (..., K, dim); works in the inputs' float type."""
    no = defs.number_of_dofs(dimension, order)
    exp = tables.EXPONENTS[dimension][:no]
    d = xk - xi[..., None, :]
    c = np.prod(d[..., None, :] ** exp, axis=-1)
    c = c * tables.INV_FACT[dimension][:no].astype(d.dtype)
    d2 = (d * d).sum(-1)
    if weighting == defs.WEIGHT_CENTER:
        t = 1.0 - np.sqrt(d2 / d2.max(-1, keepdims=True))
        w = WEIGHT_ALPHA + (1.0 - WEIGHT_ALPHA) * t * t
    else:
        w = np.ones_like(d2)
    return c, w


def _known_mask(knowns, no):
    return np.array([(int(knowns) >> j) & 1 for j in range(no)], bool)


def fit_case(xk, fk, xi, order, knowns, weighting, dimension, fi_init):
    """DOFs of one case; known DOFs keep their ``fi_init`` values.

    A ragged case (fewer valid neighbours than rows) is passed sliced to
    its valid rows.
    """
    c, w = _design(xk, xi, order, weighting, dimension)
    no = c.shape[1]
    known = _known_mask(knowns, no)
    fi = np.array(fi_init[:no], np.float64)
    resid = fk - c[:, known] @ fi[known]
    a = np.sqrt(w)[:, None] * c[:, ~known]
    norm = np.linalg.norm(a, axis=0)
    sol, *_ = scipy.linalg.lstsq(a / norm, np.sqrt(w) * resid)
    fi[~known] = sol / norm
    return fi


def fit_cases_ld(xk, fk, xi, order, knowns, weighting, dimension, fi_init):
    """``fit_case`` for a batch (M, K, dim) of one configuration, solved in
    long double: the witness that tells which of two f64 solvers is off.

    Returns float64 DOFs (M, NO).  Raises where ``np.longdouble`` is no
    wider than float64, since it would then witness nothing.
    """
    ld = np.longdouble
    if np.finfo(ld).eps > 1e-18:
        raise RuntimeError("np.longdouble has no extended precision here")
    c, w = _design(np.asarray(xk, ld), np.asarray(xi, ld), order, weighting,
                   dimension)
    no = c.shape[-1]
    known = _known_mask(knowns, no)
    fi = np.array(fi_init[:, :no], ld)
    sw = np.sqrt(w)
    b = sw * (np.asarray(fk, ld) - np.einsum("mkj,mj->mk", c[..., known],
                                             fi[:, known]))
    a = sw[..., None] * c[..., ~known]
    norm = np.sqrt((a * a).sum(-2))
    fi[:, ~known] = _lstsq_householder(a / norm[:, None, :], b) / norm
    return fi.astype(np.float64)


def _lstsq_householder(a, b):
    """min ||a x - b|| for a batch a (M, K, n), b (M, K) of full column
    rank, by Householder QR in the arrays' own float type."""
    a, b = a.copy(), b.copy()
    n = a.shape[-1]
    for j in range(n):
        v = a[:, j:, j].copy()
        alpha = np.sqrt((v * v).sum(-1))
        alpha = np.where(v[:, 0] < 0, alpha, -alpha)
        v[:, 0] -= alpha
        vv = (v * v).sum(-1)
        a[:, j:, j:] -= (2.0 * v)[:, :, None] * (
            np.einsum("mk,mkn->mn", v, a[:, j:, j:]) / vv[:, None])[:, None]
        b[:, j:] -= (2.0 * v) * ((v * b[:, j:]).sum(-1) / vv)[:, None]
    x = np.zeros(b.shape[:1] + (n,), a.dtype)
    for j in range(n - 1, -1, -1):
        x[:, j] = (b[:, j] - (a[:, j, j + 1:n] * x[:, j + 1:]).sum(-1)) \
            / a[:, j, j]
    return x


def sens_case(xk, xi, order, weighting, dimension):
    """(K, NO) sensitivities d fi / d fk of one case with no knowns."""
    c, w = _design(xk, xi, order, weighting, dimension)
    sw = np.sqrt(w)
    a = sw[:, None] * c
    norm = np.linalg.norm(a, axis=0)
    return (scipy.linalg.pinv(a / norm) / norm[:, None] * sw).T


def linf_rel(got, want):
    """L∞ error relative to the reference's own magnitude (floored at 1)."""
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))
