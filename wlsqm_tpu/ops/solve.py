"""Batched small dense factor/solve front-end.

The reference LU-factors each (scaled) normal matrix with LAPACK dgetrf and
back-substitutes with dgetrs (reference: wlsqm/utils/lapackdrivers.pyx:1415-1463,
wlsqm/fitter/impl.pyx:686,826).  Here the idiomatic choice is Cholesky:
the WLSQM normal matrix A = Cᵀ·diag(w)·C is SPD, and symmetric Ruiz
equilibration preserves SPD-ness, so ``jnp.linalg.cholesky`` (natively batched
in XLA) plus two batched triangular solves replace the LU pair.  A
non-SPD matrix yields NaN factors (no exception), which the per-case
``FitResult.ok`` flags report.  An LU mode is kept for parity debugging.

All functions are batched over arbitrary leading axes and jit-safe.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

SOLVER_CHOLESKY = "chol"
SOLVER_LU = "lu"
SOLVER_CHOLESKY_UNROLLED = "chol_unrolled"

# Above this size, unrolling the factorization at trace time stops paying off
# (graph size ~ n^3/6 ops); WLSQM never exceeds n = 35.
_UNROLL_MAX_N = 40


def factor(A: jax.Array, solver: str = SOLVER_CHOLESKY):
    """Factor a batch of square matrices. Returns an opaque factorization."""
    if solver == SOLVER_CHOLESKY_UNROLLED:
        from wlsqm_tpu.ops import smallchol

        if A.shape[-1] <= _UNROLL_MAX_N:
            return (smallchol.cholesky_factor(A),)
        solver = SOLVER_CHOLESKY  # fall back for out-of-range sizes
    if solver == SOLVER_CHOLESKY:
        return (jnp.linalg.cholesky(A),)
    elif solver == SOLVER_LU:
        lu, pivots, _ = lax.linalg.lu(A)
        return (lu, pivots)
    raise ValueError("unknown solver %r" % (solver,))


def solve_factored(fac, b: jax.Array, solver: str = SOLVER_CHOLESKY) -> jax.Array:
    """Solve A x = b given ``fac = factor(A)``.

    b: (..., n, m) multi-RHS (the sensitivity path solves all nk RHS at once,
    improving on the reference's per-k loop, reference: wlsqm/fitter/impl.pyx:831-834).
    """
    if solver == SOLVER_CHOLESKY_UNROLLED:
        from wlsqm_tpu.ops import smallchol

        (L,) = fac
        if isinstance(L, tuple):
            return smallchol.cholesky_solve(L, b)
        solver = SOLVER_CHOLESKY  # fell back at factor time
    if solver == SOLVER_CHOLESKY:
        (L,) = fac
        y = lax.linalg.triangular_solve(L, b, left_side=True, lower=True)
        return lax.linalg.triangular_solve(
            L, y, left_side=True, lower=True, transpose_a=True
        )
    elif solver == SOLVER_LU:
        lu, pivots = fac
        perm = lax.linalg.lu_pivots_to_permutation(pivots, lu.shape[-1])
        b_perm = jnp.take_along_axis(b, perm[..., :, None], axis=-2)
        y = lax.linalg.triangular_solve(
            lu, b_perm, left_side=True, lower=True, unit_diagonal=True
        )
        return lax.linalg.triangular_solve(lu, y, left_side=True, lower=False)
    raise ValueError("unknown solver %r" % (solver,))


@partial(jax.jit, static_argnames=("solver",))
def solve(A: jax.Array, b: jax.Array, solver: str = SOLVER_CHOLESKY) -> jax.Array:
    """One-shot batched solve (factor + back-substitute)."""
    return solve_factored(factor(A, solver), b, solver)


def cond_2norm(A: jax.Array) -> jax.Array:
    """Batched 2-norm condition number via singular values.

    Mirrors the reference's debug-mode computation
    (reference: wlsqm/fitter/impl.pyx:661-682, via dgesvd).
    """
    s = jnp.linalg.svd(A, compute_uv=False)
    return s[..., 0] / s[..., -1]
