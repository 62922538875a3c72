"""Unrolled batched Cholesky for tiny matrices (n <= 35).

XLA's ``jnp.linalg.cholesky`` / ``triangular_solve`` are built for large
matrices and may lower a batch of 15x15 systems to padded tiles or a
column-recursive loop.  WLSQM's normal matrices are at most 35x35 (3D
order 4), so here the factorization is fully unrolled at trace time over
matrix *entries*: every L[i][j] is a (B, ...)-shaped vector and the n^3/6
multiply-subtract chain becomes one big fused elementwise XLA computation
over the batch axis — the device sees long (B,)-vectors, never a padded
matrix tile.  Selected with ``solver="chol_unrolled"``.

This mirrors how the reference leans on LAPACK for small dense systems
(reference: wlsqm/utils/lapackdrivers.pyx dgetrf/dgetrs usage) but maps the
"one small system per core" pattern to "one batch lane per system".
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["cholesky_factor", "cholesky_solve"]


def cholesky_factor(A):
    """Batched Cholesky of (..., n, n) SPD matrices, unrolled over entries.

    Returns the lower factor as a tuple-of-tuples of (...,)-shaped arrays
    (row-major, lower triangle only): L[i][j] for j <= i.
    """
    n = A.shape[-1]
    a = [[A[..., i, j] for j in range(i + 1)] for i in range(n)]
    L = [[None] * (i + 1) for i in range(n)]
    for j in range(n):
        s = a[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = jnp.sqrt(s)
        L[j][j] = d
        inv = 1.0 / d
        for i in range(j + 1, n):
            t = a[i][j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t * inv
    return tuple(tuple(row) for row in L)


def cholesky_solve(L, b):
    """Solve A x = b given the unrolled factor; b is (..., n, m) multi-RHS.

    Forward + back substitution unrolled over rows; each step works on
    (..., m)-shaped vectors.
    """
    n = len(L)
    bs = [b[..., i, :] for i in range(n)]
    # forward: L y = b
    y = [None] * n
    for i in range(n):
        t = bs[i]
        for k in range(i):
            t = t - L[i][k][..., None] * y[k]
        y[i] = t / L[i][i][..., None]
    # backward: L^T x = y
    x = [None] * n
    for i in range(n - 1, -1, -1):
        t = y[i]
        for k in range(i + 1, n):
            t = t - L[k][i][..., None] * x[k]
        x[i] = t / L[i][i][..., None]
    return jnp.stack(x, axis=-2)
