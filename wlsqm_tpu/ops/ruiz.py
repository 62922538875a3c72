"""Batched Ruiz-2001 l∞ row/column equilibration.

Reproduces the scalar iteration of the reference
(reference: wlsqm/utils/lapackdrivers.pyx:553-623 ``rescale_ruiz2001_c``):
starting from accumulated scalings DRprev = DCprev = 1, each sweep computes

    DR[j] = sqrt( max_m |A[j,m]| / (DRprev[j] * DCprev[m]) )
    DC[m] = sqrt( max_j |A[j,m]| / (DRprev[j] * DCprev[m]) )

(both sweeps read the *previous* iterates), accumulates
``DRprev *= DR``, ``row_scale /= DR`` (ditto for columns), and stops when
``max_j |1 - DR[j]^2| < eps`` and ``max_m |1 - DC[m]^2| < eps`` with
``eps = 1e-15``, capped at 100 iterations.

This version is vectorized over a leading batch axis with a per-problem
convergence mask (converged problems freeze with DR = DC = 1), inside a
``lax.while_loop`` so XLA compiles one fused loop for the whole batch.
For symmetric A the row and column factors coincide, so symmetry (and SPD-ness)
of the scaled matrix is preserved — which is what lets the downstream solver
use Cholesky on the scaled normal matrix.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

RUIZ_EPS = 1e-15
RUIZ_MAX_ITER = 100


def ruiz_scale(A: jax.Array, max_iter: int = RUIZ_MAX_ITER, eps: float = RUIZ_EPS):
    """Compute Ruiz row/column scaling factors for a batch of square matrices.

    Args:
      A: (..., n, n) array. Not modified; apply the scaling yourself as
         ``A_scaled = row_scale[..., :, None] * A * col_scale[..., None, :]``
         (reference convention: one *multiplies* by the returned factors,
         reference: wlsqm/utils/lapackdrivers.pyx:285-299 ``apply_scaling``).

    Returns:
      (row_scale, col_scale, iterations): shapes (..., n), (..., n), (...,).
      ``iterations`` is the per-problem sweep count taken (for diagnostics,
      mirroring the reference's return value).
    """
    absA = jnp.abs(A)

    # Derive every loop carry from A (ones_like/zeros_like) so that under
    # shard_map the carries inherit A's varying-axes metadata and the
    # while_loop typechecks on sharded inputs.
    ones_n = jnp.ones_like(A[..., :, 0])

    def cond(state):
        k, done, *_ = state
        return jnp.logical_and(k < max_iter, ~done.all())

    def body(state):
        k, done, dr_prev, dc_prev, row_scale, col_scale, iters = state
        # ratio[j, m] = |A[j,m]| with current accumulated scaling applied
        ratio = absA / (dr_prev[..., :, None] * dc_prev[..., None, :])
        row_max = ratio.max(axis=-1)
        col_max = ratio.max(axis=-2)
        dr = jnp.sqrt(jnp.where(row_max > 0, row_max, 1.0))
        dc = jnp.sqrt(jnp.where(col_max > 0, col_max, 1.0))
        # frozen (converged) problems take no update
        dr = jnp.where(done[..., None], ones_n, dr)
        dc = jnp.where(done[..., None], ones_n, dc)

        dr_prev = dr_prev * dr
        dc_prev = dc_prev * dc
        row_scale = row_scale / dr
        col_scale = col_scale / dc

        # stopping rule on the *squared* factors = the l∞ norms themselves
        row_conv = jnp.abs(1.0 - dr * dr).max(axis=-1) < eps
        col_conv = jnp.abs(1.0 - dc * dc).max(axis=-1) < eps
        newly_done = jnp.logical_and(row_conv, col_conv)
        iters = jnp.where(done, iters, iters + 1)
        done = jnp.logical_or(done, newly_done)
        return (k + 1, done, dr_prev, dc_prev, row_scale, col_scale, iters)

    init = (
        jnp.array(0, jnp.int32),
        jnp.zeros_like(ones_n[..., 0], dtype=bool),
        ones_n,
        ones_n,
        ones_n,
        ones_n,
        jnp.zeros_like(ones_n[..., 0], dtype=jnp.int32),
    )
    _, _, _, _, row_scale, col_scale, iters = lax.while_loop(cond, body, init)
    # The scaling is a pure preconditioner: the downstream solve
    # row-scales the RHS and col-unscales the solution, so the fit result
    # is EXACTLY invariant to the returned factors (C (RAC)^-1 R b =
    # A^-1 b for any diagonal R, C) and the true Jacobian through them is
    # zero.  Stopping gradients here is therefore exact, and it makes the
    # equilibration loop transparent to reverse-mode AD (lax.while_loop
    # has no transpose rule) — jax.grad/jacrev through the fit w.r.t. the
    # geometry works; see tests/test_autodiff.py.
    return lax.stop_gradient(row_scale), lax.stop_gradient(col_scale), iters


def apply_scaling(A: jax.Array, row_scale: jax.Array, col_scale: jax.Array) -> jax.Array:
    """Scale A in the reference's convention (multiply by the factors)."""
    return row_scale[..., :, None] * A * col_scale[..., None, :]


def jacobi_scale(A: jax.Array):
    """One-pass symmetric Jacobi scaling: D = 1/sqrt(diag(A)).

    For SPD matrices Jacobi scaling is within a factor n of the optimal
    symmetric diagonal scaling (van der Sluis 1969), and it needs no
    iteration — a single elementwise pass instead of Ruiz's l∞ sweeps.  Used
    by the f32 emulation modes, where the scaling only preconditions the f32
    factorization and any residual conditioning slack is absorbed by the
    f64 refinement loop.

    Returns (row_scale, col_scale, iterations) like :func:`ruiz_scale`.
    """
    d = jnp.diagonal(A, axis1=-2, axis2=-1)
    s = jnp.where(d > 0, 1.0 / jnp.sqrt(jnp.where(d > 0, d, 1.0)), 1.0)
    iters = jnp.ones_like(s[..., 0], dtype=jnp.int32)
    # exact-zero true Jacobian, same argument as in ruiz_scale: the fit
    # result is invariant to the preconditioner, so stop gradients rather
    # than backpropagating rounding-level noise terms through the scaling
    return lax.stop_gradient(s), lax.stop_gradient(s), iters
