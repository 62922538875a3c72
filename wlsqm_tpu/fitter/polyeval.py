"""Polynomial surrogate evaluation.

Batched counterpart of the reference's hand-unrolled FMA Horner evaluators
(reference: wlsqm/fitter/polyeval.pyx taylor_{1,2,3}D / general_{1,2,3}D).
Instead of per-order symmetric Horner forms, evaluation is a dot product of
the coefficient vector with the (factorial-baked or plain) monomial basis row
— the same contraction the fitting matrix uses, so the model interpolated
during iterative refinement is evaluated by the identical code path, exactly
as in the reference design (reference: wlsqm/fitter/interp.pyx:34-41).

Two coefficient conventions:

* ``taylor``: "partially baked" coefficients — entries are the *derivative
  values* of the surrogate at xi; the 1/m! normalization lives in the basis
  (reference: wlsqm/fitter/polyeval.pyx:58-74).
* ``general``: plain polynomial coefficients of (x - xi) monomials
  (reference: wlsqm/fitter/polyeval.pyx general_*).

All functions are jit/vmap-safe for JAX inputs and also accept NumPy.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from wlsqm_tpu.fitter import defs, tables
from wlsqm_tpu.fitter.engine import basis

__all__ = [
    "taylor", "general",
    "taylor_1D", "taylor_2D", "taylor_3D",
    "general_1D", "general_2D", "general_3D",
]


def _delta(x, xi, dimension):
    x = jnp.asarray(x, jnp.float64)
    xi = jnp.asarray(xi, jnp.float64)
    if dimension == 1:
        x = x.reshape(-1, 1)
        xi = xi.reshape(1)
    return x - xi


def taylor(dimension: int, order: int, fi, xi, x) -> jax.Array:
    """Evaluate the surrogate with partially-baked coefficients ``fi`` at ``x``.

    x: (n, dim) points (or (n,) in 1D). Returns (n,) values.
    """
    no = defs.number_of_dofs(dimension, order)
    c = basis(_delta(x, xi, dimension), dimension, no)      # (n, no)
    fi = jnp.asarray(fi, c.dtype)[:no]
    return c @ fi


def general(dimension: int, order: int, fi, xi, x) -> jax.Array:
    """Evaluate a plain polynomial (coefficients of (x-xi) monomials) at ``x``."""
    no = defs.number_of_dofs(dimension, order)
    c = basis(_delta(x, xi, dimension), dimension, no)      # baked basis
    # un-bake: the plain monomial is baked_c / invfact, so fold the factor
    # into the coefficient vector instead of the (larger) basis matrix
    invfact = jnp.asarray(tables.INV_FACT[dimension][:no], c.dtype)
    fi = jnp.asarray(fi, c.dtype)[:no]
    return c @ (fi / invfact)


def taylor_1D(order, fi, xi, x):
    """1D partially-baked evaluation (reference: wlsqm/fitter/polyeval.pyx:874)."""
    return taylor(1, order, fi, xi, x)


def taylor_2D(order, fi, xi, x):
    """2D partially-baked evaluation (reference: wlsqm/fitter/polyeval.pyx:550)."""
    return taylor(2, order, fi, xi, x)


def taylor_3D(order, fi, xi, x):
    """3D partially-baked evaluation (reference: wlsqm/fitter/polyeval.pyx:82)."""
    return taylor(3, order, fi, xi, x)


def general_1D(order, fi, xi, x):
    """1D plain-coefficient evaluation (reference: wlsqm/fitter/polyeval.pyx:955)."""
    return general(1, order, fi, xi, x)


def general_2D(order, fi, xi, x):
    """2D plain-coefficient evaluation (reference: wlsqm/fitter/polyeval.pyx:741)."""
    return general(2, order, fi, xi, x)


def general_3D(order, fi, xi, x):
    """3D plain-coefficient evaluation (reference: wlsqm/fitter/polyeval.pyx:361)."""
    return general(3, order, fi, xi, x)
