"""Simple API: drop-in equivalents of the reference's 24 fitting entry points.

(reference: wlsqm/fitter/simple.pyx:60-604 — ``fit_{1D,2D,3D}`` ×
{basic, iterative} × {single, many, many_parallel}.)

These are the NumPy-facing convenience wrappers: they accept the same
array layouts as the reference, write results **in place** into the caller's
``fi`` (and ``sens``) arrays, and return the refinement iteration count.
Internally every variant lowers to one batched, jit-compiled XLA program
(:func:`wlsqm_tpu.fitter.engine.fit_batch`) in float64 on the default JAX
device; there is no serial/parallel distinction — the ``*_many_parallel``
variants are the same compiled program, with ``ntasks`` accepted for source
compatibility and ignored (sharding across devices replaces OpenMP
threading; see :mod:`wlsqm_tpu.parallel`).

For new JAX-native code prefer :mod:`wlsqm_tpu.fitter.engine` /
:func:`wlsqm_tpu.api.fit` directly: pure functions, device arrays in/out,
jit/vmap/shard_map-composable.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from wlsqm_tpu.fitter import defs
from wlsqm_tpu.fitter import engine


def _bucket(n: int, minimum: int = 8) -> int:
    """Round up to the next power of two (>= minimum).

    The compat API pads batch and neighbor axes to bucketed sizes so that
    repeated calls with organically varying shapes reuse a handful of
    compiled programs instead of recompiling per shape.  Padding cases are
    all-knowns no-ops; padded neighbors carry zero weight.
    """
    m = minimum
    while m < n:
        m *= 2
    return m

__all__ = [
    "fit_1D", "fit_1D_iterative", "fit_1D_many", "fit_1D_iterative_many",
    "fit_1D_many_parallel", "fit_1D_iterative_many_parallel",
    "fit_2D", "fit_2D_iterative", "fit_2D_many", "fit_2D_iterative_many",
    "fit_2D_many_parallel", "fit_2D_iterative_many_parallel",
    "fit_3D", "fit_3D_iterative", "fit_3D_many", "fit_3D_iterative_many",
    "fit_3D_many_parallel", "fit_3D_iterative_many_parallel",
]


def _fit_many_host(
    dimension,
    xk,
    fk,
    nk,
    xi,
    fi,
    sens,
    do_sens,
    order,
    knowns,
    weighting_method,
    iterative,
    max_iter,
    debug,
):
    """Shared host-side driver for all many-case variants.

    Handles layout coercion, runs the batched engine, and copies results back
    into the caller's arrays (after the full batch completes — preserving the
    reference's aliasing guarantee that fk may view the fi array,
    reference: wlsqm/fitter/simple.pyx:1010-1016).
    """
    xk = np.asarray(xk, dtype=np.float64)
    fk = np.asarray(fk, dtype=np.float64)
    nk = np.asarray(nk, dtype=np.int32)
    order = np.asarray(order, dtype=np.int32)
    knowns = np.asarray(knowns, dtype=np.int64)
    weighting_method = np.asarray(weighting_method, dtype=np.int32)

    B, K = xk.shape[0], xk.shape[1]
    if dimension == 1:
        xk_b = xk[:, :, None]
        xi_b = np.asarray(xi, dtype=np.float64).reshape(B, 1)
    else:
        xk_b = xk
        xi_b = np.asarray(xi, dtype=np.float64)

    NO = defs.number_of_dofs(dimension, int(order.max()))
    fi_np = np.asarray(fi, dtype=np.float64)
    fi_in = np.ascontiguousarray(fi_np[:, :NO])

    # bucket the batch/neighbor axes so organically varying sizes reuse a
    # few compiled programs; padded cases are all-known order-0 no-ops and
    # padded neighbors are masked out by nk
    Bp, Kp = _bucket(B), _bucket(K)
    if Kp != K:
        xk_b = np.concatenate(
            [xk_b, np.zeros((B, Kp - K, xk_b.shape[2]))], axis=1)
        fk = np.concatenate([fk, np.zeros((B, Kp - K))], axis=1)
    if Bp != B:
        pad = Bp - B
        xk_b = np.concatenate([xk_b, np.zeros((pad, Kp, xk_b.shape[2]))])
        fk = np.concatenate([fk, np.zeros((pad, Kp))])
        nk = np.concatenate([nk, np.ones(pad, np.int32)])
        xi_b = np.concatenate([xi_b, np.zeros((pad, xi_b.shape[1]))])
        fi_in = np.concatenate([fi_in, np.zeros((pad, NO))])
        order = np.concatenate([order, np.zeros(pad, np.int32)])
        knowns = np.concatenate([knowns, np.ones(pad, np.int64)])
        weighting_method = np.concatenate(
            [weighting_method, np.full(pad, defs.WEIGHT_UNIFORM, np.int32)])

    fi_out, sens_out, iters, _conds = engine.fit_batch(
        jnp.asarray(xk_b),
        jnp.asarray(fk),
        jnp.asarray(nk),
        jnp.asarray(xi_b),
        jnp.asarray(fi_in),
        jnp.asarray(order),
        jnp.asarray(knowns),
        jnp.asarray(weighting_method),
        dimension=dimension,
        NO=NO,
        do_sens=bool(do_sens),
        iterative=bool(iterative),
        max_iter=int(max_iter),
        debug=bool(debug),
    )

    fi[:, :NO] = np.asarray(fi_out)[:B]
    if do_sens:
        if sens is None:
            raise ValueError("do_sens=True requires a sens output array")
        sens[:, :K, :NO] = np.asarray(sens_out)[:B, :K]
    return int(np.asarray(iters)[:B].max(initial=0))


def _fit_one_host(
    dimension, xk, fk, xi, fi, sens, do_sens, order, knowns,
    weighting_method, iterative, max_iter, debug,
):
    """Single-case wrapper: a many-case batch of size 1."""
    xk = np.asarray(xk, dtype=np.float64)
    nk = np.array([xk.shape[0]], dtype=np.int32)
    if dimension == 1:
        xi_b = np.array([np.float64(xi)])
    else:
        xi_b = np.asarray(xi, dtype=np.float64)[None, :]
    fi_view = np.asarray(fi)[None, :]
    sens_view = None if sens is None else np.asarray(sens)[None, :, :]
    return _fit_many_host(
        dimension,
        xk[None, ...],
        np.asarray(fk, dtype=np.float64)[None, :],
        nk,
        xi_b,
        fi_view,
        sens_view,
        do_sens,
        np.array([order], dtype=np.int32),
        np.array([knowns], dtype=np.int64),
        np.array([weighting_method], dtype=np.int32),
        iterative,
        max_iter,
        debug,
    )


# -----------------------------------------------------------------------------
# Public API — signatures mirror the reference (reference: wlsqm/fitter/simple.pyx)
# -----------------------------------------------------------------------------

def _make_single(dimension, iterative, default_knowns):
    if iterative:
        def fit(xk, fk, xi, fi, sens=None, do_sens=0, order=2,
                knowns=default_knowns, weighting_method=defs.WEIGHT_CENTER,
                max_iter=10, debug=0):
            return _fit_one_host(dimension, xk, fk, xi, fi, sens, do_sens,
                                 order, knowns, weighting_method, True,
                                 max_iter, debug)
    else:
        def fit(xk, fk, xi, fi, sens=None, do_sens=0, order=2,
                knowns=default_knowns, weighting_method=defs.WEIGHT_CENTER,
                debug=0):
            return _fit_one_host(dimension, xk, fk, xi, fi, sens, do_sens,
                                 order, knowns, weighting_method, False,
                                 10, debug)
    return fit


def _make_many(dimension, iterative):
    if iterative:
        def fit(xk, fk, nk, xi, fi, sens, do_sens, order, knowns,
                weighting_method, max_iter=10, debug=0):
            return _fit_many_host(dimension, xk, fk, nk, xi, fi, sens,
                                  do_sens, order, knowns, weighting_method,
                                  True, max_iter, debug)
    else:
        def fit(xk, fk, nk, xi, fi, sens, do_sens, order, knowns,
                weighting_method, debug=0):
            return _fit_many_host(dimension, xk, fk, nk, xi, fi, sens,
                                  do_sens, order, knowns, weighting_method,
                                  False, 10, debug)
    return fit


def _make_many_parallel(dimension, iterative):
    if iterative:
        def fit(xk, fk, nk, xi, fi, sens, do_sens, order, knowns,
                weighting_method, max_iter=10, ntasks=8, debug=0):
            # ntasks accepted for source compatibility; the batch is one
            # compiled program (multi-chip scaling is a sharding concern).
            return _fit_many_host(dimension, xk, fk, nk, xi, fi, sens,
                                  do_sens, order, knowns, weighting_method,
                                  True, max_iter, debug)
    else:
        def fit(xk, fk, nk, xi, fi, sens, do_sens, order, knowns,
                weighting_method, ntasks=8, debug=0):
            return _fit_many_host(dimension, xk, fk, nk, xi, fi, sens,
                                  do_sens, order, knowns, weighting_method,
                                  False, 10, debug)
    return fit


_DEFAULT_KNOWNS = {1: defs.b1_F, 2: defs.b2_F, 3: defs.b3_F}

fit_1D = _make_single(1, False, _DEFAULT_KNOWNS[1])
fit_1D_iterative = _make_single(1, True, _DEFAULT_KNOWNS[1])
fit_1D_many = _make_many(1, False)
fit_1D_iterative_many = _make_many(1, True)
fit_1D_many_parallel = _make_many_parallel(1, False)
fit_1D_iterative_many_parallel = _make_many_parallel(1, True)

fit_2D = _make_single(2, False, _DEFAULT_KNOWNS[2])
fit_2D_iterative = _make_single(2, True, _DEFAULT_KNOWNS[2])
fit_2D_many = _make_many(2, False)
fit_2D_iterative_many = _make_many(2, True)
fit_2D_many_parallel = _make_many_parallel(2, False)
fit_2D_iterative_many_parallel = _make_many_parallel(2, True)

fit_3D = _make_single(3, False, _DEFAULT_KNOWNS[3])
fit_3D_iterative = _make_single(3, True, _DEFAULT_KNOWNS[3])
fit_3D_many = _make_many(3, False)
fit_3D_iterative_many = _make_many(3, True)
fit_3D_many_parallel = _make_many_parallel(3, False)
fit_3D_iterative_many_parallel = _make_many_parallel(3, True)

for _dim in (1, 2, 3):
    for _name, _doc in (
        ("fit_%dD", "Fit one local model to %dD scalar data."),
        ("fit_%dD_iterative",
         "Fit one local model to %dD scalar data, with iterative refinement."),
        ("fit_%dD_many", "Fit many local models to %dD scalar data (batched)."),
        ("fit_%dD_iterative_many",
         "Fit many local models to %dD scalar data (batched), with iterative refinement."),
        ("fit_%dD_many_parallel",
         "Fit many local models to %dD scalar data (batched; ntasks accepted for compatibility)."),
        ("fit_%dD_iterative_many_parallel",
         "Fit many local models to %dD scalar data (batched, iterative; ntasks accepted for compatibility)."),
    ):
        _f = globals()[_name % _dim]
        _f.__name__ = _name % _dim
        _f.__qualname__ = _f.__name__
        _f.__doc__ = (
            (_doc % _dim)
            + "\n\nArray layouts, defaults and in-place output semantics follow the"
            " reference API\n(reference: wlsqm/fitter/simple.pyx); computation is one"
            " batched XLA program on the\ndefault JAX device. Returns the number of"
            " refinement iterations taken (0 for the\nbasic algorithm)."
        )
del _dim, _name, _doc, _f
