"""Double-single (ds) engine path: f64-class accuracy from f32 arithmetic.

An explicit emulation mode for devices whose float64 rate is low (the
default everywhere is native float64).  The ``precision="ds"`` mode removes
bulk f64 from the entire fit:

* basis rows, weights, RHS contraction and refinement residual matvecs run
  in double-single arithmetic (:mod:`wlsqm_tpu.ops.twofloat`): (hi, lo) f32
  pairs with ~48-bit effective mantissa, a few native f32 flops per op;
* the O(n^2)/O(n^3) work — normal-matrix assembly (matmul), Jacobi/Ruiz
  scaling, Cholesky factorization and substitutions — runs in plain f32,
  which is harmless because the factorization is only a *preconditioner*:
  the refinement loop iterates the f32 solve to the fixed point of the ds
  normal equations, whose accuracy is set by the ds residuals (~1e-13).

This reproduces the reference's f64 semantics (weights, knowns elimination,
factorial-normalized basis; reference: wlsqm/fitter/impl.pyx) to ~1e-12
relative, comfortably inside the 1e-10 parity bar, while every hot op is a
native f32 instruction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from wlsqm_tpu.fitter import defs, tables
from wlsqm_tpu.ops import twofloat as tf
from wlsqm_tpu.ops import ruiz as ruiz_ops
from wlsqm_tpu.ops import solve as solve_ops

# refinement sweeps: error contracts by ~cond(scaled A) * eps_f32 per sweep
DS_REFINE_STEPS = 3
DS_SENS_REFINE_STEPS = 2

WEIGHT_ALPHA = 1e-4
WEIGHT_BETA = 1.0 - WEIGHT_ALPHA

# ds-fidelity canary results, cached per backend name
_DS_CANARY: dict[str, bool] = {}

# bump when the canary's methodology changes: persisted verdicts from an
# older canary must not be trusted
_CANARY_VERSION = 1


def _canary_store():
    """Path of the persisted canary-verdict file, or None (not enabled)."""
    import os

    from wlsqm_tpu import config

    return os.path.join(config.cache_dir(), "ds_canary.json")


def _canary_key(backend: str) -> str:
    return f"v{_CANARY_VERSION}:{backend}:jax-{jax.__version__}"


def _load_persisted_verdict(backend: str):
    """Persisted canary verdict for this (backend, jax version), or None."""
    path = _canary_store()
    if not path:
        return None
    import json

    try:
        with open(path) as f:
            return json.load(f).get(_canary_key(backend))
    except (OSError, ValueError):  # missing or corrupt: just re-measure
        return None


def _persist_verdict(backend: str, ok: bool) -> None:
    """Record the verdict (atomic replace; best-effort, never raises)."""
    path = _canary_store()
    if not path:
        return
    import json
    import os
    import tempfile

    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}
        data[_canary_key(backend)] = bool(ok)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
        with os.fdopen(fd, "w") as f:
            json.dump(data, f, indent=1)
        os.replace(tmp, path)
    except OSError:  # read-only cache dir etc.: the in-process cache stands
        pass


def _run_ds_canary() -> bool:
    """End-to-end pair-fidelity check of the ds engine on this backend.

    XLA:CPU can fuse-and-duplicate the pair-arithmetic chains in large
    graphs, silently degrading double-single to plain f32 (see
    ops/twofloat.py docstring).  A micro-canary could pass while the real
    pipeline degrades, so this runs the ACTUAL ds engine on a small
    deterministic order-4 batch and compares against the f64 engine:
    intact pairs land ~1e-12 relative; degraded pairs land ~1e-5.
    """
    from wlsqm_tpu.fitter import engine

    B, K, dim, order = 256, 24, 2, 4
    NO = defs.number_of_dofs(dim, order)
    i = np.arange(B)[:, None] * K + np.arange(K)[None, :]
    xk = np.stack([np.cos(0.7 * i + 0.1), np.sin(1.3 * i + 0.2)], axis=-1)
    xi = np.zeros((B, dim))
    fk = np.sin(1.1 * xk[..., 0]) * np.cos(0.9 * xk[..., 1])
    args = (jnp.asarray(xk), jnp.asarray(fk),
            jnp.full((B,), K, jnp.int32), jnp.asarray(xi),
            jnp.zeros((B, NO)), jnp.full((B,), order, jnp.int32),
            jnp.zeros((B,), jnp.int64),
            jnp.full((B,), defs.WEIGHT_UNIFORM, jnp.int32))
    fi_ds = np.asarray(engine.fit_batch(
        *args, dimension=dim, NO=NO, precision="ds")[0])
    fi_64 = np.asarray(engine.fit_batch(
        *args, dimension=dim, NO=NO, precision="f64")[0])
    rel = np.abs(fi_ds - fi_64).max() / np.abs(fi_64).max()
    return bool(np.isfinite(rel) and rel < 1e-9)


def ds_backend_ok() -> bool:
    """Whether double-single arithmetic is trustworthy on this backend.

    Every platform runs :func:`_run_ds_canary` (XLA:CPU is the known
    degrader — see ops/twofloat.py) once and caches the verdict —
    in-process always, and on disk (keyed by backend + jax version) in the
    persistent cache directory (:func:`wlsqm_tpu.config.cache_dir`), so
    the two engine compiles are one-time per machine rather than per
    process.  The api layer raises on an explicit ``precision="ds"``
    request when this is False (override: ``WLSQM_TPU_ALLOW_DEGRADED_DS=1``
    downgrades to a warning).

    The platform is read from the actual device list, not
    ``jax.default_backend()``: the verdict must key on where the pair
    arithmetic really executes.
    """
    try:
        backend = jax.devices()[0].platform
    except Exception:  # pragma: no cover - no devices initialised
        backend = jax.default_backend()
    if backend not in _DS_CANARY:
        # the verdict survives across processes in the persistent cache
        # directory — the two engine compiles become one-time per machine
        # per jax version, like the XLA compilation cache
        persisted = _load_persisted_verdict(backend)
        if persisted is None:
            verdict = _run_ds_canary()
            _persist_verdict(backend, verdict)
            _DS_CANARY[backend] = verdict
        else:
            _DS_CANARY[backend] = bool(persisted)
    return _DS_CANARY[backend]


def _where_pair(mask, x, y):
    return jnp.where(mask, x[0], y[0]), jnp.where(mask, x[1], y[1])


def _zero_pair_like(x):
    return jnp.zeros_like(x[0]), jnp.zeros_like(x[1])


def basis_ds(delta, dimension: int, NO: int):
    """Baked monomial basis rows in ds arithmetic.

    delta: ds pair of (..., dim).  Returns a ds pair of (..., NO).
    Power sequence mirrors the reference (d2 = d*d, d3 = d2*d, d4 = d2*d2,
    reference: wlsqm/fitter/impl.pyx:107-117).
    """
    exp = tables.EXPONENTS[dimension][:NO]
    invfact = tables.INV_FACT[dimension][:NO]
    max_pow = int(exp.max()) if NO > 1 else 0

    cols = []
    for a in range(dimension):
        d = (delta[0][..., a], delta[1][..., a])
        powers = [(jnp.ones_like(d[0]), jnp.zeros_like(d[0])), d]
        if max_pow >= 2:
            d2 = tf.mul(d, d)
            powers.append(d2)
            if max_pow >= 3:
                powers.append(tf.mul(d2, d))
                if max_pow >= 4:
                    powers.append(tf.mul(d2, d2))
        hi = jnp.stack([p[0] for p in powers], axis=-1)
        lo = jnp.stack([p[1] for p in powers], axis=-1)
        cols.append((hi[..., exp[:, a]], lo[..., exp[:, a]]))
    c = cols[0]
    for col in cols[1:]:
        c = tf.mul(c, col)
    # factorial normalization as ds constants (1/6, 1/24 are not f32-exact)
    if_pair = tf.from_f64(jnp.asarray(invfact, jnp.float64))
    return tf.mul(c, (jnp.broadcast_to(if_pair[0], c[0].shape),
                      jnp.broadcast_to(if_pair[1], c[0].shape)))


def weights_ds(d2, kmask, weighting):
    """Fitting weights in ds arithmetic (reference: wlsqm/fitter/infra.pyx:668-702)."""
    d2 = _where_pair(kmask, d2, _zero_pair_like(d2))
    # neighborhood max of d2: order by hi, break ties by lo
    max_hi = d2[0].max(axis=-1, keepdims=True)
    is_max = d2[0] == max_hi
    max_lo = jnp.where(is_max, d2[1], -jnp.inf).max(axis=-1, keepdims=True)
    max_pair = (jnp.broadcast_to(max_hi, d2[0].shape),
                jnp.broadcast_to(max_lo, d2[0].shape))
    safe = max_pair[0] > 0
    ratio = tf.div(d2, _where_pair(safe, max_pair,
                                   (jnp.ones_like(max_pair[0]),
                                    jnp.zeros_like(max_pair[1]))))
    tmp = tf.add_f32(tf.neg(tf.sqrt(ratio)), jnp.float32(1.0))
    t2 = tf.mul(tmp, tmp)
    beta = tf.from_f64(jnp.float64(WEIGHT_BETA))
    alpha = tf.from_f64(jnp.float64(WEIGHT_ALPHA))
    center = tf.add(tf.mul(t2, (jnp.broadcast_to(beta[0], t2[0].shape),
                                jnp.broadcast_to(beta[1], t2[0].shape))),
                    (jnp.broadcast_to(alpha[0], t2[0].shape),
                     jnp.broadcast_to(alpha[1], t2[0].shape)))
    ones = (jnp.ones_like(center[0]), jnp.zeros_like(center[1]))
    w = _where_pair(weighting[..., None] == defs.WEIGHT_CENTER, center, ones)
    return _where_pair(kmask, w, _zero_pair_like(w))


def dot_ds_last(c, v):
    """ds contraction over the last axis: sum_j c[..., j] * v[..., j]."""
    return tf.sum_along(tf.mul(c, v), axis=-1)


def prepare_ds(xk, nk, xi, order, knowns, weighting, *, dimension, NO,
               solver, debug, ruiz_max_iter, scaling, dof_masks_fn):
    """ds-mode geometry preparation; returns the pieces for Prepared."""
    B, K, _ = xk.shape
    kmask = jnp.arange(K, dtype=nk.dtype)[None, :] < nk[:, None]

    xk_ds = tf.from_f64(xk)
    xi_ds = tf.from_f64(xi)
    delta = tf.sub(xk_ds, (xi_ds[0][:, None, :], xi_ds[1][:, None, :]))
    delta = _where_pair(kmask[:, :, None], delta, _zero_pair_like(delta))
    d2 = tf.sum_along(tf.mul(delta, delta), axis=-1)         # pair (B,K)

    # exact power-of-two radius normalization (see engine.radius_pow2_scale):
    # keeps basis columns O(1) so the f32 preconditioner stays well scaled
    h2 = jnp.where(kmask, d2[0], 0.0).max(axis=-1)
    e_s = jnp.ceil(0.5 * jnp.log2(jnp.where(h2 > 0, h2, 1.0)))
    inv_s = jnp.exp2(-e_s)
    delta = tf.mul_f32(delta, inv_s[:, None, None])
    d2 = tf.mul_f32(d2, (inv_s * inv_s)[:, None])
    deg = jnp.asarray(tables.DEGREE[dimension][:NO], jnp.float64)
    dof_scale = jnp.exp2(-e_s.astype(jnp.float64)[:, None] * deg[None, :])

    c = basis_ds(delta, dimension, NO)                       # pair (B,K,NO)
    w = weights_ds(d2, kmask, weighting)                     # pair (B,K)

    active, known, unknown = dof_masks_fn(order, knowns, dimension, NO)

    # f32 assembly (the preconditioner doesn't need ds fidelity)
    cw32 = c[0] * w[0][..., None]
    # HIGHEST: keep f32 contractions out of TF32 (see engine)
    A = jnp.einsum("bkj,bkm->bjm", cw32, c[0],
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    unk2 = jnp.logical_and(unknown[:, :, None], unknown[:, None, :])
    eye = jnp.eye(NO, dtype=jnp.float32)
    A = jnp.where(unk2, A, 0.0) + jnp.where(unknown, 0.0, 1.0)[:, :, None] * eye

    if scaling == "jacobi":
        row_scale, col_scale, ruiz_iters = ruiz_ops.jacobi_scale(A)
    else:
        row_scale, col_scale, ruiz_iters = ruiz_ops.ruiz_scale(
            A, max_iter=ruiz_max_iter, eps=1e-6)
    A_scaled = ruiz_ops.apply_scaling(A, row_scale, col_scale)

    if debug:
        cond_orig = solve_ops.cond_2norm(A.astype(jnp.float64))
        cond_scaled = solve_ops.cond_2norm(A_scaled.astype(jnp.float64))
    else:
        cond_orig = jnp.full((B,), jnp.nan, jnp.float64)
        cond_scaled = jnp.full((B,), jnp.nan, jnp.float64)

    fac = solve_ops.factor(A_scaled, solver)
    return dict(
        c=c[0], c_lo=c[1], w=w[0], w_lo=w[1], fac=fac, dof_scale=dof_scale,
        row_scale=row_scale, col_scale=col_scale,
        active=active, known=known, unknown=unknown,
        cond_orig=cond_orig, cond_scaled=cond_scaled, ruiz_iters=ruiz_iters,
    )


# -----------------------------------------------------------------------------
# Solving against a ds-prepared state
# -----------------------------------------------------------------------------

def _c_pair(prep):
    return (prep.c, prep.c_lo)


def _w_pair(prep):
    return (prep.w, prep.w_lo)


def matvec_scaled_ds(prep, x):
    """A_scaled @ x through the ds basis rows; x is a ds pair of (B, NO, m)."""
    unk = prep.unknown[..., :, None]
    cs = prep.col_scale[..., :, None]
    rs = prep.row_scale[..., :, None]
    xs = _where_pair(unk, tf.mul_f32(x, cs), _zero_pair_like(x))
    c = _c_pair(prep)
    # t[b,k,m] = sum_j c[b,k,j] xs[b,j,m]
    t = tf.sum_along(
        tf.mul((c[0][:, :, :, None], c[1][:, :, :, None]),
               (xs[0][:, None, :, :], xs[1][:, None, :, :])),
        axis=2)
    w = _w_pair(prep)
    t = tf.mul(t, (w[0][..., None], w[1][..., None]))
    # y[b,j,m] = sum_k c[b,k,j] t[b,k,m]
    y = tf.sum_along(
        tf.mul((c[0][:, :, :, None], c[1][:, :, :, None]),
               (t[0][:, :, None, :], t[1][:, :, None, :])),
        axis=1)
    y = tf.mul_f32(y, rs)
    return _where_pair(unk, y, x)


def solve_scaled_ds(prep, b, refine_steps=DS_REFINE_STEPS):
    """Solve A_scaled X = B (ds pair (B, NO, m)) via f32 factor + ds refinement.

    The refinement runs as a fori_loop so the (large) solve+matvec body is
    traced and compiled once, not ``refine_steps`` times — compile time for
    the ds graph drops several-fold.
    """
    from jax import lax

    unk = prep.unknown[..., :, None]
    x32 = solve_ops.solve_factored(prep.fac, b[0], prep.solver)
    x = (jnp.where(unk, x32, b[0]), jnp.zeros_like(x32))

    def body(_, x):
        r = tf.sub(b, matvec_scaled_ds(prep, x))
        dx = solve_ops.solve_factored(prep.fac, r[0], prep.solver)
        return tf.add(x, (jnp.where(unk, dx, 0.0), jnp.zeros_like(dx)))

    return lax.fori_loop(0, refine_steps, body, x)


def rhs_ds(prep, resid):
    """Row-scaled masked RHS pair: b_j = rs_j * sum_k w_k resid_k c[k,j].

    resid: ds pair (B, K).  Returns ds pair (B, NO, 1).
    """
    w = _w_pair(prep)
    t = tf.mul(resid, w)                                     # (B, K)
    c = _c_pair(prep)
    b = tf.sum_along(tf.mul(c, (t[0][..., None], t[1][..., None])), axis=1)
    b = tf.mul_f32(b, prep.row_scale)
    b = _where_pair(prep.unknown, b, _zero_pair_like(b))
    return (b[0][..., None], b[1][..., None])


def model_eval_ds(prep, fi):
    """Evaluate the model at the data points: out[k] = sum_j c[k,j] fi[j].

    fi: ds pair (B, NO).  Returns ds pair (B, K).
    """
    c = _c_pair(prep)
    return tf.sum_along(
        tf.mul(c, (fi[0][:, None, :], fi[1][:, None, :])), axis=-1)


def _pow2_f32_factors(scale, invert=False):
    """Split an exact f64 power of two into two exact f32 pow2 factors.

    ``scale`` is ``exp2(-e_s * deg)`` by construction (:func:`prepare_ds`).
    A single f32 cast overflows/underflows once ``|e_s| * deg`` exceeds
    ~126 (point spacings beyond ~1e-9 at order 4); splitting the exponent
    in halves keeps every factor — and the balanced intermediate product —
    exactly representable out to ``|e_s| * deg <= 252``, i.e. the full f64
    normal range of the scale itself.  Multiplying a pair component by the
    two factors in sequence stays exact (each factor is a power of two).
    """
    e = jnp.round(jnp.log2(jnp.abs(scale)))     # exact: scale is +-2^e
    if invert:
        e = -e
    h = jnp.trunc(e * 0.5)
    return (jnp.exp2(h).astype(jnp.float32),
            jnp.exp2(e - h).astype(jnp.float32))


def solve_prepared_ds_pair(prep, fk_pair, fi_pair=None):
    """Pair-in/pair-out basic solve: ZERO f64 ops, for ds-resident loops.

    :func:`solve_prepared_ds` takes f64 ``fk`` and returns f64 ``fi``;
    on a device whose f64 rate is low, the elementwise f64 ops on the
    (B, K)/(B, NO) boundary arrays can dominate tight stepping loops.
    Here ``fk_pair`` is a ds (hi, lo) f32 pair (B, K) and the result is a
    ds pair (B, NO); with a row gather of both planes an IBVP step touches
    no f64 at all.

    ``fi_pair`` (ds pair (B, NO)) supplies prescribed values for known
    DOFs (reference knowns-elimination semantics,
    reference: wlsqm/fitter/impl.pyx:789-818); known slots pass through to
    the output.  With ``fi_pair=None`` known DOFs are treated as 0 and the
    output carries zeros there.

    Exactness note: ``prep.dof_scale`` is a power of two by construction
    (exp2 of an integer exponent times an integer degree, see
    :func:`prepare_ds`), so applying it per component in f32 is exact.
    Rendered via ``tf.to_f64`` the result matches :func:`solve_prepared_ds`
    at the ds representation floor (~1e-16 abs; with ``fi_pair=None`` the
    zero-model subtraction is skipped, so residual pairs can carry a
    different but value-equal (hi, lo) decomposition) — pinned in
    tests/test_precision_modes.py.
    """
    kmask = prep.w > 0
    fk_ds = _where_pair(kmask, fk_pair, _zero_pair_like(fk_pair))
    if fi_pair is not None:
        # dof_scale is +-pow2: per-component f32 scaling is exact
        ia, ib = _pow2_f32_factors(prep.dof_scale, invert=True)
        known_vals = _where_pair(
            prep.known, (fi_pair[0] * ia * ib, fi_pair[1] * ia * ib),
            _zero_pair_like(fi_pair))
        model_known = model_eval_ds(prep, known_vals)
        resid = _where_pair(kmask, tf.sub(fk_ds, model_known),
                            _zero_pair_like(fk_ds))
    else:
        resid = fk_ds
    b = rhs_ds(prep, resid)
    x = solve_scaled_ds(prep, b)
    fi_scaled = tf.mul_f32((x[0][..., 0], x[1][..., 0]), prep.col_scale)
    da, db = _pow2_f32_factors(prep.dof_scale)
    fi_out = (fi_scaled[0] * da * db, fi_scaled[1] * da * db)
    if fi_pair is not None:
        return _where_pair(prep.unknown, fi_out, fi_pair)
    return _where_pair(prep.unknown, fi_out, _zero_pair_like(fi_out))


def solve_prepared_ds(prep, fk, fi, do_sens):
    """ds-mode counterpart of engine.solve_prepared; fk/fi are f64."""
    kmask = prep.w > 0
    fk_ds = tf.from_f64(jnp.where(kmask, fk, 0.0))
    known_vals = tf.from_f64(
        jnp.where(prep.known, fi, 0.0) / prep.dof_scale)
    model_known = model_eval_ds(prep, known_vals)
    resid = _where_pair(kmask, tf.sub(fk_ds, model_known),
                        _zero_pair_like(fk_ds))
    b = rhs_ds(prep, resid)
    x = solve_scaled_ds(prep, b)
    fi_scaled = tf.mul_f32((x[0][..., 0], x[1][..., 0]), prep.col_scale)
    fi_out = jnp.where(prep.unknown, tf.to_f64(fi_scaled) * prep.dof_scale, fi)

    sens = None
    if do_sens:
        # S[b,j,k] = rs_j w_k c[k,j] for unknown j (ds), all nk RHS at once
        c = _c_pair(prep)
        w = _w_pair(prep)
        S = tf.mul((c[0].swapaxes(-1, -2), c[1].swapaxes(-1, -2)),
                   (w[0][:, None, :], w[1][:, None, :]))      # (B, NO, K)
        S = tf.mul_f32(S, prep.row_scale[..., None])
        S = _where_pair(prep.unknown[..., None], S, _zero_pair_like(S))
        X = solve_scaled_ds(prep, S, refine_steps=DS_SENS_REFINE_STEPS)
        sens64 = tf.to_f64(X).swapaxes(-1, -2) \
            * prep.col_scale.astype(jnp.float64)[..., None, :]
        sens64 = sens64 * prep.dof_scale[..., None, :]
        sens64 = jnp.where(prep.unknown[..., None, :], sens64, 0.0)
        sens = jnp.where(prep.known[..., None, :], jnp.nan, sens64)
    return fi_out, sens


def solve_iterative_prepared_ds(prep, fk, fi, max_iter, do_sens,
                                fixed_trip=False):
    """ds-mode iterative refinement (ALGO_ITERATIVE semantics).

    Stagnation on exact equality of the l∞ residual norm, as in the
    reference (reference: wlsqm/fitter/impl.pyx:1026-1083); norms are the
    f64 renderings of the ds residuals.  ``fixed_trip=True`` runs the same
    body as a fixed-length ``lax.scan`` (bit-identical; reverse-mode
    capable) instead of the early-exiting ``while_loop``.
    """
    from jax import lax

    fi1, sens = solve_prepared_ds(prep, fk, fi, do_sens)
    kmask = prep.w > 0
    fk_ds = tf.from_f64(jnp.where(kmask, fk, 0.0))

    def body_core(done, fi_cur, prev_norm, iters):
        fi_ds = tf.from_f64(
            jnp.where(prep.active, fi_cur, 0.0) / prep.dof_scale)
        model = model_eval_ds(prep, fi_ds)
        resid = _where_pair(kmask, tf.sub(fk_ds, model),
                            _zero_pair_like(fk_ds))
        norm = jnp.abs(tf.to_f64(resid)).max(axis=-1)
        done_now = jnp.logical_or(done, norm == prev_norm)

        b = rhs_ds(prep, resid)
        dxp = solve_scaled_ds(prep, b)
        corr = tf.to_f64(tf.mul_f32((dxp[0][..., 0], dxp[1][..., 0]),
                                    prep.col_scale)) * prep.dof_scale
        fi_new = jnp.where(prep.unknown, fi_cur + corr, fi_cur)
        fi_next = jnp.where(done_now[:, None], fi_cur, fi_new)
        iters = iters + jnp.logical_not(done_now).astype(jnp.int32)
        return (done_now, fi_next, norm, iters)

    init_core = (
        jnp.zeros_like(fk[:, 0], dtype=bool),
        fi1,
        jnp.full_like(fk[:, 0], -1.0),
        jnp.zeros_like(fk[:, 0], dtype=jnp.int32),
    )
    if fixed_trip:
        def scan_body(state, _):
            return body_core(*state), None

        (_, fi_out, _, iters), _ = lax.scan(
            scan_body, init_core, None, length=max_iter)
        return fi_out, sens, iters

    def cond(state):
        i, done, *_ = state
        return jnp.logical_and(i < max_iter, jnp.logical_not(done.all()))

    def body(state):
        i = state[0]
        return (i + 1,) + body_core(*state[1:])

    _, _, fi_out, _, iters = lax.while_loop(
        cond, body, (jnp.array(0, jnp.int32),) + init_core)
    return fi_out, sens, iters
