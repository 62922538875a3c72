"""Functional JAX-native API for wlsqm_tpu.

The idiomatic entry point: pure functions over device arrays, composable
with ``jax.jit`` / ``vmap`` / ``shard_map``.  Every fit runs the masked
batched engine (:mod:`wlsqm_tpu.fitter.engine`) on the default JAX device,
in native float64 unless an emulation precision is requested explicitly.
The compatibility layer (:mod:`wlsqm_tpu.fitter.simple`,
:class:`wlsqm_tpu.fitter.expert.ExpertSolver`) is built on the same engine.

Typical flow::

    import wlsqm_tpu as wt

    res = wt.fit_many(xk, fk, xi, order=2)        # batched fit
    res.fi                                         # (B, NO) derivative DOFs

    prep = wt.prepare(xk, xi, order=4)             # IBVP time stepping:
    for step in range(nsteps):                     # prepare once,
        fi, _ = wt.solve(prep, fk)                 # solve many times

    vals = wt.interpolate(fi_b, xi_b, x, dimension=2, order=2, diff=wt_i2_X)
"""

from __future__ import annotations

import dataclasses
import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from wlsqm_tpu.fitter import defs, engine
from wlsqm_tpu.fitter.interp import eval_fit
from wlsqm_tpu.ops import solve as solve_ops

__all__ = ["FitResult", "FitPlan", "fit", "fit_many", "fit_stream",
           "plan_fit_many", "prepare", "solve", "interpolate"]

_PRECISIONS = (engine.PRECISION_F64, engine.PRECISION_MIXED,
               engine.PRECISION_FAST, engine.PRECISION_DS)


@dataclasses.dataclass(frozen=True)
class FitPlan:
    """A static, hashable execution plan for :func:`fit_many`.

    Computed once by :func:`plan_fit_many` for one homogeneous static
    configuration and passed back via ``fit_many(..., plan=plan)``.  It
    names the engine precision the planned calls run at; being static and
    hashable, it closes over cleanly in ``jax.jit`` / ``lax.scan`` /
    ``shard_map`` bodies.
    """

    precision: str = engine.PRECISION_F64

    def __str__(self):  # pragma: no cover - cosmetic
        return f"FitPlan(engine: {self.precision})"


@partial(
    jax.tree_util.register_dataclass,
    data_fields=("fi", "sens", "iterations", "cond_scaled"),
    meta_fields=(),
)
@dataclasses.dataclass(frozen=True)
class FitResult:
    """Result of a batched fit.

    fi          : (B, NO) solved DOFs (function value + derivatives at xi)
    sens        : (B, K, NO) sensitivities d fi / d fk, or None
    iterations  : (B,) refinement iterations taken (0 for the basic algorithm)
    cond_scaled : (B,) 2-norm condition numbers of the scaled matrices
                  (NaN unless debug=True)
    """

    fi: jax.Array
    sens: jax.Array | None
    iterations: jax.Array
    cond_scaled: jax.Array

    @property
    def ok(self) -> jax.Array:
        """(B,) per-case success flags: all solved DOFs finite.

        The reference silently ignores LAPACK failures inside its OpenMP
        regions (reference: TODO_DEFERRED.md:5-22); surfacing a per-case
        status array is the batched improvement suggested in SURVEY §5.
        """
        return jnp.isfinite(self.fi).all(axis=-1)


def _check_ds_allowed():
    """Guard an explicit precision="ds" request with the runtime canary.

    On backends where XLA degrades double-single pair chains to plain f32
    (documented risk on XLA:CPU — ops/twofloat.py), a user explicitly
    requesting ds would silently get ~1e-5-grade results; fail loudly
    instead.
    """
    import os
    import warnings

    from wlsqm_tpu.fitter import engine_ds

    if engine_ds.ds_backend_ok():
        return
    msg = (
        "double-single (ds) pair arithmetic is DEGRADED on backend %r: the "
        "runtime canary measured f32-grade results (XLA:CPU is known to "
        "fuse the pair chains; see wlsqm_tpu/ops/twofloat.py). Use "
        "precision='f64' or 'mixed', or set WLSQM_TPU_ALLOW_DEGRADED_DS=1 "
        "to proceed anyway." % jax.default_backend())
    if os.environ.get("WLSQM_TPU_ALLOW_DEGRADED_DS") == "1":
        warnings.warn(msg, stacklevel=3)
    else:
        raise ValueError(msg)


def _validate_weighting(weighting_a):
    """Reject unknown weighting ids (trace-safe: skipped for tracers).

    The engine's weight selection treats any non-CENTER id as uniform,
    so an invalid id would silently change semantics instead of failing.
    """
    if isinstance(weighting_a, jax.core.Tracer):
        return
    w_np = np.asarray(weighting_a)
    known = (defs.WEIGHT_UNIFORM, defs.WEIGHT_CENTER)
    if not np.isin(w_np, known).all():
        raise ValueError(
            "weighting must be WEIGHT_UNIFORM (%d) or WEIGHT_CENTER (%d) "
            "per case; got unknown ids %s"
            % (defs.WEIGHT_UNIFORM, defs.WEIGHT_CENTER,
               sorted(set(w_np.tolist()) - set(known))))


def _broadcast_case_param(value, B, dtype):
    arr = jnp.asarray(value, dtype)
    if arr.ndim == 0:
        arr = jnp.full((B,), arr)
    return arr


def _canon_geometry(xk, xi):
    """Coerce (B,K)/(B,) 1D layouts to (B,K,1)/(B,1); infer dimension."""
    xk = jnp.asarray(xk)
    if xk.ndim == 2:
        xk = xk[..., None]
    B, K, dim = xk.shape
    if xi is None:
        xi = jnp.zeros((B, dim), xk.dtype)
    else:
        xi = jnp.asarray(xi, xk.dtype)
        if xi.ndim == 1 and dim == 1:
            xi = xi[:, None]
    return xk, xi, B, K, dim


def fit_many(
    xk,
    fk,
    xi=None,
    *,
    nk=None,
    order=2,
    knowns=0,
    weighting=defs.WEIGHT_UNIFORM,
    fi_init=None,
    do_sens: bool = False,
    iterative: bool = False,
    max_iter: int = 10,
    max_order: int | None = None,
    debug: bool = False,
    precision: str | None = None,
    ruiz_max_iter: int = 100,
    scaling: str = "ruiz",
    solver: str = solve_ops.SOLVER_CHOLESKY,
    backend: str | None = None,
    mixed_steps: int | None = None,
    plan: FitPlan | None = None,
) -> FitResult:
    """Fit a batch of local surrogate models (JAX-native).

    xk: (B, K, dim) neighbor coordinates ((B, K) accepted for 1D)
    fk: (B, K) data values at the neighbors
    xi: (B, dim) fit origins; defaults to zeros
    nk: (B,) valid neighbor counts; defaults to K for every case
    order / knowns / weighting: scalars or (B,) arrays (scalars broadcast)
    fi_init: (B, NO) initial DOF array carrying the known values; zeros if None
    precision: None or "f64" (default: native float64, the reference's
        arithmetic), or one of the explicit emulation modes
        "mixed"/"fast"/"ds" — see :mod:`wlsqm_tpu.fitter.engine` (explicit
        "ds" is guarded by the pair-fidelity canary and raises on degraded
        backends).
    backend: deprecated and ignored.  "auto" and "xla" are accepted for
        source compatibility (every call runs the masked batched engine)
        with a DeprecationWarning; the argument will be removed.
    mixed_steps: refinement sweep count of the "mixed"/"fast" precisions
        (defaults to the class constants in :mod:`wlsqm_tpu.fitter.engine`).
    plan: a :class:`FitPlan` from :func:`plan_fit_many`; its precision
        replaces ``precision``.

    Returns a :class:`FitResult`.  Every call traces cleanly under
    ``jax.jit`` / ``lax.scan`` / ``shard_map``; for multi-device execution
    see :func:`wlsqm_tpu.parallel.sharded_fit_many`.
    """
    if backend is not None:
        if backend not in ("auto", "xla"):
            raise ValueError(
                "backend must be 'auto' or 'xla'; got %r" % (backend,))
        warnings.warn(
            "fit_many(backend=) is deprecated and ignored: every call runs "
            "the float64 engine; drop the argument", DeprecationWarning,
            stacklevel=2)
    if precision is not None and precision not in _PRECISIONS:
        raise ValueError(
            "precision must be None, 'f64', 'mixed', 'fast' or 'ds'; "
            "got %r" % (precision,))

    xk, xi, B, K, dim = _canon_geometry(xk, xi)
    fk = jnp.asarray(fk, xk.dtype)
    if fk.shape != (B, K):
        raise ValueError(
            "fk must have shape (B, K) = (%d, %d) matching xk; got %s"
            % (B, K, fk.shape))
    nk = (jnp.full((B,), K, jnp.int32) if nk is None
          else jnp.asarray(nk, jnp.int32))
    if nk.shape != (B,):
        raise ValueError(
            "nk must have shape (B,) = (%d,); got %s" % (B, nk.shape))
    order_a = _broadcast_case_param(order, B, jnp.int32)
    knowns_a = _broadcast_case_param(knowns, B, jnp.int64)
    weighting_a = _broadcast_case_param(weighting, B, jnp.int32)
    _validate_weighting(weighting_a)

    if max_order is None:
        max_order = int(np.max(np.asarray(order)))
    NO = defs.number_of_dofs(dim, max_order)
    if fi_init is not None:
        fi_init = jnp.asarray(fi_init)
        if fi_init.ndim != 2 or fi_init.shape[0] != B or fi_init.shape[1] < NO:
            raise ValueError(
                "fi_init must have shape (B, >=NO) = (%d, >=%d); got %s"
                % (B, NO, fi_init.shape))

    if plan is not None:
        precision = plan.precision
    elif precision == engine.PRECISION_DS:
        _check_ds_allowed()
    if precision is None:
        precision = engine.PRECISION_F64

    fi0 = (jnp.zeros((B, NO), xk.dtype) if fi_init is None
           else jnp.asarray(fi_init, xk.dtype))

    fi, sens, iters, cond = engine.fit_batch(
        xk, fk, nk, xi, fi0, order_a, knowns_a, weighting_a,
        dimension=dim, NO=NO, do_sens=do_sens, iterative=iterative,
        max_iter=max_iter, debug=debug,
        precision=precision, ruiz_max_iter=ruiz_max_iter,
        scaling=scaling, solver=solver, mixed_steps=mixed_steps,
    )
    return FitResult(
        fi=fi,
        sens=sens if do_sens else None,
        iterations=iters,
        cond_scaled=cond,
    )


def plan_fit_many(
    xk,
    xi=None,
    *,
    nk=None,
    order=2,
    knowns=0,
    weighting=defs.WEIGHT_UNIFORM,
    do_sens: bool = False,
    iterative: bool = False,
    precision: str | None = None,
) -> FitPlan:
    """Compute a static :class:`FitPlan` for one homogeneous configuration.

    ``order``/``knowns``/``weighting`` must be scalars (one static
    configuration).  Every configuration runs the masked batched engine,
    so the plan carries only the engine precision (native "f64" unless an
    emulation mode is pinned); the geometry arguments are accepted so that
    call sites stay valid whatever the plan comes to depend on.

    Typical use (an IBVP loop or chunked stream)::

        plan = wt.plan_fit_many(xk0, xi0, order=4, weighting=wt.WEIGHT_CENTER)
        step = jax.jit(lambda xk, fk, xi: wt.fit_many(
            xk, fk, xi, order=4, weighting=wt.WEIGHT_CENTER, plan=plan).fi)
    """
    for name, v in (("order", order), ("knowns", knowns),
                    ("weighting", weighting)):
        if np.ndim(v) != 0:
            raise ValueError(
                "plan_fit_many requires a scalar %s (homogeneous batch); "
                "heterogeneous batches call fit_many with per-case arrays"
                % name)
    if precision is not None and precision not in _PRECISIONS:
        raise ValueError(
            "precision must be None, 'f64', 'mixed', 'fast' or 'ds'; "
            "got %r" % (precision,))
    if precision == engine.PRECISION_DS:
        _check_ds_allowed()
    return FitPlan(precision=precision or engine.PRECISION_F64)


def fit_stream(xk, fk, xi=None, *, nk=None, chunk: int = 65536,
               out=None, mesh=None, **kwargs) -> FitResult:
    """Fit a cloud larger than device memory, streaming fixed-size chunks.

    Host arrays (NumPy, including ``np.memmap``) are uploaded one
    ``chunk`` at a time, fitted with :func:`fit_many`, and the solved DOFs
    land in a host-side output array — only ~two chunks of geometry are
    ever resident in device memory, so the cloud size is bounded by host
    storage, not device memory.  The loop keeps one chunk in flight: while
    chunk i computes (dispatch is asynchronous), chunk i-1's results
    transfer back, overlapping compute with host-device traffic.  The last
    partial chunk is padded to the full chunk size so every step reuses
    one compiled program.  (The reference streams nothing — its OpenMP
    loop assumes the whole problem set fits in RAM; reference:
    wlsqm/fitter/simple.pyx:953ff.)

    xk (B, K, dim) | fk (B, K) | xi (B, dim) | nk (B,) — host array-likes.
    chunk: cases per device batch (default 65536).
    out: optional preallocated (B, NO) f64 array for the DOFs.
    mesh: optional :class:`jax.sharding.Mesh` (1-D).  Each chunk is then
        uploaded sharded along its case axis and fitted with one jitted
        ``shard_map`` over the mesh — chunked streaming *and* data
        parallelism across devices at once, with the same zero-collective
        body as :func:`wlsqm_tpu.parallel.sharded_fit_many`.  The chunk
        size is rounded up to a multiple of the shard count; per-case
        parameter arrays shard along with the geometry.
    kwargs: forwarded to :func:`fit_many` (order, weighting, precision, ...);
    per-case parameter arrays are sliced along with the geometry.
    ``do_sens``/``debug`` are not supported here (their outputs would not
    stream); use :func:`fit_many` on a chunk directly.

    Returns a :class:`FitResult` whose fields are host NumPy arrays.
    """
    if kwargs.get("do_sens") or kwargs.get("debug"):
        raise ValueError("fit_stream does not support do_sens/debug; "
                         "call fit_many on individual chunks instead")
    xk = np.asarray(xk)
    if xk.ndim == 2:
        xk = xk[:, :, None]
    B, K, dim = xk.shape
    fk = np.asarray(fk)
    xi_np = None if xi is None else np.asarray(xi)
    nk_np = None if nk is None else np.asarray(nk)
    per_case = {}
    for key in ("order", "knowns", "weighting", "fi_init"):
        v = kwargs.get(key)
        if v is not None and np.ndim(v) >= 1:
            per_case[key] = np.asarray(v)

    order = kwargs.get("order", 2)
    max_order = kwargs.get("max_order") or int(np.max(np.asarray(order)))
    NO = defs.number_of_dofs(dim, max_order)
    kwargs.setdefault("max_order", max_order)

    fi_out = out if out is not None else np.empty((B, NO), np.float64)
    if fi_out.shape != (B, NO):
        raise ValueError("out must have shape (%d, %d)" % (B, NO))
    iters_out = np.zeros((B,), np.int32)

    if mesh is not None:
        return _fit_stream_sharded(
            mesh, xk, fk, xi_np, nk_np, per_case, chunk=chunk,
            fi_out=fi_out, iters_out=iters_out, NO=NO, kwargs=kwargs)

    def run(lo, hi):
        n = hi - lo
        pad = chunk - n
        def padded(a):
            if a is None:
                return None
            sl = a[lo:hi]
            if pad:
                sl = np.concatenate([sl, np.repeat(sl[:1], pad, axis=0)])
            return sl
        kw = dict(kwargs)
        for key, v in per_case.items():
            kw[key] = padded(v)
        return fit_many(padded(xk), padded(fk), padded(xi_np),
                        nk=padded(nk_np), **kw)

    pending = None  # (lo, hi, FitResult) — one chunk in flight
    for lo in range(0, B, chunk):
        hi = min(lo + chunk, B)
        res = run(lo, hi)
        if pending is not None:
            plo, phi, pres = pending
            fi_out[plo:phi] = np.asarray(pres.fi)[: phi - plo]
            iters_out[plo:phi] = np.asarray(pres.iterations)[: phi - plo]
        pending = (lo, hi, res)
    if pending is not None:
        plo, phi, pres = pending
        fi_out[plo:phi] = np.asarray(pres.fi)[: phi - plo]
        iters_out[plo:phi] = np.asarray(pres.iterations)[: phi - plo]

    return FitResult(fi=fi_out, sens=None, iterations=iters_out,
                     cond_scaled=np.full((B,), np.nan))


def _fit_stream_sharded(mesh, xk, fk, xi_np, nk_np, per_case, *, chunk,
                        fi_out, iters_out, NO, kwargs) -> FitResult:
    """Chunked streaming with each chunk data-parallel over ``mesh``.

    One jitted ``shard_map`` of :func:`fit_many` is compiled once; every
    chunk, with its per-case order/knowns/weighting/fi_init columns
    (scalars broadcast), is ``device_put`` sharded along the case axis and
    replayed through it.  The step is rounded up to a multiple of the
    shard count so each shard's slice has one shape across chunks — one
    compiled program for the whole stream, including the padded tail.
    Every case runs the same per-case engine arithmetic as an unsharded
    :func:`fit_many`, so results are identical to it.  Multi-device
    counterpart of the reference's OpenMP parallel loop over problems
    (reference: wlsqm/fitter/simple.pyx:953ff) for clouds that exceed even
    the mesh's aggregate device memory (per-case configuration is part of
    the reference's many-API contract: wlsqm/fitter/simple.pyx:318-346).
    """
    from jax.sharding import NamedSharding, PartitionSpec

    B, K, dim = xk.shape
    if xi_np is None:
        xi_np = np.zeros((B, dim), xk.dtype)
    if nk_np is None:
        nk_np = np.full((B,), K, np.int32)

    def col(key, default, dtype):
        v = per_case.get(key)
        if v is None:
            v = kwargs.get(key, default)
        v = np.asarray(v, dtype)
        return np.broadcast_to(v, (B,)) if v.ndim == 0 else v

    order_c = col("order", 2, np.int32)
    knowns_c = col("knowns", 0, np.int64)
    weighting_c = col("weighting", defs.WEIGHT_UNIFORM, np.int32)
    _validate_weighting(weighting_c)
    fi_init = per_case.get("fi_init")
    fi_init = (np.zeros((B, NO), xk.dtype) if fi_init is None
               else np.asarray(fi_init, xk.dtype)[:, :NO])

    n_shards = int(mesh.devices.size)
    spec = PartitionSpec(mesh.axis_names[0])
    shard = NamedSharding(mesh, spec)
    step = -(-min(chunk, B) // n_shards) * n_shards
    kw = {k: v for k, v in kwargs.items()
          if k not in ("order", "knowns", "weighting", "fi_init")}

    def local(xk_, fk_, nk_, xi_, o_, kn_, wm_, fi0_):
        res = fit_many(xk_, fk_, xi_, nk=nk_, order=o_, knowns=kn_,
                       weighting=wm_, fi_init=fi0_, **kw)
        return res.fi, res.iterations

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(spec,) * 8,
        out_specs=(spec, spec), check_vma=False))

    def drain(pending):
        plo, phi, pfi, pit = pending
        fi_out[plo:phi] = np.asarray(pfi)[: phi - plo]
        iters_out[plo:phi] = np.asarray(pit)[: phi - plo]

    pending = None
    for lo in range(0, B, step):
        hi = min(lo + step, B)
        pad = step - (hi - lo)

        def padded(a):
            sl = np.asarray(a[lo:hi])
            if pad:
                sl = np.concatenate([sl, np.repeat(sl[:1], pad, axis=0)])
            return sl

        args = [jax.device_put(padded(a), shard)
                for a in (xk, fk, nk_np, xi_np, order_c, knowns_c,
                          weighting_c, fi_init)]
        fi_c, it_c = fn(*args)
        if pending is not None:
            drain(pending)
        pending = (lo, hi, fi_c, it_c)
    if pending is not None:
        drain(pending)

    return FitResult(fi=fi_out, sens=None, iterations=iters_out,
                     cond_scaled=np.full((B,), np.nan))


def fit(xk, fk, xi=None, **kwargs) -> FitResult:
    """Single-neighborhood convenience wrapper: a batch of one.

    xk: (K, dim) or (K,) for 1D; fk: (K,); xi: (dim,) or scalar.
    The returned FitResult has its leading batch axis squeezed away.
    """
    xk = jnp.asarray(xk)
    if xk.ndim == 1:
        xk = xk[:, None]
    if xi is None:
        xi_b = None
    else:
        xi_arr = jnp.asarray(xi, xk.dtype).reshape(-1)
        xi_b = xi_arr[None, :]
    fi_init = kwargs.pop("fi_init", None)
    if fi_init is not None:
        fi_init = jnp.asarray(fi_init)[None, :]
    res = fit_many(xk[None], jnp.asarray(fk)[None], xi_b,
                   fi_init=fi_init, **kwargs)
    return FitResult(
        fi=res.fi[0],
        sens=None if res.sens is None else res.sens[0],
        iterations=res.iterations[0],
        cond_scaled=res.cond_scaled[0],
    )


def prepare(
    xk,
    xi=None,
    *,
    nk=None,
    order=2,
    knowns=0,
    weighting=defs.WEIGHT_UNIFORM,
    max_order: int | None = None,
    solver: str = solve_ops.SOLVER_CHOLESKY,
    debug: bool = False,
    precision: str = engine.PRECISION_F64,
    ruiz_max_iter: int = 100,
    scaling: str = "ruiz",
) -> engine.Prepared:
    """Prepare geometry for repeated solves (JAX-native expert mode).

    Returns a :class:`wlsqm_tpu.fitter.engine.Prepared` pytree — pass it to
    :func:`solve`.  Being an ordinary pytree, it can be donated, checkpointed,
    or shared between fields (the reference's "guest mode",
    reference: wlsqm/fitter/expert.pyx:110-124, is simply object reuse here).
    """
    if precision == engine.PRECISION_DS:
        _check_ds_allowed()
    xk, xi, B, K, dim = _canon_geometry(xk, xi)
    if xi.shape[0] != B:
        raise ValueError(
            "xi must have shape (B, dim) = (%d, %d) matching xk; got %s"
            % (B, dim, xi.shape))
    nk = (jnp.full((B,), K, jnp.int32) if nk is None
          else jnp.asarray(nk, jnp.int32))
    if nk.shape != (B,):
        raise ValueError(
            "nk must have shape (B,) = (%d,); got %s" % (B, nk.shape))
    order_a = _broadcast_case_param(order, B, jnp.int32)
    knowns_a = _broadcast_case_param(knowns, B, jnp.int64)
    weighting_a = _broadcast_case_param(weighting, B, jnp.int32)
    _validate_weighting(weighting_a)
    if max_order is None:
        max_order = int(np.max(np.asarray(order)))
    NO = defs.number_of_dofs(dim, max_order)
    return partial(
        jax.jit,
        static_argnames=("dimension", "NO", "solver", "debug",
                     "ruiz_max_iter", "ruiz_eps", "precision", "scaling"),
    )(engine.prepare)(
        xk, nk, xi, order_a, knowns_a, weighting_a,
        dimension=dim, NO=NO, solver=solver, debug=debug,
        precision=precision, ruiz_max_iter=ruiz_max_iter, scaling=scaling,
    )


def solve(
    prep: engine.Prepared,
    fk,
    fi_init=None,
    *,
    do_sens: bool = False,
    iterative: bool = False,
    max_iter: int = 10,
    mixed_steps: int | None = None,
):
    """Solve prepared systems against data ``fk``.

    fk (B, K) solves one field; fk (F, B, K) solves F fields against the
    same prepared geometry in one call (factorizations reused, neighbor
    gathers amortized — the batched form of the reference's guest-solver
    pattern).  Returns (fi, sens) for the basic algorithm, or
    (fi, sens, iterations) with ``iterative=True``; outputs carry the
    leading field axis when fk does.
    """
    fk = jnp.asarray(fk)
    B_p, K_p = prep.c.shape[0], prep.c.shape[1]
    if fk.shape[-2:] != (B_p, K_p) or fk.ndim not in (2, 3):
        raise ValueError(
            "fk must have shape (B, K) = (%d, %d) matching the prepared "
            "geometry (or (F, B, K) for multi-field); got %s"
            % (B_p, K_p, fk.shape))
    if fk.ndim == 3:
        # multi-field: fk (F, B, K) — one call solves every field against
        # the same prepared geometry (the reference handles this with guest
        # solvers sharing factored matrices, reference:
        # wlsqm/fitter/expert.pyx:110-124; here it is a vmap over fields,
        # amortizing the neighbor gather and reusing one factorization)
        fi0 = (jnp.zeros((fk.shape[0], prep.ncases, prep.no_max), fk.dtype)
               if fi_init is None else jnp.asarray(fi_init, fk.dtype))
        if iterative:
            fn = jax.vmap(
                lambda fk_f, fi_f: engine.solve_iterative_prepared(
                    prep, fk_f, fi_f, max_iter=max_iter, do_sens=do_sens,
                    mixed_steps=mixed_steps))
        else:
            fn = jax.vmap(
                lambda fk_f, fi_f: engine.solve_prepared(
                    prep, fk_f, fi_f, do_sens=do_sens,
                    mixed_steps=mixed_steps))
        return jax.jit(fn)(fk, fi0)
    fi0 = (jnp.zeros((prep.ncases, prep.no_max), fk.dtype)
           if fi_init is None else jnp.asarray(fi_init, fk.dtype))

    def run():
        if iterative:
            return jax.jit(
                engine.solve_iterative_prepared,
                static_argnames=("max_iter", "do_sens", "mixed_steps"),
            )(prep, fk, fi0, max_iter=max_iter, do_sens=do_sens,
              mixed_steps=mixed_steps)
        return jax.jit(
            engine.solve_prepared, static_argnames=("do_sens", "mixed_steps")
        )(prep, fk, fi0, do_sens=do_sens, mixed_steps=mixed_steps)

    try:
        return run()
    except ValueError as e:  # pragma: no cover - jit-cache defect workaround
        # Round-2 observed a pjit argument-pruning mismatch ("Execution
        # supplied N buffers...") when re-executing a cached executable
        # against a structurally identical but freshly materialized
        # Prepared (e.g. loaded from a checkpoint).  A round-3 root-cause
        # attempt could NOT reproduce it on jax 0.9.0 (npz and orbax
        # round-trips of f64/mixed/ds Prepared all re-execute cleanly —
        # tests/test_serialization.py), so it was likely fixed upstream.
        # The guard stays, but scoped: retry through a FRESH jit wrapper
        # (new function identity -> new cache entry -> recompiles exactly
        # this one program) instead of round 2's jax.clear_caches(),
        # which nuked every compiled program in the process.
        if "buffers" not in str(e):
            raise
        if iterative:
            fresh = jax.jit(
                lambda p, f, i: engine.solve_iterative_prepared(
                    p, f, i, max_iter=max_iter, do_sens=do_sens,
                    mixed_steps=mixed_steps))
        else:
            fresh = jax.jit(
                lambda p, f, i: engine.solve_prepared(
                    p, f, i, do_sens=do_sens, mixed_steps=mixed_steps))
        return fresh(prep, fk, fi0)


def interpolate(fi, xi, x, *, dimension: int, order: int, diff: int = 0):
    """Evaluate fitted models (or their derivatives) at query points.

    Thin alias of :func:`wlsqm_tpu.fitter.interp.eval_fit`; batch axes of
    fi/xi/x broadcast.
    """
    return eval_fit(fi, xi, x, dimension=dimension, order=order, diff=diff)
