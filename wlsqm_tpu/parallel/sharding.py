"""Multi-device scaling: data-parallel sharding of the case axis.

The reference's only parallelism is OpenMP threads over independent local
problems within one process (reference: wlsqm/fitter/simple.pyx prange sites;
SURVEY §2 parallelism row).  The multi-device counterpart is pure data
parallelism: every case's (xk, fk, A, fi) lives on the shard that owns it, the
fit path needs **zero** inter-device communication, and scaling out is just
laying the case axis across a 1-D device mesh.

Two entry points:

* :func:`sharded_fit_many` — ``shard_map`` of the batched engine over the
  case axis: guaranteed-local execution, no collectives in the compiled
  program.  This is the throughput path for large clouds.
* :func:`distribute` — lay existing arrays onto the mesh with
  ``NamedSharding`` and let GSPMD propagate (useful when composing with a
  larger jitted program, e.g. an IBVP time-stepping loop that also does
  global reductions).

Cross-shard communication appears only in *global* operations built on top:
gathering neighborhoods from a distributed cloud and evaluating the patched
global model near shard boundaries (an all-gather of the small coefficient
arrays, see :func:`replicated_coefficients`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from wlsqm_tpu.fitter import engine
from wlsqm_tpu.ops import solve as solve_ops

CASE_AXIS = "cases"


def make_mesh(
    n_devices: int | None = None,
    axis_name: str = CASE_AXIS,
    devices=None,
) -> Mesh:
    """A 1-D device mesh over the first ``n_devices`` available devices.

    ``devices`` overrides device discovery (e.g. to pin a virtual CPU mesh).
    """
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    return Mesh(np.array(devs[:n_devices]), (axis_name,))


def distribute(mesh: Mesh, *arrays, axis_name: str = CASE_AXIS):
    """Place arrays on the mesh, sharded along their leading (case) axis."""
    sharding = NamedSharding(mesh, P(axis_name))
    out = tuple(jax.device_put(a, sharding) for a in arrays)
    return out if len(out) != 1 else out[0]


def pad_cases(n: int, n_shards: int) -> int:
    """Smallest padded case count divisible by the shard count."""
    return ((n + n_shards - 1) // n_shards) * n_shards


def sharded_fit_many(
    mesh: Mesh,
    xk,
    fk,
    nk,
    xi,
    fi,
    order,
    knowns,
    weighting,
    *,
    dimension: int,
    NO: int,
    do_sens: bool = False,
    iterative: bool = False,
    max_iter: int = 10,
    solver: str = solve_ops.SOLVER_CHOLESKY,
    axis_name: str = CASE_AXIS,
):
    """Fit a batch of cases sharded across the mesh's case axis.

    All case-indexed inputs must have a leading axis divisible by the mesh
    size (use :func:`pad_cases` + zero/eye padding rows; padded cases are
    harmless — they solve tiny identity systems).  Returns
    (fi_out, sens, iterations, cond_scaled) with the same sharding.

    The body is exactly the single-device engine; ``shard_map`` guarantees
    the compiled program contains no cross-device collectives (the parallel ≡
    serial equivalence test of the reference becomes "sharded ≡ single
    device" here).
    """

    def local_fit(xk, fk, nk, xi, fi, order, knowns, weighting):
        return engine.fit_batch(
            xk, fk, nk, xi, fi, order, knowns, weighting,
            dimension=dimension, NO=NO, do_sens=do_sens,
            iterative=iterative, max_iter=max_iter, solver=solver,
        )

    spec = P(axis_name)
    fn = jax.shard_map(
        local_fit,
        mesh=mesh,
        in_specs=(spec,) * 8,
        out_specs=(spec, spec, spec, spec),
    )
    return jax.jit(fn)(
        jnp.asarray(xk), jnp.asarray(fk), jnp.asarray(nk), jnp.asarray(xi),
        jnp.asarray(fi), jnp.asarray(order), jnp.asarray(knowns),
        jnp.asarray(weighting),
    )


def replicated_coefficients(mesh: Mesh, fi, axis_name: str = CASE_AXIS):
    """All-gather the (small) solved coefficient arrays to every device.

    Global interpolation of the patched model may read local models owned by
    other shards (reference analogue: the kNN/radius patching in
    wlsqm/fitter/expert.pyx:830-986).  Coefficients are tiny (NO ≤ 35
    doubles per case), so a full replication between devices is the simple, fast
    layout for the query side.
    """
    def gather(x):
        return jax.lax.all_gather(x, axis_name, axis=0, tiled=True)

    # check_vma off: the all_gather output is replicated by construction, but
    # the static varying-axes checker cannot infer that through tiled=True
    fn = jax.shard_map(
        gather, mesh=mesh, in_specs=P(axis_name), out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fn)(jnp.asarray(fi))


def sharded_interpolate_continuous(mesh: Mesh, fi, xi, x, r, *,
                                   dimension: int, order: int, diff: int = 0,
                                   axis_name: str = CASE_AXIS):
    """Continuous patched-model interpolation over a sharded cloud.

    The local models (fi, xi) are sharded over the mesh's case axis; the
    query points replicate.  Each shard blends its own models into partial
    (weighted-sum, weight) accumulators with
    :func:`wlsqm_tpu.fitter.interp.interpolate_continuous`, and one ``psum``
    pair combines them — the only collective in the pipeline.
    Device-side replacement for the reference's host-side radius-query
    blending (reference: wlsqm/fitter/expert.pyx:898-986).

    fi (B, no) | xi (B, dim) | x (Q, dim) | r scalar.
    Returns (Q,) blended values (NaN where no model is within r).
    """
    from wlsqm_tpu.fitter.interp import interpolate_continuous

    n = mesh.devices.size
    B = np.asarray(xi).shape[0]
    Bp = pad_cases(B, n)
    fi = jnp.asarray(fi)
    xi = jnp.asarray(xi)
    valid = jnp.arange(Bp) < B
    if Bp != B:
        fi = jnp.concatenate([fi, jnp.zeros((Bp - B, fi.shape[1]), fi.dtype)])
        xi = jnp.concatenate([xi, jnp.zeros((Bp - B, xi.shape[1]), xi.dtype)])

    def local(fi_s, xi_s, v_s, xq):
        num, den = interpolate_continuous(
            fi_s, xi_s, xq, r, dimension=dimension, order=order, diff=diff,
            valid=v_s)
        num = jax.lax.psum(num, axis_name)
        den = jax.lax.psum(den, axis_name)
        return num / den

    spec = P(axis_name)
    fn = jax.shard_map(
        local, mesh=mesh, in_specs=(spec, spec, spec, P()), out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fn)(fi, xi, valid, jnp.asarray(x))


def _pad_leading(a, n_target):
    pad = n_target - a.shape[0]
    if pad == 0:
        return a
    return jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])


def sharded_knn(mesh: Mesh, points, queries, k: int,
                axis_name: str = CASE_AXIS):
    """k-NN over a cloud sharded across the mesh.

    The collective pattern SURVEY §5 calls for when building neighborhoods
    from a distributed cloud: each shard all-gathers the (small) coordinate
    array once, then answers its own query shard with the local
    brute-force ranking (:func:`wlsqm_tpu.utils.neighbors.knn`'s device
    path).  Queries and results are sharded; points may arrive sharded or
    replicated (they are gathered either way).

    Returns (indices (M, k) int64 into the GLOBAL cloud, distances² (M, k)).
    """
    from wlsqm_tpu.utils.neighbors import _knn_device

    n = mesh.devices.size
    points = jnp.asarray(points)
    queries = jnp.asarray(queries)
    M = queries.shape[0]
    Mp = pad_cases(M, n)
    Np = pad_cases(points.shape[0], n)
    # pad the cloud with far-away sentinels so gathered padding never wins
    if Np != points.shape[0]:
        sentinel = jnp.full((Np - points.shape[0], points.shape[1]),
                            jnp.finfo(jnp.float32).max / 4, points.dtype)
        points = jnp.concatenate([points, sentinel])
    queries_p = _pad_leading(queries, Mp)

    def local(p_s, q_s):
        p_all = jax.lax.all_gather(p_s, axis_name, axis=0, tiled=True)
        return _knn_device(p_all, q_s, k)

    spec = P(axis_name)
    fn = jax.shard_map(local, mesh=mesh, in_specs=(spec, spec),
                       out_specs=(spec, spec), check_vma=False)
    idx, d2 = jax.jit(fn, static_argnames=())(points, queries_p)
    return idx[:M], d2[:M]


def sharded_build_neighborhoods(mesh: Mesh, points, values, centers, k: int,
                                exclude_self: bool = False,
                                axis_name: str = CASE_AXIS):
    """Distributed neighborhood assembly: sharded centers, global cloud.

    Composes with :func:`sharded_fit_many` into a fully distributed
    pipeline: cloud in, per-shard (xk, fk, nk) out, zero host round-trips.
    Single-device equivalent:
    :func:`wlsqm_tpu.utils.neighbors.build_neighborhoods`.
    """
    kq = k + 1 if exclude_self else k
    idx, _ = sharded_knn(mesh, points, centers, kq, axis_name=axis_name)
    if exclude_self:
        idx = idx[:, 1:]
    points = jnp.asarray(points)
    values = jnp.asarray(values)
    xk = points[idx]
    fk = values[idx]
    nk = jnp.full((idx.shape[0],), k, jnp.int32)
    return xk, fk, nk


def sharded_interpolate_nearest(mesh: Mesh, fi, xi, x, *, dimension: int,
                                order: int, diff: int = 0,
                                axis_name: str = CASE_AXIS):
    """Voronoi-nearest global-model evaluation over a sharded cloud.

    Local models (fi, xi) are sharded; query points are sharded too.  Each
    shard all-gathers the small coefficient/origin arrays (the layout
    :func:`replicated_coefficients` argues for), picks the nearest origin
    per local query by brute force, and evaluates that model.  Device-side
    counterpart of ExpertSolver.interpolate(mode='nearest') (reference:
    wlsqm/fitter/expert.pyx:830-895).

    Returns (Q,) values.
    """
    from wlsqm_tpu.fitter.interp import eval_fit
    from wlsqm_tpu.utils.neighbors import _knn_device

    n = mesh.devices.size
    fi = jnp.asarray(fi)
    xi = jnp.asarray(xi)
    x = jnp.asarray(x)
    B, Q = xi.shape[0], x.shape[0]
    Bp, Qp = pad_cases(B, n), pad_cases(Q, n)
    if Bp != B:
        fi = _pad_leading(fi, Bp)
        sentinel = jnp.full((Bp - B, xi.shape[1]),
                            jnp.finfo(jnp.float32).max / 4, xi.dtype)
        xi = jnp.concatenate([xi, sentinel])
    xq = _pad_leading(x, Qp)

    def local(fi_s, xi_s, q_s):
        fi_all = jax.lax.all_gather(fi_s, axis_name, axis=0, tiled=True)
        xi_all = jax.lax.all_gather(xi_s, axis_name, axis=0, tiled=True)
        idx, _ = _knn_device(xi_all, q_s, 1)
        idx = idx[:, 0]
        vals = eval_fit(fi_all[idx], xi_all[idx], q_s[:, None, :],
                        dimension=dimension, order=order, diff=diff)
        return vals[:, 0]

    spec = P(axis_name)
    fn = jax.shard_map(local, mesh=mesh, in_specs=(spec, spec, spec),
                       out_specs=spec, check_vma=False)
    return jax.jit(fn)(fi, xi, xq)[:Q]


def sharded_gather_values(mesh: Mesh, values, idx,
                          axis_name: str = CASE_AXIS):
    """Shard-local neighbor-value gather for distributed IBVP stepping.

    ``values`` (n, ...) — per-point field values, sharded over the mesh;
    ``idx`` (B, K) — GLOBAL neighbor indices, sharded over cases.  Each
    shard all-gathers the small value array once per call and gathers its
    own cases' rows locally with XLA's row gather (``v[idx]``), so every
    device indexes only B/D cases.  Multi-field states (n, F) ride the
    same indices (row gather), combining with
    :func:`sharded_solve_prepared`'s multi-RHS path for the fully
    amortized step.

    Returns (B, K, ...) neighbor values, sharded like ``idx``.
    """
    values = jnp.asarray(values)
    idx = jnp.asarray(idx)
    spec = P(axis_name)

    def local(v_s, idx_s):
        v_all = jax.lax.all_gather(v_s, axis_name, axis=0, tiled=True)
        return v_all[idx_s]

    fn = jax.shard_map(local, mesh=mesh, in_specs=(spec, spec),
                       out_specs=spec, check_vma=False)
    return jax.jit(fn)(values, idx)


def sharded_solve_prepared(mesh: Mesh, prep, fk, fi_init=None, *,
                           do_sens: bool = False,
                           axis_name: str = CASE_AXIS):
    """solve() over a case-sharded Prepared pytree — zero collectives.

    ``prep`` is an :class:`wlsqm_tpu.fitter.engine.Prepared` whose array
    leaves are sharded along the case axis (e.g. produced by
    :func:`distribute` or by preparing shard-locally); ``fk`` is (B, K)
    for one field or (F, B, K) for F fields sharing the geometry (the
    reference's guest-solver pattern, reference:
    wlsqm/fitter/expert.pyx:110-124).  Every case solves on the shard
    that owns its factorization; the compiled program contains no
    cross-device communication.

    Returns (fi, sens) with fi sharded like the case axis.
    """
    fk = jnp.asarray(fk)
    multi = fk.ndim == 3
    B = fk.shape[1] if multi else fk.shape[0]
    NO = prep.active.shape[1]
    if fi_init is None:
        shape = (fk.shape[0], B, NO) if multi else (B, NO)
        fi_init = jnp.zeros(shape, fk.dtype)
    else:
        fi_init = jnp.asarray(fi_init, fk.dtype)

    def local(prep_s, fk_s, fi_s):
        if multi:
            return jax.vmap(
                lambda fk_f, fi_f: engine.solve_prepared(
                    prep_s, fk_f, fi_f, do_sens=do_sens))(fk_s, fi_s)
        return engine.solve_prepared(prep_s, fk_s, fi_s, do_sens=do_sens)

    case = P(axis_name)
    data = P(None, axis_name) if multi else case
    fn = jax.shard_map(
        local, mesh=mesh, in_specs=(case, data, data),
        out_specs=(data, data), check_vma=False,
    )
    fi, sens = jax.jit(fn)(prep, fk, fi_init)
    return fi, (sens if do_sens else None)
