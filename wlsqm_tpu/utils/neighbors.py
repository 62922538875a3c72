"""Neighborhood construction: k-nearest and radius queries.

The reference's fit API takes neighbor coordinates as explicit inputs; the
neighbor search itself appears only in ExpertSolver's global interpolation
(scipy cKDTree, reference: wlsqm/fitter/expert.pyx:658-681) and in the
examples.  Here neighborhood construction from a global cloud is a
first-class subsystem, with two interchangeable backends:

* ``backend="device"`` — brute-force batched distance + top-k on the
  default JAX device.  It builds an (M, N) distance block per query block,
  so it suits clouds up to ~1e5 points; it keeps the data on-device and is
  trivially shardable (each query block computes distances against the
  full — replicated or gathered — cloud).
* ``backend="host"`` — a k-d tree on the host: the framework's native C++
  tree (:mod:`wlsqm_tpu.native`, multithreaded over queries) when the
  toolchain is available, scipy's cKDTree otherwise.  Better for very large
  clouds queried few times, or when the device is busy.

Both return identical (indices, per-query counts) contracts.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["knn", "radius_neighbors", "build_neighborhoods", "host_tree"]


def host_tree(points):
    """Build the best available host-side k-d tree over ``points``.

    Prefers the native C++ tree; falls back to scipy.spatial.cKDTree.  Both
    expose ``query(x, k)`` and ``query_ball_point(x, r)``.
    """
    from wlsqm_tpu import native

    if native.available():
        return native.KDTree(np.asarray(points))
    import scipy.spatial

    return scipy.spatial.cKDTree(np.asarray(points))


@partial(jax.jit, static_argnames=("k",))
def _knn_device(points, queries, k: int):
    """Brute-force k-NN: (N, dim) cloud, (M, dim) queries -> (M, k) indices.

    Distances form an (M, N) matrix computed via the matmul expansion
    |q - p|^2 = |q|^2 - 2 q·p + |p|^2; top-k by lax.top_k on the negated
    distances.  Ranking runs in f32 — an f64 distance matrix would cost 2x
    the memory, and neighbor *selection* only needs the ordering
    (near-exact ties may pick either neighbor, which is equally valid).
    The product runs at HIGHEST precision so that the ranking does not
    depend on the global matmul setting (TF32 would keep 10 mantissa bits).
    """
    p32 = points.astype(jnp.float32)
    q32 = queries.astype(jnp.float32)
    p2 = jnp.sum(p32 * p32, axis=-1)
    q2 = jnp.sum(q32 * q32, axis=-1)
    qp = jnp.matmul(q32, p32.T, precision=jax.lax.Precision.HIGHEST)
    d2 = q2[:, None] - 2.0 * qp + p2[None, :]
    _, idx = jax.lax.top_k(-d2, k)
    # exact distances recomputed in the input dtype for the selected few
    diff = queries[:, None, :] - points[idx]
    return idx, jnp.sum(diff * diff, axis=-1)


def knn(points, queries, k: int, backend: str = "device", block: int = 65536):
    """k nearest neighbors of each query point.

    Returns (indices (M, k) int64, distances² (M, k) float64-like).
    Queries are processed in blocks of ``block`` to bound the (M, N)
    distance matrix.  ``backend`` is "device" or "host" (see the module
    docstring).
    """
    if backend not in ("device", "host"):
        raise ValueError(
            "backend must be 'device' or 'host'; got %r" % (backend,))
    if backend == "host":
        tree = host_tree(points)
        d, idx = tree.query(np.asarray(queries), k=k)
        if k == 1:
            d = d[:, None]
            idx = idx[:, None]
        return idx.astype(np.int64), (d * d)

    points = jnp.asarray(points)
    queries = jnp.asarray(queries)
    # bound the (block, N) f32 distance matrix to ~1 GB
    n = points.shape[0]
    block = max(256, min(block, int(2.5e8 // max(n, 1))))
    outs_i, outs_d = [], []
    for s in range(0, queries.shape[0], block):
        idx, d2 = _knn_device(points, queries[s:s + block], k)
        outs_i.append(idx)
        outs_d.append(d2)
    return (jnp.concatenate(outs_i, axis=0), jnp.concatenate(outs_d, axis=0))


def radius_neighbors(points, queries, r: float, backend: str = "host"):
    """Indices of cloud points within radius r of each query (ragged).

    Returns a list of index arrays (host-side ragged structure; for the
    padded/masked device representation use :func:`build_neighborhoods`).
    """
    return host_tree(points).query_ball_point(np.asarray(queries), r)


def build_neighborhoods(points, values, centers, k: int,
                        backend: str = "device", exclude_self: bool = False):
    """Assemble padded (xk, fk, nk) fit inputs from a global cloud.

    points  : (N, dim) cloud coordinates
    values  : (N,) data at the cloud points
    centers : (M, dim) fit origins
    k       : neighbors per fit

    Returns (xk (M, k, dim), fk (M, k), nk (M,)) ready for
    :func:`wlsqm_tpu.fit_many`.  With ``exclude_self`` the nearest neighbor
    (assumed to be the center itself when centers ⊆ points) is dropped.
    """
    kq = k + 1 if exclude_self else k
    idx, _ = knn(points, centers, kq, backend=backend)
    idx = jnp.asarray(idx)
    if exclude_self:
        idx = idx[:, 1:]
    points = jnp.asarray(points)
    values = jnp.asarray(values)
    xk = points[idx]
    fk = values[idx]
    nk = jnp.full((idx.shape[0],), k, jnp.int32)
    return xk, fk, nk
