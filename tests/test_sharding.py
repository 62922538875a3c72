"""Sharded execution ≡ single-device execution.

This plays the role of the reference's parallel-vs-serial equivalence tests:
partitioning the case axis over an 8-device (virtual CPU) mesh must give
bit-for-bit the same DOFs as one device.
"""

import jax
import numpy as np
import pytest

import wlsqm_tpu as wt
from wlsqm_tpu.fitter import defs, engine
from wlsqm_tpu.parallel import sharding


needs_devices = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs a multi-device (virtual) platform"
)


def _problem(rng, ncases, npts):
    def f(xy):
        x, y = xy[..., 0], xy[..., 1]
        return 1.0 + 2.0 * x + 3.0 * y + 4.0 * x * y + 5.0 * x**2 + 6.0 * y**2
    xk = rng.uniform(-1, 1, (ncases, npts, 2))
    fk = f(xk)
    return (
        xk, fk,
        np.full(ncases, npts, np.int32),
        np.zeros((ncases, 2)),
        np.zeros((ncases, 6)),
        np.full(ncases, 2, np.int32),
        np.zeros(ncases, np.int64),
        np.full(ncases, wt.WEIGHT_UNIFORM, np.int32),
    )


@needs_devices
def test_sharded_equals_single_device(rng):
    ncases = 64  # divisible by the 8 virtual devices
    args = _problem(rng, ncases, 25)

    mesh = sharding.make_mesh()
    fi_sh, _, _, _ = sharding.sharded_fit_many(
        mesh, *args, dimension=2, NO=6)

    import jax.numpy as jnp
    fi_1, _, _, _ = engine.fit_batch(
        *map(jnp.asarray, args), dimension=2, NO=6)

    np.testing.assert_array_equal(np.asarray(fi_sh), np.asarray(fi_1))


@needs_devices
def test_sharded_no_collectives_in_fit(rng):
    """The fit path must be embarrassingly parallel: its compiled HLO
    contains no cross-device collectives."""
    ncases = 32
    args = _problem(rng, ncases, 20)
    mesh = sharding.make_mesh(4)

    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    def local_fit(*a):
        return engine.fit_batch(*a, dimension=2, NO=6)

    fn = jax.shard_map(
        local_fit, mesh=mesh,
        in_specs=(P("cases"),) * 8,
        out_specs=(P("cases"),) * 4,
    )
    lowered = jax.jit(fn).lower(*map(jnp.asarray, args))
    hlo = lowered.compile().as_text()
    for coll in ("all-reduce", "all-gather", "all-to-all",
                 "collective-permute", "reduce-scatter"):
        assert coll not in hlo, "unexpected collective %r in fit HLO" % coll


@needs_devices
def test_replicated_coefficients_gathers_all(rng):
    mesh = sharding.make_mesh()
    n = 8 * len(jax.devices())
    fi = rng.standard_normal((n, 6))
    fi_dist = sharding.distribute(mesh, fi)
    fi_rep = sharding.replicated_coefficients(mesh, fi_dist)
    np.testing.assert_array_equal(np.asarray(fi_rep), fi)


def test_pad_cases():
    assert sharding.pad_cases(10, 8) == 16
    assert sharding.pad_cases(16, 8) == 16
    assert sharding.pad_cases(1, 8) == 8


def test_sharded_interpolate_continuous(rng):
    """Sharded blending (with psum) == single-device functional result."""
    from wlsqm_tpu.fitter.interp import interpolate_continuous

    B = 61  # deliberately not divisible by the 8-device mesh
    xi = rng.uniform(-1, 1, (B, 2))
    fi = rng.normal(size=(B, 6))
    q = rng.uniform(-0.9, 0.9, (23, 2))
    r = 0.6

    num, den = interpolate_continuous(fi, xi, q, r, dimension=2, order=2)
    want = np.asarray(num) / np.asarray(den)

    mesh = sharding.make_mesh()
    got = np.asarray(sharding.sharded_interpolate_continuous(
        mesh, fi, xi, q, r, dimension=2, order=2))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_sharded_knn_matches_single_device(rng):
    from wlsqm_tpu.utils import neighbors

    N, M, k = 203, 45, 7  # neither divisible by 8
    pts = rng.uniform(-1, 1, (N, 2))
    q = rng.uniform(-1, 1, (M, 2))

    idx1, d1 = neighbors.knn(pts, q, k, backend="device")
    mesh = sharding.make_mesh()
    idx2, d2 = sharding.sharded_knn(mesh, pts, q, k)

    # index sets per query must agree (ordering of exact ties may differ)
    for a, b in zip(np.asarray(idx1), np.asarray(idx2)):
        assert set(a.tolist()) == set(b.tolist())
    np.testing.assert_allclose(np.sort(np.asarray(d2), -1),
                               np.sort(np.asarray(d1), -1), rtol=1e-12)


def test_sharded_build_neighborhoods_pipeline(rng):
    """cloud -> sharded neighborhoods -> sharded fit == host pipeline."""
    from wlsqm_tpu.utils import neighbors
    import wlsqm_tpu as wt

    N, k = 160, 12
    pts = rng.uniform(-1, 1, (N, 2))
    vals = np.sin(pts[:, 0]) + pts[:, 1] ** 2

    mesh = sharding.make_mesh()
    xk, fk, nk = sharding.sharded_build_neighborhoods(
        mesh, pts, vals, pts, k, exclude_self=True)
    res = wt.fit_many(np.asarray(xk) - pts[:, None, :], fk,
                      np.zeros((N, 2)), nk=nk, order=2)

    xk0, fk0, nk0 = neighbors.build_neighborhoods(pts, vals, pts, k,
                                                  exclude_self=True)
    ref = wt.fit_many(np.asarray(xk0) - pts[:, None, :], fk0,
                      np.zeros((N, 2)), nk=nk0, order=2)
    np.testing.assert_allclose(np.asarray(res.fi), np.asarray(ref.fi),
                               rtol=0, atol=1e-9)


def test_sharded_interpolate_nearest(rng):
    from wlsqm_tpu.fitter.interp import eval_fit
    from wlsqm_tpu.utils.neighbors import _knn_device
    import jax.numpy as jnp

    B, Q = 51, 29
    xi = rng.uniform(-1, 1, (B, 2))
    fi = rng.normal(size=(B, 6))
    q = rng.uniform(-1, 1, (Q, 2))

    mesh = sharding.make_mesh()
    got = np.asarray(sharding.sharded_interpolate_nearest(
        mesh, fi, xi, q, dimension=2, order=2))

    idx, _ = _knn_device(jnp.asarray(xi), jnp.asarray(q), 1)
    idx = np.asarray(idx)[:, 0]
    want = np.asarray(eval_fit(jnp.asarray(fi)[idx], jnp.asarray(xi)[idx],
                               jnp.asarray(q)[:, None, :],
                               dimension=2, order=2))[:, 0]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


@needs_devices
def test_sharded_gather_values_matches_global(rng):
    """Shard-local neighbor gather ≡ global fancy indexing."""
    import jax.numpy as jnp

    n, B, K, F = 64, 64, 7, 3
    vals = rng.standard_normal((n, F))
    idx = rng.integers(0, n, (B, K))
    mesh = sharding.make_mesh()
    got = sharding.sharded_gather_values(mesh, jnp.asarray(vals),
                                         jnp.asarray(idx))
    np.testing.assert_array_equal(np.asarray(got), vals[idx])


@needs_devices
def test_sharded_ibvp_step_matches_single_device(rng):
    """A full sharded IBVP time step (shard-local gather + case-sharded
    prepared solve, multi-field) reproduces the single-device step
    bit-for-bit — the distributed counterpart of the reference's
    parallel ≡ serial contract."""
    import jax.numpy as jnp

    import wlsqm_tpu as wt_api

    n, k, F = 64, 10, 2
    pts = rng.uniform(0, 1, (n, 2))
    # simple synthetic neighborhoods: k nearest by brute force on host
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    idx = np.argsort(d2, axis=1)[:, 1:k + 1]
    xk = pts[idx]

    prep = wt_api.prepare(jnp.asarray(xk), jnp.asarray(pts), order=2,
                          weighting=wt_api.WEIGHT_CENTER)
    u = np.stack([np.sin(np.pi * pts[:, 0]),
                  np.cos(np.pi * pts[:, 1])], axis=1)   # (n, F)

    # single-device step
    fk_1 = jnp.asarray(u)[jnp.asarray(idx)]              # (B, K, F)
    fi_1, _ = wt_api.solve(prep, jnp.moveaxis(fk_1, -1, 0))

    # sharded step: values + indices + prepared state sharded over 8 devices
    mesh = sharding.make_mesh()
    fk_s = sharding.sharded_gather_values(mesh, jnp.asarray(u),
                                          jnp.asarray(idx))
    prep_s = jax.device_put(
        prep, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(sharding.CASE_AXIS)))
    fi_s, _ = sharding.sharded_solve_prepared(
        mesh, prep_s, jnp.moveaxis(fk_s, -1, 0))

    np.testing.assert_array_equal(np.asarray(fi_s), np.asarray(fi_1))


@pytest.mark.full
@needs_devices
def test_plan_fit_many_device_count_invariance(rng):
    """The full plan_fit_many -> fit_many(plan=) pipeline gives
    bit-identical DOFs on 1 vs 8 devices (planned on concrete data,
    replayed under shard_map)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from wlsqm_tpu import api

    D = 8
    B, K, order = 1024 * D, 14, 2
    xi = rng.uniform(-1, 1, (B, 2))
    xk = xi[:, None, :] + rng.uniform(-0.3, 0.3, (B, K, 2))
    fk = np.sin(xk[..., 0]) * np.cos(xk[..., 1])
    nk = np.full(B, K, np.int32)
    args = (jnp.asarray(xk), jnp.asarray(fk), jnp.asarray(nk),
            jnp.asarray(xi))
    plan = api.plan_fit_many(args[0], args[3], nk=args[2], order=order,
                             weighting=defs.WEIGHT_CENTER)

    def run(xk_, fk_, nk_, xi_):
        return api.fit_many(xk_, fk_, xi_, nk=nk_, order=order,
                            weighting=defs.WEIGHT_CENTER, plan=plan).fi

    fi_1 = run(*args)
    mesh = sharding.make_mesh()
    spec = P(sharding.CASE_AXIS)
    fi_8 = jax.jit(jax.shard_map(run, mesh=mesh, in_specs=(spec,) * 4,
                                 out_specs=spec, check_vma=False))(*args)
    np.testing.assert_array_equal(np.asarray(fi_1), np.asarray(fi_8))
