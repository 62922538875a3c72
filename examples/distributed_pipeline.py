"""Fully distributed WLSQM pipeline: cloud in, global model out.

Demonstrates the multi-device layer end to end on a virtual CPU mesh (it
runs unchanged on a host with several GPUs; see the usage line below):

  1. the point cloud is sharded over the mesh's case axis;
  2. neighborhoods are assembled on device (`sharded_build_neighborhoods`:
     one coordinate all-gather, then local brute-force kNN);
  3. every shard fits its own cases (`sharded_fit_many`: ZERO collectives
     in the compiled fit program — the reference's OpenMP `prange` with no
     cross-thread traffic becomes sharding with no cross-device traffic,
     reference: wlsqm/fitter/simple.pyx:996-1008);
  4. the patched global model is queried both ways: Voronoi-nearest
     (`sharded_interpolate_nearest`, coefficient all-gather + local top-1)
     and blended-continuous (`sharded_interpolate_continuous`, one psum
     pair), matching ExpertSolver.interpolate's two modes
     (reference: wlsqm/fitter/expert.pyx:830-986).

Usage:  python examples/distributed_pipeline.py
        (WLSQM_DEMO_REAL_DEVICES=1 to use real accelerators instead of the
        virtual 8-device CPU mesh)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax                                                   # noqa: E402

# the demo runs on a virtual 8-device CPU mesh by default so the sharding
# is real multi-device even on a laptop; set WLSQM_DEMO_REAL_DEVICES=1 to
# use whatever accelerators jax sees (e.g. the GPUs of one host)
if not os.environ.get("WLSQM_DEMO_REAL_DEVICES"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

from wlsqm_tpu.parallel import sharding                      # noqa: E402


def main():
    mesh = sharding.make_mesh()
    n = mesh.devices.size
    print(f"mesh: {n} devices, axis '{sharding.CASE_AXIS}'")

    # -- a scattered 2D cloud with a known smooth field -------------------
    N, k, order, NO = sharding.pad_cases(20_000, n), 16, 2, 6
    rng = np.random.default_rng(42)
    pts = rng.uniform(-1.0, 1.0, (N, 2))
    f = lambda p: np.sin(np.pi * p[:, 0]) * np.cos(np.pi * p[:, 1])  # noqa: E731
    vals = f(pts)

    pts_d, vals_d = sharding.distribute(mesh, pts, vals)

    # -- 1-2: neighborhoods on device --------------------------------------
    xk, fk, nk = sharding.sharded_build_neighborhoods(
        mesh, pts_d, vals_d, pts_d, k, exclude_self=True)

    # -- 3: sharded fit (origins at the cloud points) ----------------------
    res = sharding.sharded_fit_many(
        mesh, jnp.asarray(xk) - jnp.asarray(pts)[:, None, :], fk, nk,
        jnp.zeros((N, 2)), jnp.zeros((N, NO)),
        jnp.full((N,), order, jnp.int32), jnp.zeros((N,), jnp.int64),
        jnp.full((N,), 2, jnp.int32),       # WEIGHT_CENTER
        dimension=2, NO=NO)
    fi = res[0]

    # -- 4: query the patched global model ---------------------------------
    Q = sharding.pad_cases(1_000, n)
    q = rng.uniform(-0.9, 0.9, (Q, 2))
    near = np.asarray(sharding.sharded_interpolate_nearest(
        mesh, fi, pts, q, dimension=2, order=order))
    blend = np.asarray(sharding.sharded_interpolate_continuous(
        mesh, fi, pts, q, 0.08, dimension=2, order=order))

    truth = f(q)
    print(f"nearest    max |err| = {np.abs(near - truth).max():.2e}")
    print(f"continuous max |err| = {np.abs(blend - truth).max():.2e}")
    # derivative field through the same machinery (d/dx -> diff=1 == i2_X)
    dblend = np.asarray(sharding.sharded_interpolate_continuous(
        mesh, fi, pts, q, 0.08, dimension=2, order=order, diff=1))
    dtruth = np.pi * np.cos(np.pi * q[:, 0]) * np.cos(np.pi * q[:, 1])
    print(f"d/dx blend max |err| = {np.abs(dblend - dtruth).max():.2e}")

    # -- 5: distributed IBVP-style stepping --------------------------------
    # prepare once (factorizations case-sharded in device memory), then
    # each step is one shard-local neighbor-value gather (a single small
    # all-gather of the field vector) + a zero-collective multi-field solve.
    import wlsqm_tpu as wt

    idx, _ = sharding.sharded_knn(mesh, pts_d, pts_d, k + 1)
    idx = jnp.asarray(idx)[:, 1:]
    xk_s = jnp.asarray(pts)[idx]
    prep = wt.prepare(xk_s, jnp.asarray(pts), order=order, weighting=2)
    prep_s = jax.device_put(prep, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(sharding.CASE_AXIS)))
    u = jnp.stack([jnp.asarray(vals), jnp.asarray(vals) ** 2], axis=1)
    for _step in range(3):
        fku = sharding.sharded_gather_values(mesh, u, idx)    # (N, k, F)
        fi_t, _ = sharding.sharded_solve_prepared(
            mesh, prep_s, jnp.moveaxis(fku, -1, 0))           # (F, N, NO)
        lap = fi_t[..., jnp.asarray([wt.i2_X2, wt.i2_Y2])].sum(-1)
        u = u + 1e-4 * lap.T
    print(f"sharded stepping: u finite = {bool(jnp.isfinite(u).all())}, "
          f"shape {u.shape}")


if __name__ == "__main__":
    main()
