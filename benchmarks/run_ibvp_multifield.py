"""IBVP stepping cost vs number of fields: amortizing the neighbor gather.

An explicit heat step on a prepared WLSQM Laplacian is one neighbor-value
gather ``u[idx]`` plus one prepared solve.  With F fields sharing one
geometry, the state is (n, F): ONE row-gather fetches every field's
neighbor values and ONE multi-RHS solve (``wt.solve`` with fk (F, B, K))
reuses the factorizations, so the per-field step cost falls with F.

Run: python benchmarks/run_ibvp_multifield.py [n_points]
Prints a step-time table vs F (fields per step) for the f64 engine on the
default JAX device, plus the gather's rate in indices per second.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

import wlsqm_tpu as wt
from wlsqm_tpu.utils import neighbors


def timed(fn, *args, reps=3):
    jax.block_until_ready(fn(*args))   # compile
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    k, nu, dt, steps = 28, 0.05, 2e-9, 20
    rng = np.random.default_rng(42)
    pts = rng.uniform(0.0, 1.0, (n, 2))
    idx_h, _ = neighbors.knn(pts, pts, k + 1, backend="host")
    idx = jnp.asarray(np.asarray(idx_h)[:, 1:].astype(np.int32))
    prep = wt.prepare(jnp.asarray(pts)[idx], jnp.asarray(pts), order=2,
                      weighting=wt.WEIGHT_CENTER)
    lap_idx = jnp.asarray([wt.i2_X2, wt.i2_Y2])
    dev = jax.devices()[0]
    print("device %s | n=%d k=%d order=2 f64; %d steps per timed scan"
          % (dev.device_kind, n, k, steps), flush=True)

    @jax.jit
    def scan(u):
        def step(u, _):
            fk = jnp.moveaxis(u[idx], -1, 0)       # ONE gather -> (F, B, K)
            fi, _ = wt.solve(prep, fk)             # multi-RHS solve
            return u + dt * nu * fi[..., lap_idx].sum(-1).T, None

        return jax.lax.scan(step, u, None, length=steps)[0]

    @jax.jit
    def gather_only(u):
        return u[idx]

    print("F  step_ms  per_field_ms  gather_ms  gather_Gidx/s", flush=True)
    for F in (1, 2, 4, 8):
        u0 = jnp.asarray(np.sin(np.pi * pts[:, 0:1] * np.arange(1, F + 1))
                         * np.sin(np.pi * pts[:, 1:2]))
        t, out = timed(scan, u0)
        tg, _ = timed(gather_only, u0)
        if not bool(jnp.isfinite(out).all()):
            raise AssertionError("non-finite field at F=%d" % F)
        step_ms = t / steps * 1e3
        print("%d  %7.3f  %11.3f  %9.3f  %12.3f"
              % (F, step_ms, step_ms / F, tg * 1e3, idx.size / tg / 1e9),
              flush=True)


if __name__ == "__main__":
    main()
