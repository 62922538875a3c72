"""ExpertSolver solve-boundary cost: NumPy in-place vs device-resident.

The compat ``solve()`` pays host transfers on every call: it accepts a
device ``fk`` without a host copy, uploads the knowns seed only when
knowns exist, and fetches all outputs through ONE ``jax.device_get``.
``solve_device()`` takes and returns JAX arrays with no host
synchronization, so back-to-back solves pipeline on device (the IBVP
pattern).  This script times both on the default JAX device.

Run: python benchmarks/run_expert_boundary.py [ncases]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

import wlsqm_tpu as wt


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    K = 30
    rng = np.random.default_rng(5)
    xi = rng.uniform(-1, 1, (B, 2))
    xk = xi[:, None, :] + rng.uniform(-0.5, 0.5, (B, K, 2))
    fks = [np.sin((1 + 0.1 * i) * xk[..., 0]) * np.cos(xk[..., 1])
           for i in range(8)]

    solver = wt.ExpertSolver(
        2, np.full(B, K, np.int32), np.full(B, 4, np.int32),
        np.zeros(B, np.int64), np.full(B, wt.WEIGHT_CENTER, np.int32))
    t0 = time.perf_counter()
    solver.prepare(xi=xi, xk=xk)
    jax.block_until_ready(solver.prepared.c)
    print("prepare: %.1f s (prepared precision=%s)"
          % (time.perf_counter() - t0, solver.prepared.precision),
          flush=True)
    fi = np.zeros((B, wt.number_of_dofs(2, 4)))

    def rate(fn, n=24):
        fn(0)                      # warm (compile)
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        return B * n / (time.perf_counter() - t0)

    # 1. reference-contract path: NumPy in, in-place NumPy out
    r_np = rate(lambda i: solver.solve(fk=fks[i % 8], fi=fi))
    print("solve() NumPy boundary      : %8.0f solves/s" % r_np, flush=True)

    # 2. device fk, NumPy fi out (upload skipped)
    fks_dev = [jnp.asarray(f) for f in fks]
    jax.block_until_ready(fks_dev)
    r_dev_in = rate(lambda i: solver.solve(fk=fks_dev[i % 8], fi=fi))
    print("solve() device fk           : %8.0f solves/s" % r_dev_in,
          flush=True)

    # 3. fully device-resident: no sync at all between solves
    def dev_solve(i):
        return solver.solve_device(fks_dev[i % 8])[0]

    dev_solve(0)
    t0 = time.perf_counter()
    outs = [dev_solve(i) for i in range(24)]
    jax.block_until_ready(outs[-1])
    r_dev = B * 24 / (time.perf_counter() - t0)
    print("solve_device() (no sync)    : %8.0f solves/s" % r_dev, flush=True)

    # 4. pipelined host boundary: one solve in flight, results on host
    list(solver.solve_stream(iter(fks[:2])))        # warm
    t0 = time.perf_counter()
    n_steps = 24
    got = list(solver.solve_stream(fks[i % 8] for i in range(n_steps)))
    r_stream = B * n_steps / (time.perf_counter() - t0)
    assert len(got) == n_steps
    print("solve_stream() (pipelined)  : %8.0f solves/s" % r_stream,
          flush=True)
    print("speedups vs NumPy boundary: device-fk %.1fx, pipelined %.1fx, "
          "device-resident %.1fx; round-2 recorded 77k/s on this config"
          % (r_dev_in / r_np, r_stream / r_np, r_dev / r_np), flush=True)


if __name__ == "__main__":
    main()
