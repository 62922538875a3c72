"""Headline benchmark: 2D order-4 WLSQM fits, k=30 neighbors, float64 DOFs.

Measures sustained fits/sec of the public route — ``plan_fit_many`` ->
``fit_many(plan=)`` under ``jax.jit`` — on the BASELINE.json headline
configuration (2D order 4, k=30, WEIGHT_CENTER) in native float64 on the
GPU, and checks the DOFs against the independent SciPy float64 reference
(``tests/scipy_reference.py``); the parity cases are DOFs that the timed
program itself returns.

Timing: one jit-compiled ``lax.scan`` over device-resident chunks, with a
scalar checksum carried through every step (a data dependency the compiler
cannot elide) and fetched at the end, so wall time covers the full device
execution; the median of several sweeps is reported with its spread.

Fails without a GPU, and exits 1 when the parity exceeds 1e-10 L-inf
relative.  Prints ONE JSON line to stdout, naming the device kind, the
card and its power limit; progress goes to stderr.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

CHUNK = 262_144
RESIDENT_CHUNKS = 8
SWEEP_STEPS = 32
TIMED_REPS = 5             # median-of-N timed sweeps; spread is reported
K = 30
ORDER = 4
NO = 15                    # 2D order 4
PARITY = 1e-10             # L-inf relative vs the SciPy f64 reference
PARITY_CHUNKS = 2          # parity cases come from the first chunks' DOFs
PARITY_PER_CHUNK = 512


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    import wlsqm_tpu as wt

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import scipy_reference as ref

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log("bench.py: no GPU (JAX found %s)" % dev.platform)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    log("device: %s | %s" % (dev.device_kind, card))

    @jax.jit
    def make_chunk(key):
        k1, k2 = jax.random.split(key)
        xk = jax.random.uniform(k1, (CHUNK, K, 2), jnp.float64, -1.0, 1.0)
        fk = jnp.sin(3.0 * xk[..., 0]) * jnp.cos(2.0 * xk[..., 1])
        fk = fk + 0.01 * jax.random.normal(k2, (CHUNK, K), jnp.float64)
        return xk, fk

    keys = jax.random.split(jax.random.PRNGKey(42), RESIDENT_CHUNKS)
    xks, fks = (jnp.stack(a) for a in zip(*[make_chunk(k) for k in keys]))
    jax.block_until_ready((xks, fks))
    xi = jnp.zeros((CHUNK, 2))
    wm = wt.WEIGHT_CENTER
    plan = wt.plan_fit_many(xks[0], xi, order=ORDER, weighting=wm)

    def fit_chunk(xk, fk):
        return wt.fit_many(xk, fk, xi, order=ORDER, weighting=wm,
                           plan=plan).fi

    @jax.jit
    def sweep(xks, fks):
        def step(acc, i):
            j = i % RESIDENT_CHUNKS
            fi = fit_chunk(xks[j], fks[j])
            return acc + fi.sum(), fi[:PARITY_PER_CHUNK]

        acc, head = jax.lax.scan(step, jnp.float64(0.0),
                                 jnp.arange(SWEEP_STEPS))
        return acc, head[:PARITY_CHUNKS]

    t0 = time.perf_counter()
    float(sweep(xks, fks)[0])    # compile + first run (scalar fetch = sync)
    log("compile+first sweep: %.1f s" % (time.perf_counter() - t0))

    times = []
    for _ in range(TIMED_REPS):
        t0 = time.perf_counter()
        acc, head = sweep(xks, fks)
        float(acc)
        times.append(time.perf_counter() - t0)
    times.sort()
    dt = times[len(times) // 2]
    spread = (times[-1] - times[0]) / dt
    fits = SWEEP_STEPS * CHUNK
    log("%d fits in %.4f s (median of %d; spread %.1f%%) -> %.1f fits/s"
        % (fits, dt, TIMED_REPS, 100 * spread, fits / dt))

    # parity: the last timed sweep's DOFs of the first chunks' leading
    # cases (scan steps 0.. are chunks 0..) vs the SciPy f64 reference
    head = np.asarray(head)
    worst = 0.0
    for c in range(PARITY_CHUNKS):
        xk = np.asarray(xks[c][:PARITY_PER_CHUNK])
        fk = np.asarray(fks[c][:PARITY_PER_CHUNK])
        for b in range(PARITY_PER_CHUNK):
            want = ref.fit_case(xk[b], fk[b], np.zeros(2), ORDER, 0, wm, 2,
                                np.zeros(NO))
            worst = max(worst, ref.linf_rel(head[c, b], want))
    log("DOF parity (L-inf rel) vs SciPy f64 reference, %d cases: %.3e"
        % (PARITY_CHUNKS * PARITY_PER_CHUNK, worst))

    print(json.dumps({
        "metric": "fits/sec, 2D order-4 k=30, float64 DOFs, public route",
        "value": fits / dt,
        "unit": "fits/s",
        "parity_linf_rel": worst,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card,
        "chunk": CHUNK,
        "sweep_seconds": dt,
        "sweep_spread_rel": spread,
    }), flush=True)
    if not worst <= PARITY:
        log("bench.py: parity %.3e exceeds %.0e" % (worst, PARITY))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
