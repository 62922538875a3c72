"""Smoke test of the public fit path on NVIDIA GPUs.

Usage::

    python chip_smoke.py [--seed N]          # one GPU, every phase
    python chip_smoke.py --four [--seed N]   # four GPUs, the sharded path only

Drives the system the way its users do, at deployment size, on the device
JAX reports, and checks every result against the repository's plain SciPy
float64 reference (``tests/scipy_reference.py``):

* headline: ``plan_fit_many`` -> ``jax.jit(fit_many(plan=))`` over 10M
  device-generated 2D order-4 k=30 WEIGHT_CENTER cases, then one
  ``fit_stream`` pass over a 1M-case host array;
* IBVP: a 1M-point 2D cloud, host k-d tree kNN (k=28), order 2 with F
  known on boundary cases, ``ExpertSolver.prepare`` and 20 jitted heat
  steps (``u[idx]`` gather + prepared solve), plus compat ``fit_2D`` and
  ``fit_2D_many``;
* wide and derivative: 3D order 4 (K=48, 35 DOFs) over 131,072 cases,
  ``do_sens`` sensitivities, and ALGO_ITERATIVE with ``max_iter=3``.

Every fit runs in float64, so no contraction is ever demoted to TF32; the
parity bar is 1e-10 L-inf relative.  The IBVP's second-derivative DOFs on
radius-0.005 neighbourhoods are the exception: there no float64 solver
reaches 1e-10 (SciPy's own misses the exact answer by ~2e-10), so those
are held to 5e-10 against a long-double solve of the same problem, and
the DOFs of degree <= 1 keep the 1e-10 bar against SciPy.  ``--four`` runs
only the multi-device
path on a flat 1-D case mesh over four cards (NVLink joins every card to
every other) and compares each sharded call with the same call on one
device at 1e-12 relative.

Any failed phase raises, so the process exits non-zero; without a GPU it
exits non-zero before any phase.  The last line of standard output is one
JSON object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

PARITY = 1e-10        # f64 engine vs SciPy f64, L-inf relative
WITNESS_PARITY = 5e-10  # IBVP DOFs vs the long-double witness, L-inf relative
SHARD_PARITY = 1e-12  # sharded vs one device, relative

# problem sizes (the tests shrink them to rehearse the phases on the CPU)
HEADLINE_CASES = 10_000_000   # BASELINE.json's 10M-point 2D cloud
HEADLINE_CHUNK = 250_000
STREAM_CASES = 1_000_000
IBVP_POINTS = 1_000_000
COMPAT_CASES = 4096
WIDE_CASES = 131_072
SENS_CASES = 65_536
PARITY_CASES = 1024
FOUR_POINTS = 65_536
FOUR_QUERIES = 4096
FOUR_STREAM_CASES = 1_000_000
FOUR_STREAM_CHUNK = 262_144


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def peak_bytes(dev):
    return (dev.memory_stats() or {}).get("peak_bytes_in_use", 0)


def check(name, err, bar):
    log("  %s: %.3e (bar %.0e)" % (name, err, bar))
    if not err <= bar:
        raise AssertionError("%s: %.3e exceeds %.0e" % (name, err, bar))


def reference():
    """The repository's plain reference, ``tests/scipy_reference.py``."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import scipy_reference

    return scipy_reference


def reference_fi(xk, fk, xi, order, knowns, weighting, dim, fi_init):
    """Per-case SciPy f64 DOFs (B, NO)."""
    ref = reference()
    return np.stack([ref.fit_case(xk[b], fk[b], xi[b], order, int(knowns[b]),
                                  weighting, dim, fi_init[b])
                     for b in range(len(xk))])


def scipy_parity(name, fi, xk, fk, xi, order, weighting, dim):
    """Check fits with no knowns against SciPy at PARITY; fi holds the
    leading cases of xk, fk and xi."""
    B, no = fi.shape
    want = reference_fi(xk[:B], fk[:B], xi[:B], order, np.zeros(B, np.int64),
                        weighting, dim, np.zeros((B, no)))
    check(name, worst_case_err(fi, want), PARITY)


def worst_case_err(fi, want):
    """Worst per-case L-inf-relative error of fi against want."""
    ref = reference()
    return max(ref.linf_rel(fi[b], want[b]) for b in range(len(fi)))


def local_parity(name, fi, xk, fk, xi, order, knowns, weighting, fi_init):
    """Parity of 2D fits on small neighbourhoods, against two references.

    Over a neighbourhood of radius rho the second-derivative DOFs come out
    of differences ~rho**2 below the data, so every float64 solver loses
    ~rho**-2 of its precision on them.  The DOFs of degree <= 1 are held
    to PARITY against SciPy; all DOFs, unscaled, to WITNESS_PARITY against
    a long-double solve of the same problem, beside which SciPy's own
    error is logged.
    """
    from wlsqm_tpu.fitter import tables

    ref = reference()
    no = fi.shape[1]
    low = tables.DEGREE[2][:no] <= 1
    sp = reference_fi(xk, fk, xi, order, knowns, weighting, 2, fi_init)
    ld = np.empty_like(fi)
    for kn in np.unique(knowns):
        m = knowns == kn
        ld[m] = ref.fit_cases_ld(xk[m], fk[m], xi[m], order, int(kn),
                                 weighting, 2, fi_init[m])
    log("  %s: all DOFs vs SciPy %.3e; SciPy vs long double %.3e"
        % (name, worst_case_err(fi, sp), worst_case_err(sp, ld)))
    check("%s, DOFs of degree <= 1 vs SciPy" % name,
          worst_case_err(fi[:, low], sp[:, low]), PARITY)
    check("%s, all DOFs vs long double" % name, worst_case_err(fi, ld),
          WITNESS_PARITY)


def timed(fn, *args):
    """(result, seconds) of fn(*args) through block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------

def headline_phase(seed, dev):
    import jax
    import jax.numpy as jnp

    import wlsqm_tpu as wt

    n_total, chunk, K, order, no = HEADLINE_CASES, HEADLINE_CHUNK, 30, 4, 15
    log("[headline] 2D order 4, K=30, WEIGHT_CENTER, %d cases" % n_total)
    wm = wt.WEIGHT_CENTER

    @jax.jit
    def make_chunk(key):
        k1, k2 = jax.random.split(key)
        xk = jax.random.uniform(k1, (chunk, K, 2), jnp.float64, -1.0, 1.0)
        fk = jnp.sin(3.0 * xk[..., 0]) * jnp.cos(2.0 * xk[..., 1])
        return xk, fk + 0.01 * jax.random.normal(k2, (chunk, K), jnp.float64)

    keys = jax.random.split(jax.random.PRNGKey(seed), n_total // chunk)
    data = [make_chunk(k) for k in keys]
    jax.block_until_ready(data)
    xi = jnp.zeros((chunk, 2))
    log("  resident cloud: %.2f GB" % (
        sum(x.nbytes + f.nbytes for x, f in data) / 1e9))

    plan = wt.plan_fit_many(data[0][0], xi, order=order, weighting=wm)
    fit = jax.jit(lambda xk, fk, xi: wt.fit_many(
        xk, fk, xi, order=order, weighting=wm, plan=plan).fi)
    t0 = time.perf_counter()
    fit_c = fit.lower(data[0][0], data[0][1], xi).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(fit_c(*data[0], xi))   # one warm run

    log("  compile %.2f s | plan %s" % (compile_s, plan))
    for sweep in (1, 2):
        t0 = time.perf_counter()
        sums = [fit_c(xk, fk, xi).sum() for xk, fk in data]
        total = float(jnp.stack(sums).sum())
        dt = time.perf_counter() - t0
        if not np.isfinite(total):
            raise AssertionError("non-finite DOFs in the headline sweep")
        log("  sweep %d: %d fits in %.4f s -> %.1f fits/s (%.3f ms per "
            "%d-case call)" % (sweep, n_total, dt, n_total / dt,
                               dt / len(data) * 1e3, chunk))

    npar = min(PARITY_CASES // 2, chunk)
    fi = np.concatenate([np.asarray(fit_c(*data[i], xi)[:npar])
                         for i in (0, 1)])
    xk_h = np.concatenate([np.asarray(data[i][0][:npar]) for i in (0, 1)])
    fk_h = np.concatenate([np.asarray(data[i][1][:npar]) for i in (0, 1)])
    scipy_parity("parity, %d cases" % (2 * npar), fi, xk_h, fk_h,
                 np.zeros((2 * npar, 2)), order, wm, 2)
    del data
    log("  peak device memory %.3f GB" % (peak_bytes(dev) / 1e9))

    n_s = STREAM_CASES
    log("[headline] fit_stream over a %d-case host array" % n_s)
    rng = np.random.default_rng(seed + 1)
    xk_s = rng.uniform(-1.0, 1.0, (n_s, K, 2))
    fk_s = np.sin(3.0 * xk_s[..., 0]) * np.cos(2.0 * xk_s[..., 1])
    wt.fit_stream(xk_s[:chunk], fk_s[:chunk], order=order, weighting=wm,
                  chunk=chunk)   # compile
    t0 = time.perf_counter()
    res = wt.fit_stream(xk_s, fk_s, order=order, weighting=wm, chunk=chunk)
    dt = time.perf_counter() - t0
    if res.fi.shape != (n_s, no) or not np.isfinite(res.fi).all():
        raise AssertionError("fit_stream output malformed")
    log("  %d fits in %.4f s -> %.1f fits/s (host arrays, transfers included)"
        % (n_s, dt, n_s / dt))
    m = min(PARITY_CASES, n_s)
    sel = rng.choice(n_s, m, replace=False)
    scipy_parity("fit_stream parity, %d cases" % m, res.fi[sel], xk_s[sel],
                 fk_s[sel], np.zeros((m, 2)), order, wm, 2)
    log("  peak device memory %.3f GB" % (peak_bytes(dev) / 1e9))


def ibvp_phase(seed, dev):
    import jax
    import jax.numpy as jnp

    import wlsqm_tpu as wt
    from wlsqm_tpu.fitter import engine
    from wlsqm_tpu.utils.neighbors import host_tree

    n, k, order = IBVP_POINTS, 28, 2
    log("[ibvp] %d-point 2D cloud, k=28, order 2, F known on the boundary"
        % n)
    no = wt.number_of_dofs(2, order)
    rng = np.random.default_rng(seed + 2)
    pts = rng.uniform(-1.0, 1.0, (n, 2))
    t0 = time.perf_counter()
    _, idx = host_tree(pts).query(pts, k=k + 1)
    idx = np.ascontiguousarray(idx[:, 1:], dtype=np.int32)
    log("  host kNN %.2f s" % (time.perf_counter() - t0))
    boundary = np.abs(pts).max(axis=1) > 0.98
    knowns = np.where(boundary, int(wt.b2_F), 0).astype(np.int64)
    es = wt.ExpertSolver(
        dimension=2, nk=np.full(n, k, np.int32),
        order=np.full(n, order, np.int32), knowns=knowns,
        weighting_method=np.full(n, wt.WEIGHT_CENTER, np.int32))
    xk = pts[idx]
    t0 = time.perf_counter()
    es.prepare(xi=pts, xk=xk)
    jax.block_until_ready(es.prepared)
    log("  prepare (compile included) %.2f s, precision %s"
        % (time.perf_counter() - t0, es.prepared.precision))

    state = (es.prepared, jnp.asarray(idx), jnp.asarray(boundary))
    lap = np.array([wt.i2_X2, wt.i2_Y2])
    dt_step = 1e-6

    @jax.jit
    def step(state, u):
        prep, idx_d, bmask = state
        fk = u[idx_d]                                        # (n, k) gather
        fi0 = jnp.zeros((n, no)).at[:, 0].set(u)             # Dirichlet F
        fi, _ = wt.solve(prep, fk, fi0)
        return jnp.where(bmask, u, u + dt_step * fi[:, lap].sum(-1)), fi

    u0 = jnp.asarray(np.exp(-4.0 * (pts ** 2).sum(-1)))
    t0 = time.perf_counter()
    step_c = step.lower(state, u0).compile()
    compile_s = time.perf_counter() - t0
    u, fi_first = jax.block_until_ready(step_c(state, u0))
    t0 = time.perf_counter()
    for _ in range(19):
        u, _ = step_c(state, u)
    u = jax.block_until_ready(u)
    ms = (time.perf_counter() - t0) / 19 * 1e3
    if not bool(jnp.isfinite(u).all()):
        raise AssertionError("non-finite field after 20 steps")
    log("  step compile %.2f s | %.3f ms per step (20 steps)"
        % (compile_s, ms))

    u0_h = np.asarray(u0)
    nb = min(PARITY_CASES // 4, int(boundary.sum()))
    sel = np.concatenate([
        rng.choice(np.nonzero(boundary)[0], nb, False),
        rng.choice(np.nonzero(~boundary)[0], PARITY_CASES - nb, False)])
    fi_init = np.zeros((len(sel), no))
    fi_init[:, 0] = u0_h[sel]
    local_parity("step-1 DOFs, %d cases (%d boundary)" % (len(sel), nb),
                 np.asarray(fi_first)[sel], xk[sel], u0_h[idx[sel]],
                 pts[sel], order, knowns[sel], wt.WEIGHT_CENTER, fi_init)

    log("[ibvp] compat fit_2D and fit_2D_many on the card")
    devices = []
    orig = engine.fit_batch

    def spy(*a, **kw):
        out = orig(*a, **kw)
        devices.append(out[0].devices())
        return out

    engine.fit_batch = spy
    try:
        xi1 = pts[0]
        fi1 = np.zeros(no)
        wt.fit_2D(xk=xk[0], fk=u0_h[idx[0]], xi=xi1, fi=fi1, order=order,
                  knowns=0, weighting_method=wt.WEIGHT_CENTER)
        B = COMPAT_CASES
        fiB = np.zeros((B, no))
        wt.fit_2D_many(xk[:B], u0_h[idx[:B]], np.full(B, k, np.int32),
                       pts[:B], fiB, None, False, np.full(B, order, np.int32),
                       np.zeros(B, np.int64),
                       np.full(B, wt.WEIGHT_CENTER, np.int32))
    finally:
        engine.fit_batch = orig
    if len(devices) != 2 or any(d != {dev} for d in devices):
        raise AssertionError("compat fits did not run on %s: %s"
                             % (dev, devices))
    local_parity("fit_2D", fi1[None], xk[:1], u0_h[idx[:1]], pts[:1], order,
                 np.zeros(1, np.int64), wt.WEIGHT_CENTER, np.zeros((1, no)))
    m = min(PARITY_CASES, B)
    local_parity("fit_2D_many, %d of %d cases" % (m, B), fiB[:m], xk[:m],
                 u0_h[idx[:m]], pts[:m], order, np.zeros(m, np.int64),
                 wt.WEIGHT_CENTER, np.zeros((m, no)))
    log("  peak device memory %.3f GB" % (peak_bytes(dev) / 1e9))


def wide_phase(seed, dev):
    import jax
    import jax.numpy as jnp

    import wlsqm_tpu as wt

    ref = reference()
    rng = np.random.default_rng(seed + 3)

    def batch(B, K, dim):
        xk = rng.uniform(-1.0, 1.0, (B, K, dim))
        fk = np.sin(1.3 * xk[..., 0]) * np.cos(0.7 * xk.sum(-1)) + 0.2
        return xk, fk, np.zeros((B, dim))

    def run(name, B, K, dim, order, **kw):
        xk, fk, xi = batch(B, K, dim)
        args = [jnp.asarray(a) for a in (xk, fk, xi)]
        fit = jax.jit(lambda a, b, c: wt.fit_many(
            a, b, c, order=order, weighting=wt.WEIGHT_CENTER, **kw))
        t0 = time.perf_counter()
        fit_c = fit.lower(*args).compile()
        compile_s = time.perf_counter() - t0
        jax.block_until_ready(fit_c(*args))
        res, dt = timed(fit_c, *args)
        log("[wide] %s: compile %.2f s | %d fits in %.4f s -> %.1f fits/s"
            % (name, compile_s, B, dt, B / dt))
        return xk, fk, xi, res

    m = PARITY_CASES
    xk, fk, xi, res = run("3D order 4, K=48, 35 DOFs", WIDE_CASES, 48, 3, 4)
    scipy_parity("3D order-4 parity, %d cases" % m, np.asarray(res.fi[:m]),
                 xk, fk, xi, 4, wt.WEIGHT_CENTER, 3)

    xk, fk, xi, res = run("2D order 4 do_sens", SENS_CASES, 30, 2, 4,
                          do_sens=True)
    ms = m // 4
    sens = np.asarray(res.sens[:ms])
    err = max(ref.linf_rel(sens[b], ref.sens_case(xk[b], xi[b], 4,
                                                  wt.WEIGHT_CENTER, 2))
              for b in range(ms))
    check("sensitivity parity vs A^-1 C^T W, %d cases" % ms, err, PARITY)

    xk, fk, xi, res = run("2D order 4 ALGO_ITERATIVE max_iter=3",
                          WIDE_CASES, 30, 2, 4, iterative=True, max_iter=3)
    iters = np.asarray(res.iterations)
    log("  iterations: max %d, mean %.3f" % (iters.max(), iters.mean()))
    if iters.max() > 3:
        raise AssertionError("more than max_iter=3 iterations")
    scipy_parity("iterative parity, %d cases" % m, np.asarray(res.fi[:m]),
                 xk, fk, xi, 4, wt.WEIGHT_CENTER, 2)
    log("  peak device memory %.3f GB" % (peak_bytes(dev) / 1e9))


# ---------------------------------------------------------------------------
# four-card phase
# ---------------------------------------------------------------------------

def rel_err(got, want):
    """Max difference relative to max |want|; NaNs must sit in the same places.

    The continuous blend is NaN where no model lies within its radius, on
    one device and sharded alike.
    """
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(want)
    if not np.array_equal(np.isnan(got), nan):
        return np.inf
    got, want = got[~nan], want[~nan]
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def spread(arr, n):
    devs = {s.device for s in arr.addressable_shards}
    if len(devs) != n:
        raise AssertionError("output lives on %d devices, expected %d"
                             % (len(devs), n))


def four_phase(seed):
    import jax
    import jax.numpy as jnp

    import wlsqm_tpu as wt
    from wlsqm_tpu.fitter.interp import eval_fit, interpolate_continuous
    from wlsqm_tpu.parallel import sharding
    from wlsqm_tpu.utils import neighbors

    D = 4
    if len(jax.devices()) < D:
        raise AssertionError("--four needs 4 devices, found %d"
                             % len(jax.devices()))
    mesh = sharding.make_mesh(D)
    one = jax.devices()[0]
    rng = np.random.default_rng(seed + 4)

    n, k, order, wm = FOUR_POINTS, 16, 2, wt.WEIGHT_CENTER
    no = wt.number_of_dofs(2, order)
    pts = rng.uniform(-1.0, 1.0, (n, 2))
    vals = np.sin(2.0 * pts[:, 0]) * np.cos(pts[:, 1])
    log("[four] mesh %s over %s" % (mesh.shape, [d.id for d in mesh.devices]))

    # neighbourhoods: the f32 ranking may break near-ties differently on
    # another GEMM shape, so sets are compared through their f64 distances
    t0 = time.perf_counter()
    xk_s, fk_s, nk_s = jax.block_until_ready(
        sharding.sharded_build_neighborhoods(mesh, pts, vals, pts, k,
                                             exclude_self=True))
    log("  sharded_build_neighborhoods %.3f s (compile included)"
        % (time.perf_counter() - t0))
    spread(xk_s, D)
    with jax.default_device(one):
        xk_1, _, _ = neighbors.build_neighborhoods(pts, vals, pts, k,
                                                   exclude_self=True)
    d_s = np.sort(((np.asarray(xk_s) - pts[:, None]) ** 2).sum(-1), -1)
    d_1 = np.sort(((np.asarray(xk_1) - pts[:, None]) ** 2).sum(-1), -1)
    same = (d_s == d_1).all(-1)
    log("  neighbourhoods identical for %d of %d centres" % (same.sum(), n))
    check("neighbour distances, sharded vs one device (abs)",
          float(np.abs(d_s - d_1).max()), 1e-6)

    # the sharded fit, fed the sharded neighbourhoods, vs one device
    delta = np.asarray(xk_s) - pts[:, None, :]
    fk_h = np.asarray(fk_s)
    args = (delta, fk_h, np.full(n, k, np.int32), np.zeros((n, 2)),
            np.zeros((n, no)), np.full(n, order, np.int32),
            np.zeros(n, np.int64), np.full(n, wm, np.int32))
    fi_s, _, _, _ = jax.block_until_ready(sharding.sharded_fit_many(
        mesh, *args, dimension=2, NO=no))
    spread(fi_s, D)
    with jax.default_device(one):
        fi_1 = np.asarray(wt.fit_many(delta, fk_h, np.zeros((n, 2)),
                                      order=order, weighting=wm).fi)
    check("sharded_fit_many vs one device", rel_err(fi_s, fi_1),
          SHARD_PARITY)

    q = rng.uniform(-0.9, 0.9, (FOUR_QUERIES, 2))
    r = 6.0 / np.sqrt(n)   # ~28 models in reach of a query on average
    got = sharding.sharded_interpolate_continuous(
        mesh, fi_1, pts, q, r, dimension=2, order=order)
    with jax.default_device(one):
        num, den = interpolate_continuous(fi_1, pts, q, r, dimension=2,
                                          order=order)
        num, den = np.asarray(num), np.asarray(den)
        want = np.where(den > 0, num / np.where(den > 0, den, 1.0), np.nan)
    log("  continuous: %d of %d queries with no model in reach"
        % (np.isnan(want).sum(), len(q)))
    check("sharded_interpolate_continuous vs one device",
          rel_err(got, want), SHARD_PARITY)

    got = np.asarray(sharding.sharded_interpolate_nearest(
        mesh, fi_1, pts, q, dimension=2, order=order))
    nn2, d2_2 = neighbors.knn(pts, q, 2, backend="host")
    near = nn2[:, 0]
    clear = d2_2[:, 1] - d2_2[:, 0] > 1e-5   # f32 ranking cannot flip these
    with jax.default_device(one):
        want = np.asarray(eval_fit(jnp.asarray(fi_1[near]),
                                   jnp.asarray(pts[near]),
                                   jnp.asarray(q)[:, None, :],
                                   dimension=2, order=order))[:, 0]
    log("  nearest: %d of %d queries clear of Voronoi ties"
        % (clear.sum(), len(q)))
    check("sharded_interpolate_nearest vs one device",
          rel_err(got[clear], want[clear]), SHARD_PARITY)

    # distributed IBVP step: shard-local gather + case-sharded solve
    F = 2
    idx = np.asarray(neighbors.knn(pts, pts, k + 1, backend="host")[0])[:, 1:]
    prep = wt.prepare(pts[idx], pts, order=order, weighting=wm)
    u = np.stack([np.sin(np.pi * pts[:, 0]), np.cos(np.pi * pts[:, 1])], 1)
    prep_s = jax.device_put(prep, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(sharding.CASE_AXIS)))
    fk_g = sharding.sharded_gather_values(mesh, jnp.asarray(u),
                                          jnp.asarray(idx))
    spread(fk_g, D)
    if not np.array_equal(np.asarray(fk_g), u[idx]):
        raise AssertionError("sharded_gather_values differs from u[idx]")
    log("  sharded_gather_values == u[idx] exactly")
    fi_g, _ = sharding.sharded_solve_prepared(mesh, prep_s,
                                              jnp.moveaxis(fk_g, -1, 0))
    spread(fi_g, D)
    with jax.default_device(one):
        prep_1 = jax.device_put(prep, one)
        fi_g1, _ = wt.solve(prep_1, jnp.moveaxis(jnp.asarray(u[idx]), -1, 0))
    check("sharded_solve_prepared (%d fields) vs one device" % F,
          rel_err(fi_g, fi_g1), SHARD_PARITY)

    # streaming a host cloud with each chunk sharded over the mesh
    B = FOUR_STREAM_CASES
    xk_h = rng.uniform(-1.0, 1.0, (B, 30, 2))
    fk_h = np.sin(3.0 * xk_h[..., 0]) * np.cos(2.0 * xk_h[..., 1])
    kw = dict(order=4, weighting=wm, chunk=FOUR_STREAM_CHUNK)
    t0 = time.perf_counter()
    res_s = wt.fit_stream(xk_h, fk_h, mesh=mesh, **kw)
    log("  fit_stream(mesh=) %d fits in %.3f s (compile included)"
        % (B, time.perf_counter() - t0))
    with jax.default_device(one):
        res_1 = wt.fit_stream(xk_h, fk_h, **kw)
    check("fit_stream(mesh=) vs one device", rel_err(res_s.fi, res_1.fi),
          SHARD_PARITY)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded path")
    args = ap.parse_args(argv)

    import jax

    import wlsqm_tpu
    from wlsqm_tpu import config

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        print("chip_smoke: no GPU (JAX found %s)" % dev.platform,
              file=sys.stderr)
        return 2
    log("device_kind %s | count %d" % (dev.device_kind, len(devs)))
    log("jax %s | wlsqm_tpu %s | XLA_FLAGS=%r | compile cache %s"
        % (jax.__version__, wlsqm_tpu.__version__,
           os.environ.get("XLA_FLAGS", ""), config.cache_dir()))
    card = card_line()
    log("nvidia-smi: %s" % card.replace("\n", " / "))

    t0 = time.perf_counter()
    if args.four:
        four_phase(args.seed)
        count = 4
    else:
        headline_phase(args.seed, dev)
        ibvp_phase(args.seed, dev)
        wide_phase(args.seed, dev)
        count = len(devs)
    log("all phases passed in %.1f s" % (time.perf_counter() - t0))
    log("nvidia-smi: %s" % card.replace("\n", " / "))
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
