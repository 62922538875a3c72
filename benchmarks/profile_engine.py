"""Where the f64 engine's time goes on the default device.

Measures, at the headline shape (2D order 4, K=30, WEIGHT_CENTER,
262,144-case chunks) and the IBVP shape (1M points, k=28, order 2):

* fits/s of the public route for the default Cholesky (``solver="chol"``),
  the trace-time-unrolled one (``"chol_unrolled"``) and one-pass Jacobi
  scaling in place of the Ruiz loop (``scaling="jacobi"``), each as the
  median of 5 synced calls and as 16 calls back to back with one sync;
* the Ruiz equilibration trip count (the ``lax.while_loop`` runs until
  the slowest case converges) and the ALGO_ITERATIVE trip count;
* the ``u[idx]`` neighbour gather in indices/s, and one IBVP step split
  into gather and prepared solve;
* a ``jax.profiler`` trace of three headline calls, reduced to device
  time per operation name, the device busy share of the traced window,
  and the host span of each call.

Run: python benchmarks/profile_engine.py [out_dir]   (default chiprun_out)
Prints a report and writes ``engine_profile.json`` (and the trace) there.
"""

import glob
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

import wlsqm_tpu as wt
from wlsqm_tpu.fitter import engine
from wlsqm_tpu.utils import neighbors

HEADLINE_CASES = 262_144
IBVP_POINTS = 1_000_000
LOOP_CALLS = 16


def median_time(fn, *args, reps=5):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2], (ts[-1] - ts[0]) / ts[len(ts) // 2]


def device_time_by_op(trace_dir):
    """Sum device event durations by name over the GPU planes of a trace.

    Returns (rows sorted by time, busy_ns, window_ns): busy is the union
    of event intervals on the device planes, window the span from the
    first event start to the last event end.
    """
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    prof = ProfileData.from_file(path)
    by_name, intervals = {}, []
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = [ln for ln in plane.lines if "XLA Ops" in ln.name]
        if not lines:   # fall back to the CUDA stream lines (kernel names)
            lines = [ln for ln in plane.lines
                     if ln.name.startswith("Stream")]
        print("trace plane %s: lines %s" % (
            plane.name, [ln.name for ln in plane.lines][:12]), flush=True)
        for line in lines:
            for ev in line.events:
                by_name[ev.name] = by_name.get(ev.name, 0) + ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    intervals.sort()
    busy, end = 0.0, -np.inf
    for s, e in intervals:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = intervals[-1][1] - intervals[0][0] if intervals else 0.0
    rows = sorted(by_name.items(), key=lambda kv: -kv[1])
    return rows, busy, window


def main():
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "chiprun_out"
    os.makedirs(out_dir, exist_ok=True)
    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip() if dev.platform == "gpu" else "no GPU"
    report = {"device_kind": dev.device_kind, "platform": dev.platform,
              "card": card}
    print("device %s | %s" % (dev.device_kind, card), flush=True)

    B, K, order, wm = HEADLINE_CASES, 30, 4, wt.WEIGHT_CENTER
    key = jax.random.PRNGKey(0)
    xk = jax.random.uniform(key, (B, K, 2), jnp.float64, -1.0, 1.0)
    fk = jnp.sin(3.0 * xk[..., 0]) * jnp.cos(2.0 * xk[..., 1])
    xi = jnp.zeros((B, 2))

    fi_by = {}
    for solver, scaling in (("chol", "ruiz"), ("chol_unrolled", "ruiz"),
                            ("chol", "jacobi")):
        fn = jax.jit(lambda a, b, c, s=solver, sc=scaling: wt.fit_many(
            a, b, c, order=order, weighting=wm, solver=s, scaling=sc).fi)
        t0 = time.perf_counter()
        fi_by[solver, scaling] = np.asarray(fn(xk, fk, xi))
        compile_s = time.perf_counter() - t0
        dt, spread = median_time(fn, xk, fk, xi)
        # back to back, one sync at the end: a host loop over chunks
        t0 = time.perf_counter()
        jax.block_until_ready([fn(xk, fk, xi) for _ in range(LOOP_CALLS)])
        dt_loop = (time.perf_counter() - t0) / LOOP_CALLS
        name = "%s_%s" % (solver, scaling)
        report["fits_per_s_" + name] = B / dt
        report["spread_" + name] = spread
        report["fits_per_s_loop_" + name] = B / dt_loop
        print("solver=%-13s scaling=%-6s compile+first %.2f s | %.1f fits/s "
              "(spread %.1f%%) | back to back %.1f fits/s"
              % (solver, scaling, compile_s, B / dt, 100 * spread,
                 B / dt_loop), flush=True)
    want = fi_by["chol", "ruiz"]
    for key, got in fi_by.items():
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        report["rel_vs_chol_ruiz_%s_%s" % key] = rel
        print("  %s/%s vs chol/ruiz: %.3e relative" % (key + (rel,)))

    prep = jax.jit(lambda a, c: wt.prepare(a, c, order=order,
                                           weighting=wm))(xk, xi)
    ri = np.asarray(prep.ruiz_iters)
    report["ruiz_trips"] = int(ri.max())
    report["ruiz_iters_mean"] = float(ri.mean())
    res = jax.jit(lambda a, b, c: wt.fit_many(
        a, b, c, order=order, weighting=wm, iterative=True,
        max_iter=3))(xk, fk, xi)
    it = np.asarray(res.iterations)
    report["iterative_trips"] = int(it.max())
    print("Ruiz sweeps: max %d (loop trips), mean %.2f | ALGO_ITERATIVE "
          "max_iter=3: max %d, mean %.2f"
          % (ri.max(), ri.mean(), it.max(), it.mean()), flush=True)

    # profiler trace of three headline calls
    fn = jax.jit(lambda a, b, c: wt.fit_many(a, b, c, order=order,
                                             weighting=wm).fi)
    jax.block_until_ready(fn(xk, fk, xi))
    trace_dir = os.path.join(out_dir, "trace_headline")
    host_ms = []
    with jax.profiler.trace(trace_dir):
        for i in range(3):
            t0 = time.perf_counter()
            with jax.profiler.TraceAnnotation("headline_call_%d" % i):
                jax.block_until_ready(fn(xk, fk, xi))
            host_ms.append((time.perf_counter() - t0) * 1e3)
    rows, busy, window = device_time_by_op(trace_dir)
    total = sum(v for _, v in rows)
    report["trace_busy_share"] = busy / window if window else None
    report["trace_host_ms_per_call"] = host_ms
    report["trace_ops"] = [(n, v / 3e6) for n, v in rows[:25]]
    print("trace: device busy %.1f%% of the %.3f ms window; host %.3f ms "
          "per call" % (100 * busy / max(window, 1), window / 1e6,
                        np.median(host_ms)), flush=True)
    print("device ms per call by op (top 25 of %d, total %.3f ms):"
          % (len(rows), total / 3e6))
    for name, ns in rows[:25]:
        print("  %9.3f ms  %5.1f%%  %s" % (ns / 3e6, 100 * ns / total,
                                           name[:90]))
    del xk, fk, prep, res

    # IBVP: u[idx] gather and one step split into gather and solve
    n, k = IBVP_POINTS, 28
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1.0, 1.0, (n, 2))
    idx_h, _ = neighbors.knn(pts, pts, k + 1, backend="host")
    idx = jnp.asarray(np.asarray(idx_h)[:, 1:].astype(np.int32))
    prep = jax.jit(lambda a, c: wt.prepare(a, c, order=2, weighting=wm))(
        jnp.asarray(pts)[idx], jnp.asarray(pts))
    u = jnp.asarray(np.exp(-4.0 * (pts ** 2).sum(-1)))
    gather = jax.jit(lambda u, idx: u[idx])
    solve = jax.jit(lambda p, f: engine.solve_prepared(
        p, f, jnp.zeros((n, 6)))[0])

    @jax.jit
    def step(p, idx, u):
        fi = engine.solve_prepared(p, u[idx], jnp.zeros((n, 6)))[0]
        return u + 1e-6 * (fi[:, wt.i2_X2] + fi[:, wt.i2_Y2])

    tg, _ = median_time(gather, u, idx)
    fk_i = gather(u, idx)
    ts, _ = median_time(solve, prep, fk_i)
    tst, _ = median_time(step, prep, idx, u)
    u4 = jnp.stack([u] * 4, axis=1)
    tg4, _ = median_time(gather, u4, idx)
    report.update(gather_idx_per_s=idx.size / tg, gather_ms=tg * 1e3,
                  gather_f4_ms=tg4 * 1e3, solve_ms=ts * 1e3,
                  step_ms=tst * 1e3)
    print("IBVP n=%d k=%d: u[idx] %.3f ms = %.3f G indices/s | (n,4) rows "
          "%.3f ms | prepared solve %.3f ms | fused step %.3f ms"
          % (n, k, tg * 1e3, idx.size / tg / 1e9, tg4 * 1e3, ts * 1e3,
             tst * 1e3), flush=True)

    with open(os.path.join(out_dir, "engine_profile.json"), "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
