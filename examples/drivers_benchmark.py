"""Benchmark the batched linear-algebra driver layer.

Analogue of the reference's LAPACK-drivers benchmark that produced its
README timing figure (reference: examples/lapackdrivers_example.py,
lapack_timings.png): solve batches of small dense systems through

  * a Python loop over numpy.linalg.solve  (the baseline the reference plots)
  * the wlsqm_tpu driver surface (mgeneral — one fused XLA batched solve)
  * the engine's unrolled batched Cholesky (the path the fitter itself uses)

and report average time per system over a size sweep.  Deterministic
(seed 42); prints a text table and writes ``driver_timings.png`` (the
rebuild's counterpart of the reference's README timing figure).

Run: python examples/drivers_benchmark.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import numpy as np

import jax

# this benchmark compares HOST driver paths (like the reference's CPU
# LAPACK figure); pin it to CPU so accelerator dispatch latency doesn't
# drown the comparison
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from wlsqm_tpu.utils import lapackdrivers as drv
from wlsqm_tpu.ops import solve as solve_ops


def bench_numpy_loop(A, b):
    t0 = time.perf_counter()
    for i in range(A.shape[2]):
        np.linalg.solve(A[:, :, i], b[:, i])
    return time.perf_counter() - t0


def bench_mgeneral(A, b):
    # warm-up: the first call at a new shape compiles the batched program
    drv.mgeneral(np.asfortranarray(A.copy()), np.asfortranarray(b.copy()))
    A2 = np.asfortranarray(A.copy())
    b2 = np.asfortranarray(b.copy())
    t0 = time.perf_counter()
    drv.mgeneral(A2, b2)
    return time.perf_counter() - t0


def bench_unrolled_chol(A_spd, b):
    # batch-first layout for the device path
    Ad = jnp.asarray(np.moveaxis(A_spd, 2, 0))
    bd = jnp.asarray(b.T)[..., None]

    @jax.jit
    def solve(Ad, bd):
        return solve_ops.solve(Ad, bd, solver=solve_ops.SOLVER_CHOLESKY_UNROLLED)

    jax.block_until_ready(solve(Ad, bd))  # compile
    t0 = time.perf_counter()
    r = solve(Ad, bd)
    float(jnp.asarray(r).sum())  # force full completion
    return time.perf_counter() - t0


def _write_figure(sizes, rows, path):
    """Log-log per-system timing figure — the rebuild's counterpart of the
    reference's ``lapack_timings.png`` (reference: README.md:85-99,
    examples/lapackdrivers_example.py:126-350)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # categorical slots 1-3 of the validated default palette
    # (dataviz reference instance), fixed assignment order
    colors = {"np loop": "#2a78d6", "mgeneral": "#eb6834",
              "unrolled chol": "#1baf7a"}
    fig, ax = plt.subplots(figsize=(7, 4.5), dpi=150)
    for name in ("np loop", "mgeneral", "unrolled chol"):
        ys = [r[name] * 1e6 for r in rows]
        ax.plot(sizes, ys, label=name, color=colors[name], lw=2,
                marker="o", ms=5)
        ax.annotate(name, (sizes[-1], ys[-1]), textcoords="offset points",
                    xytext=(6, 0), fontsize=9, color="#444444")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("system size n")
    ax.set_ylabel("time per system (µs)")
    ax.set_title("Batched small-system solves: per-instance cost "
                 "(1000-system batches, host CPU)")
    ax.grid(True, which="both", color="#dddddd", lw=0.5)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    ax.legend(frameon=False, fontsize=9)
    fig.tight_layout()
    fig.savefig(path)
    print(f"figure written: {path}")


def main():
    rng = np.random.default_rng(42)
    nbatch = 1000
    print(f"{'n':>4} | {'np loop':>12} | {'mgeneral':>12} | {'unrolled chol':>14}")
    print("-" * 52)
    sizes = (3, 6, 10, 15, 21)
    rows = []
    for n in sizes:
        M = rng.standard_normal((n, n, nbatch))
        A = M + np.moveaxis(M, 0, 1) + 2 * n * np.eye(n)[:, :, None]  # SPD-ish
        b = rng.standard_normal((n, nbatch))

        t_np = bench_numpy_loop(A, b) / nbatch
        t_mg = bench_mgeneral(A, b) / nbatch
        t_uc = bench_unrolled_chol(A, b) / nbatch
        rows.append({"np loop": t_np, "mgeneral": t_mg,
                     "unrolled chol": t_uc})
        print(f"{n:>4} | {t_np*1e6:>9.1f} us | {t_mg*1e6:>9.1f} us | "
              f"{t_uc*1e6:>11.2f} us")

    print("\n(mgeneral = one fused XLA batched solve, the reference figure's"
          "\n red/green curves; the unrolled Cholesky targets accelerators"
          "\n with wide vector units — XLA CPU handles its fully unrolled"
          "\n graph poorly, shown for completeness.)")

    try:
        _write_figure(sizes, rows,
                      os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "driver_timings.png"))
    except ImportError:
        print("matplotlib unavailable: skipping the timing figure")

    # residual sanity, mirroring the reference's < 1e-8 bound
    n = 15
    M = rng.standard_normal((n, n, 64))
    A = M + np.moveaxis(M, 0, 1) + 2 * n * np.eye(n)[:, :, None]
    b = rng.standard_normal((n, 64))
    A2 = np.asfortranarray(A.copy())
    x = np.asfortranarray(b.copy())
    drv.mgeneral(A2, x)
    worst = max(
        np.linalg.norm(A[:, :, i] @ x[:, i] - b[:, i]) / np.linalg.norm(b[:, i])
        for i in range(64)
    )
    print(f"\nworst relative residual (mgeneral, n={n}): {worst:.2e}")
    assert worst < 1e-8


if __name__ == "__main__":
    main()
