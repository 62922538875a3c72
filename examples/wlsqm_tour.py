"""Tour of the wlsqm_tpu API: fits, derivatives, interpolation, sensitivity.

A from-scratch analogue of the reference's example tour
(reference: examples/wlsqm_example.py): manufactured polynomial solutions in
1D/2D/3D, all derivative DOFs checked against closed forms, the knowns
mechanism, iterative refinement, and model interpolation — exercised through
both the compatibility API and the JAX-native API.

Run: python examples/wlsqm_tour.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import wlsqm_tpu as wt


def banner(msg):
    print("\n" + "=" * 72)
    print(msg)
    print("=" * 72)


def tour_1d(rng):
    banner("1D: f(x) = 2 + x - 3x^2 + 0.5x^3, order 3, all derivatives")
    def f(x):
        return 2.0 + x - 3.0 * x**2 + 0.5 * x**3
    expected = np.array([2.0, 1.0, -6.0, 3.0])  # f, f', f'', f''' at 0

    xk = rng.uniform(-1, 1, 25)
    fi = np.zeros(wt.number_of_dofs(1, 3))
    wt.fit_1D(xk=xk, fk=f(xk), xi=0.0, fi=fi, sens=None, do_sens=False,
              order=3, knowns=0, weighting_method=wt.WEIGHT_UNIFORM)
    for name, idx, want in (("f", wt.i1_F, expected[0]),
                            ("f'", wt.i1_X, expected[1]),
                            ("f''", wt.i1_X2, expected[2]),
                            ("f'''", wt.i1_X3, expected[3])):
        print(f"  {name:5s} = {fi[idx]:+.12f}   (exact {want:+g}, "
              f"err {abs(fi[idx]-want):.2e})")


def tour_2d(rng):
    banner("2D: full order-4 fit of a quartic, every mixed derivative")
    def f(xy):
        x, y = xy[..., 0], xy[..., 1]
        return x**4 - 2 * x**3 * y + 3 * x * y**3 + x * y - y**2

    xk = rng.uniform(-1, 1, (60, 2))
    fi = np.zeros(wt.number_of_dofs(2, 4))
    it = wt.fit_2D_iterative(xk=xk, fk=f(xk), xi=np.zeros(2), fi=fi,
                             sens=None, do_sens=False, order=4, knowns=0,
                             weighting_method=wt.WEIGHT_UNIFORM, max_iter=10)
    # analytic derivative values at the origin in the DOF ordering
    exact = np.zeros(15)
    exact[wt.i2_XY] = 1.0          # d2/dxdy of x*y
    exact[wt.i2_Y2] = -2.0         # d2/dy2 of -y^2
    exact[wt.i2_X4] = 24.0         # d4/dx4 of x^4
    exact[wt.i2_X3Y] = -12.0       # d4/dx3dy of -2x^3y
    exact[wt.i2_XY3] = 18.0        # d4/dxdy3 of 3xy^3
    err = np.abs(fi - exact).max()
    print(f"  refinement iterations: {it}; max DOF error: {err:.2e}")

    # interpolate the fitted model and its x-derivative at fresh points
    q = rng.uniform(-0.5, 0.5, (5, 2))
    v = wt.interpolate_fit(np.zeros(2), fi, 2, 4, q, diff=wt.i2_F)
    print("  interpolation errors:", np.abs(v - f(q)).round(14))


def tour_knowns(rng):
    banner("Knowns / Neumann-style elimination: pin df/dy, solve the rest")
    def f(xy):
        x, y = xy[..., 0], xy[..., 1]
        return 1.0 + 2.0 * x + 3.0 * y + 0.5 * x * y

    xk = rng.uniform(-1, 1, (20, 2))
    fi = np.zeros(wt.number_of_dofs(2, 2))
    fi[wt.i2_Y] = 3.0  # prescribe the normal derivative (exact here)
    wt.fit_2D(xk=xk, fk=f(xk), xi=np.zeros(2), fi=fi, sens=None,
              do_sens=False, order=2, knowns=wt.b2_Y,
              weighting_method=wt.WEIGHT_UNIFORM)
    print(f"  F  = {fi[wt.i2_F]:+.12f} (exact +1)")
    print(f"  X  = {fi[wt.i2_X]:+.12f} (exact +2)")
    print(f"  Y  = {fi[wt.i2_Y]:+.12f} (pinned, must stay exactly 3)")


def tour_sensitivity(rng):
    banner("Sensitivity: d fi / d fk, all neighbors at once")
    xk = rng.uniform(-1, 1, (15, 2))
    fk = rng.standard_normal(15)
    fi = np.zeros(6)
    sens = np.zeros((15, 6))
    wt.fit_2D(xk=xk, fk=fk, xi=np.zeros(2), fi=fi, sens=sens, do_sens=True,
              order=2, knowns=0, weighting_method=wt.WEIGHT_CENTER)
    # rows of sens sum to the model's response to a constant shift: exactly
    # 1 for the F slot, 0 for derivative slots
    colsum = sens.sum(axis=0)
    print("  sum_k sens[k, :] =", colsum.round(12), " (expect [1, 0, ...])")


def tour_jax_native(rng):
    banner("JAX-native batch API: 10k fits in one compiled call")
    def f(xy):
        x, y = xy[..., 0], xy[..., 1]
        return np.sin(x) * np.cos(y)

    centers = rng.uniform(-1, 1, (10_000, 2))
    xk = centers[:, None, :] + rng.uniform(-0.1, 0.1, (10_000, 20, 2))
    res = wt.fit_many(xk, f(xk), centers, order=2,
                      weighting=wt.WEIGHT_CENTER)
    fi = np.asarray(res.fi)
    dx_exact = np.cos(centers[:, 0]) * np.cos(centers[:, 1])
    print(f"  max df/dx error over 10k fits: "
          f"{np.abs(fi[:, wt.i2_X] - dx_exact).max():.2e}")


def tour_autodiff(rng):
    banner("Autodiff (beyond the reference): jax.grad through the fit")
    import jax
    import jax.numpy as jnp

    from wlsqm_tpu.fitter import defs, engine

    B, K, NO = 8, 18, 6
    xk = jnp.asarray(rng.uniform(-1, 1, (B, K, 2)))
    fk = jnp.sin(xk[..., 0]) * jnp.cos(xk[..., 1])
    args = (jnp.full((B,), K, jnp.int32), jnp.zeros((B, 2)),
            jnp.zeros((B, NO)), jnp.full((B,), 2, jnp.int32),
            jnp.zeros((B,), jnp.int64),
            jnp.full((B,), defs.WEIGHT_CENTER, jnp.int32))

    def x_deriv_sum(fk):
        fi, _, _, _ = engine.fit_batch(xk, fk, *args, dimension=2, NO=NO)
        return fi[:, wt.i2_X].sum()

    # reverse mode over the DATA reproduces the reference's sens column
    g_fk = jax.grad(x_deriv_sum)(fk)
    _, sens, _, _ = engine.fit_batch(xk, fk, *args, dimension=2, NO=NO,
                                     do_sens=True)
    print("  d(sum f_x)/d fk vs sens column: max diff "
          f"{float(jnp.abs(g_fk - sens[:, :, wt.i2_X]).max()):.2e}")

    # ... and the GEOMETRY gradient has no reference counterpart at all
    def x_deriv_sum_geom(x):
        fi, _, _, _ = engine.fit_batch(x, fk, *args, dimension=2, NO=NO)
        return fi[:, wt.i2_X].sum()

    g_xk = jax.grad(x_deriv_sum_geom)(xk)
    print(f"  d(sum f_x)/d xk exists too: shape {tuple(g_xk.shape)}, "
          f"max |g| {float(jnp.abs(g_xk).max()):.2f} "
          "(sensor-placement design; see examples/gradient_stencil_design"
          ".py and docs/autodiff.md)")


if __name__ == "__main__":
    rng = np.random.default_rng(42)
    tour_1d(rng)
    tour_2d(rng)
    tour_knowns(rng)
    tour_sensitivity(rng)
    tour_jax_native(rng)
    tour_autodiff(rng)
    print("\nAll tour stages done.")
