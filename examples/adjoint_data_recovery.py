"""Adjoint data recovery: backprop THROUGH the WLSQM fit.

An inverse problem the reference cannot express: we observe a noisy
field ``u_obs`` at scattered points and know the PDE source it must
satisfy (here a manufactured Poisson problem, lap u = g).  WLSQM gives
the Laplacian estimate at every point — a batched local fit of the
nodal values — so "find the field whose WLSQM-Laplacian matches g while
staying close to the observations" is a smooth optimization over the
nodal values:

    min_u   mean( (lap_wlsqm(u) - g)^2 ) + lam * mean( (u - u_obs)^2 )

The gradient of the first term needs the adjoint of the fit with
respect to the DATA.  The geometry is fixed, so it is prepared once
(:func:`wlsqm_tpu.prepare`); the prepared solve is linear in the data and
built from differentiable XLA ops, so ``jax.grad`` flows through
:func:`wlsqm_tpu.solve` and the neighbor gather ``u[idx]`` back to the
nodal values.  The reference computes the same sensitivity array
(wlsqm/fitter/impl.pyx:768-846) but has no machinery to chain it through
a gather into an optimizer.

Run: python examples/adjoint_data_recovery.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

import wlsqm_tpu as wt
from wlsqm_tpu.fitter import defs

N_SIDE = 32                 # 32 x 32 grid -> B = 1024 cases
K = 12                      # neighbors per case (nearest, self excluded)
LAM = 2e-3                  # data-fidelity weight
STEPS = 60
LR = 4e-3


def main():
    # manufactured Poisson problem on [0,1]^2
    h = 1.0 / (N_SIDE - 1)
    g1 = np.linspace(0.0, 1.0, N_SIDE)
    X, Y = np.meshgrid(g1, g1, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=-1)          # (B, 2)
    B = pts.shape[0]
    u_true = np.sin(np.pi * X) * np.sin(np.pi * Y)
    lap_true = -2.0 * np.pi ** 2 * u_true                    # lap u = g
    rng = np.random.default_rng(3)
    sigma = 0.02
    u_obs = (u_true + sigma * rng.standard_normal(u_true.shape)).ravel()
    g = jnp.asarray(lap_true.ravel())

    # K nearest neighbors of each grid point (self excluded)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    idx = np.argsort(d2, axis=1)[:, :K]                      # (B, K)
    idx_j = jnp.asarray(idx)
    xi = jnp.asarray(pts)
    xk = jnp.asarray(pts[idx])                               # (B, K, 2)
    prep = wt.prepare(xk, xi, order=2, weighting=defs.WEIGHT_CENTER)

    iX2, iY2 = defs.i2_X2, defs.i2_Y2

    def wlsqm_lap(prep, u):
        """WLSQM Laplacian estimate at every point, from nodal values."""
        fk = u[idx_j]                       # differentiable gather
        fi, _ = wt.solve(prep, fk)
        return fi[:, iX2] + fi[:, iY2]

    @jax.jit
    def loss_and_grad(prep, u):
        def loss(u):
            r = wlsqm_lap(prep, u) - g
            return (r ** 2).mean() + LAM * ((u - u_obs) ** 2).mean()

        return jax.value_and_grad(loss)(u)

    def rel(u):
        return float(np.linalg.norm(u - u_true.ravel())
                     / np.linalg.norm(u_true.ravel()))

    u = jnp.asarray(u_obs)
    print("noisy observation rel error: %.4f" % rel(np.asarray(u)))
    for it in range(STEPS):
        val, grad = loss_and_grad(prep, u)
        u = u - LR * grad / (jnp.abs(grad).max() + 1e-30) * \
            jnp.abs(u).max()                # scale-free fixed step
        if it % 10 == 0 or it == STEPS - 1:
            print("step %3d  loss %.5e  rel err %.4f"
                  % (it, float(val), rel(np.asarray(u))))

    final = rel(np.asarray(u))
    base = rel(u_obs)
    print("recovered rel error %.4f vs noisy %.4f (%.1fx reduction)"
          % (final, base, base / final))
    assert final < 0.6 * base, "adjoint recovery should beat the raw data"
    print("OK")


if __name__ == "__main__":
    main()
