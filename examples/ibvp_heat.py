"""Meshless heat equation: the prepare-once / solve-many flagship workload.

Solves  u_t = nu * (u_xx + u_yy)  on a scattered 2D point cloud with explicit
Euler time stepping, using WLSQM as the meshless spatial discretization —
the primary application the reference was built for (reference:
README.md:29-34, doc/eulerflow.pdf).  Dirichlet boundary values are pinned;
the Laplacian at every interior point comes from the X2 + Y2 DOFs of the
local fits.

The geometry never changes, so the factorized normal matrices are prepared
once (:func:`wlsqm_tpu.prepare`) and every time step is a single batched
``solve`` — the exact pattern the reference's ExpertSolver exists for
(reference: wlsqm/fitter/expert.pyx:66-89), here as one jit-compiled scan.

Run: python examples/ibvp_heat.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

import wlsqm_tpu as wt
from wlsqm_tpu.utils import neighbors


def main():
    rng = np.random.default_rng(42)
    nu = 0.05
    n_interior, n_boundary_per_side = 2000, 40
    k = 16

    # scattered interior + boundary points of the unit square
    interior = rng.uniform(0.02, 0.98, (n_interior, 2))
    t = np.linspace(0, 1, n_boundary_per_side)
    boundary = np.concatenate([
        np.stack([t, np.zeros_like(t)], -1),
        np.stack([t, np.ones_like(t)], -1),
        np.stack([np.zeros_like(t), t], -1),
        np.stack([np.ones_like(t), t], -1),
    ])
    pts = np.concatenate([interior, boundary])
    is_interior = np.arange(len(pts)) < n_interior

    # manufactured solution: u(x,y,t) = exp(-2 pi^2 nu t) sin(pi x) sin(pi y)
    def exact(p, tt):
        return (np.exp(-2 * np.pi**2 * nu * tt)
                * np.sin(np.pi * p[..., 0]) * np.sin(np.pi * p[..., 1]))

    u0 = exact(pts, 0.0)

    # neighborhoods over the full cloud (self excluded: F stays a fit DOF)
    xk_idx, _ = neighbors.knn(pts, pts, k + 1, backend="device")
    xk_idx = np.asarray(xk_idx)[:, 1:]
    xk = jnp.asarray(pts[xk_idx])

    # prepare once: order-2 fits, function value unknown at the fit origin
    prep = wt.prepare(xk, jnp.asarray(pts), order=2,
                      weighting=wt.WEIGHT_CENTER)

    dt = 2e-5
    nsteps = 500
    lap_idx = jnp.asarray([wt.i2_X2, wt.i2_Y2])
    interior_mask = jnp.asarray(is_interior)
    idx = jnp.asarray(xk_idx)

    @jax.jit
    def step(u, _):
        fk = u[idx]                                   # gather neighbor values
        fi, _sens = wt.solve(prep, fk)
        lap = fi[:, lap_idx].sum(axis=1)
        u_new = u + dt * nu * lap
        u_new = jnp.where(interior_mask, u_new, u)     # Dirichlet boundary
        return u_new, None

    u = jnp.asarray(u0)
    u_final, _ = jax.lax.scan(step, u, None, length=nsteps)

    t_final = dt * nsteps
    err = np.abs(np.asarray(u_final) - exact(pts, t_final))
    print(f"steps: {nsteps}, dt={dt:g}, t_final={t_final:g}")
    print(f"max error vs exact solution: {err.max():.3e}")
    print(f"rms error:                   {np.sqrt((err**2).mean()):.3e}")
    assert err.max() < 5e-3, "heat solution drifted from the exact solution"
    print("OK")

    # ------------------------------------------------------------------
    # Multi-field stepping: several species diffusing on the SAME cloud.
    # One row-gather u[idx] -> (B, K, F) fetches every field's neighbor
    # values (gather cost is per-index, not per-payload), and the prepared
    # factorization solves all F fields through its multi-RHS (F, B, K)
    # path — the reference's guest-mode pattern (multiple fields sharing
    # one prepared geometry, reference: wlsqm/fitter/expert.pyx:110-124)
    # done batch-style (per-field step cost vs F:
    # benchmarks/run_ibvp_multifield.py).
    # ------------------------------------------------------------------
    # diffusivities within the dt-stability envelope of the base run
    nus = np.array([0.02, 0.035, 0.05])
    F = len(nus)
    nus_j = jnp.asarray(nus)

    @jax.jit
    def multi_step(u, _):
        fk = u[idx]                                   # ONE gather: (B, K, F)
        fi, _sens = wt.solve(prep, jnp.moveaxis(fk, -1, 0))   # (F, B, NO)
        lap = fi[..., lap_idx].sum(-1)                # (F, B)
        u_new = u + dt * nus_j[None, :] * lap.T
        return jnp.where(interior_mask[:, None], u_new, u), None

    u0_multi = jnp.asarray(np.repeat(u0[:, None], F, axis=1))
    u_multi, _ = jax.lax.scan(multi_step, u0_multi, None, length=nsteps)

    for f in range(F):
        want = (np.exp(-2 * np.pi**2 * nus[f] * t_final)
                * np.sin(np.pi * pts[:, 0]) * np.sin(np.pi * pts[:, 1]))
        err_f = np.abs(np.asarray(u_multi[:, f]) - want)
        print(f"field {f} (nu={nus[f]}): max error {err_f.max():.3e}")
        assert err_f.max() < 5e-3
    print("multi-field OK")


if __name__ == "__main__":
    main()
