"""Meshless compressible Euler flow: the reference's flagship application.

The reference was built to drive explicit meshless flow solvers — its theory
docs include a full compressible-flow application writeup (reference:
doc/eulerflow.pdf via README.md:226-231).  This example reproduces that
workload as batched device programs: the 2D compressible Euler equations

    U_t + F(U)_x + G(U)_y = 0,       U = (rho, rho*u, rho*v, E)

solved on a scattered periodic point cloud, with every spatial derivative
coming from WLSQM fits.  The classic isentropic-vortex test gives an exact
solution to verify against (the vortex advects with the freestream,
unchanged in shape).

The WLSQM mechanics on display:

* periodic neighborhoods: neighbor *positions* are ghost translates of the
  cloud (the fit sees true geometric offsets), while neighbor *values* are
  gathered from the owning points — the meshless analogue of ghost cells;
* prepare-once / solve-many: the geometry never changes, so the factorized
  normal matrices are built once and each Runge-Kutta stage is one batched
  multi-RHS solve of all 8 flux fields (4 components x 2 flux functions)
  through the same factorization — the reference's guest-mode pattern
  (reference: wlsqm/fitter/expert.pyx:110-124) done batch-style;
* the whole time loop is one jit-compiled ``lax.scan``.

Run: python examples/euler_flow.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

import wlsqm_tpu as wt
from wlsqm_tpu.utils import neighbors

GAMMA = 1.4
L = 10.0          # periodic domain [0, L]^2
BETA = 5.0        # vortex strength
U_INF = (1.0, 1.0)


def vortex_primitive(pts, t):
    """Exact isentropic-vortex primitives (rho, u, v, p) at time t."""
    xc = (5.0 + U_INF[0] * t) % L
    yc = (5.0 + U_INF[1] * t) % L
    # periodic-minimal offsets to the vortex center
    dx = (pts[..., 0] - xc + L / 2) % L - L / 2
    dy = (pts[..., 1] - yc + L / 2) % L - L / 2
    r2 = dx * dx + dy * dy
    ex = np.exp(0.5 * (1.0 - r2))
    u = U_INF[0] - BETA / (2 * np.pi) * ex * dy
    v = U_INF[1] + BETA / (2 * np.pi) * ex * dx
    T = 1.0 - (GAMMA - 1) * BETA**2 / (8 * GAMMA * np.pi**2) * np.exp(1.0 - r2)
    rho = T ** (1.0 / (GAMMA - 1))
    p = rho * T
    return rho, u, v, p


def conservative(rho, u, v, p):
    E = p / (GAMMA - 1) + 0.5 * rho * (u * u + v * v)
    return np.stack([rho, rho * u, rho * v, E], axis=-1)


def main():
    rng = np.random.default_rng(42)
    nside, k = 48, 24
    n = nside * nside

    # jittered-grid cloud: scattered, but with controlled fill distance
    g = (np.arange(nside) + 0.5) * (L / nside)
    pts = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    pts += rng.uniform(-0.25, 0.25, pts.shape) * (L / nside)
    pts %= L

    # periodic neighborhoods: query against the 3x3 ghost tiling; neighbor
    # positions keep their ghost coordinates (true offsets), values gather
    # from the owning point (idx mod n)
    shifts = np.array([(i, j) for i in (-L, 0.0, L) for j in (-L, 0.0, L)])
    pts_tiled = (pts[None, :, :] + shifts[:, None, :]).reshape(-1, 2)
    idx_t, _ = neighbors.knn(pts_tiled, pts, k + 1, backend="host")
    idx_t = np.asarray(idx_t)[:, 1:]              # drop self (distance 0)
    xk = jnp.asarray(pts_tiled[idx_t])            # (B, K, 2) ghost positions
    own = jnp.asarray(idx_t % n)                  # (B, K) owning data index

    # prepare once (order 3: 4th-order first derivatives on smooth fields)
    prep = wt.prepare(xk, jnp.asarray(pts), order=3,
                      weighting=wt.WEIGHT_CENTER)
    ix, iy = wt.i2_X, wt.i2_Y

    def flux_fields(U):
        """The 8 flux components (B, 8): F(U) then G(U)."""
        rho, mx, my, E = U[:, 0], U[:, 1], U[:, 2], U[:, 3]
        u, v = mx / rho, my / rho
        p = (GAMMA - 1) * (E - 0.5 * rho * (u * u + v * v))
        F = jnp.stack([mx, mx * u + p, my * u, (E + p) * u], -1)
        G = jnp.stack([my, mx * v, my * v + p, (E + p) * v], -1)
        return jnp.concatenate([F, G], -1)

    def rhs(U):
        """-div(F, G) at every point from one multi-RHS prepared solve."""
        fl = flux_fields(U)                       # (B, 8)
        fk = fl[own]                              # (B, K, 8) row gather
        fi, _ = wt.solve(prep, jnp.moveaxis(fk, -1, 0))   # (8, B, NO)
        return -(fi[:4, :, ix] + fi[4:, :, iy]).T          # (B, 4)

    # explicit SSP-RK3 within the advective CFL
    h = L / nside
    c_inf = np.sqrt(GAMMA)                         # freestream sound speed
    dt = 0.3 * h / (np.hypot(*U_INF) + c_inf)
    t_end = 1.0
    nsteps = int(np.ceil(t_end / dt))
    dt = t_end / nsteps

    @jax.jit
    def step(U, _):
        U1 = U + dt * rhs(U)
        U2 = 0.75 * U + 0.25 * (U1 + dt * rhs(U1))
        Un = U / 3.0 + 2.0 / 3.0 * (U2 + dt * rhs(U2))
        return Un, None

    U0 = jnp.asarray(conservative(*vortex_primitive(pts, 0.0)))
    U, _ = jax.lax.scan(step, U0, None, length=nsteps)

    rho = np.asarray(U[:, 0])
    rho_exact = vortex_primitive(pts, t_end)[0]
    err = np.abs(rho - rho_exact)
    print(f"cloud: {n} points, k={k}, order 3; {nsteps} SSP-RK3 steps, "
          f"dt={dt:.4f}, t_end={t_end}")
    print(f"density error vs exact vortex: max {err.max():.3e}, "
          f"rms {np.sqrt((err**2).mean()):.3e}")
    assert np.isfinite(rho).all(), "solution blew up"
    assert err.max() < 2e-2, "vortex drifted from the exact solution"
    print("OK")


if __name__ == "__main__":
    main()
