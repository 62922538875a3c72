"""ExpertSolver: project scattered data onto a regular grid.

Analogue of the reference's ExpertSolver example
(reference: examples/expertsolver_example.py): fit local models at scattered
sample sites, then evaluate the patched global surrogate on a uniform grid
via nearest-model and continuous blending.

Run: python examples/expertsolver_example.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import wlsqm_tpu as wt
from wlsqm_tpu.utils import neighbors


def main():
    rng = np.random.default_rng(42)

    def field(xy):
        x, y = xy[..., 0], xy[..., 1]
        return np.sin(2 * x) * np.cos(3 * y) + 0.25 * x * y

    # scattered samples
    npts, k = 3000, 20
    pts = rng.uniform(-1, 1, (npts, 2))
    vals = field(pts)

    # every sample site is also a fit origin; neighbors from the cloud
    xk_idx, _ = neighbors.knn(pts, pts, k + 1, backend="device")
    xk_idx = np.asarray(xk_idx)[:, 1:]
    xk = pts[xk_idx]
    fk = vals[xk_idx]

    solver = wt.ExpertSolver(
        dimension=2,
        nk=np.full(npts, k, np.int32),
        order=np.full(npts, 2, np.int32),
        knowns=np.zeros(npts, np.int64),
        weighting_method=np.full(npts, wt.WEIGHT_CENTER, np.int32),
    )
    solver.prepare(xi=pts, xk=xk)
    fi = np.zeros((npts, wt.number_of_dofs(2, 2)))
    solver.solve(fk=fk, fi=fi)
    print("prepared+solved %d local models; device memory used: %.1f MB"
          % (npts, solver.memory_used()[0] / 1e6))

    # project onto a grid
    g = np.linspace(-0.9, 0.9, 61)
    gx, gy = np.meshgrid(g, g)
    grid = np.stack([gx.ravel(), gy.ravel()], -1)

    solver.prep_interpolate()
    near, idx = solver.interpolate(grid, mode="nearest")
    cont, _ = solver.interpolate(grid, mode="continuous", r=0.25)
    truth = field(grid)
    print(f"nearest    projection: max err {np.abs(near - truth).max():.3e}")
    print(f"continuous projection: max err {np.abs(cont - truth).max():.3e}")

    # gradient field on the grid from the same fits
    ddx, _ = solver.interpolate(grid, mode="nearest", diff=wt.i2_X, I=idx)
    ddx_true = 2 * np.cos(2 * grid[:, 0]) * np.cos(3 * grid[:, 1]) \
        + 0.25 * grid[:, 1]
    print(f"d/dx       projection: max err {np.abs(ddx - ddx_true).max():.3e}")


if __name__ == "__main__":
    main()
