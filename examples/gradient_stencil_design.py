"""Differentiable stencil design: optimize neighbor GEOMETRY by jax.grad.

The reference computes one derivative by hand — the data sensitivity
``sens[k,j] = d fi[j] / d fk[k]`` (reference: wlsqm/fitter/impl.pyx:768-846)
— and uses it to reason about noise amplification.  Because the JAX
rebuild's engine is a differentiable XLA program, we can go one step
further than the reference ever could: differentiate that noise
amplification with respect to the NEIGHBOR POSITIONS and descend on it.

Concretely: estimating the first derivative f_x at a point from noisy
samples amplifies i.i.d. noise of std sigma into DOF noise of std

    sigma_X = sigma * || sens[:, i2_X] ||_2

This script starts from a mediocre stencil (a random cloud squashed into
an anisotropic blob), and runs plain gradient descent on the neighbor
coordinates to minimize the X-derivative noise amplification at fixed
neighbor count — the whole fit + sensitivity pipeline sits inside
``jax.grad``.  A penalty keeps the points inside the design radius.

The optimized stencil's amplification approaches the isotropic
well-spread layout's, and a Monte-Carlo check with actual noisy data
confirms the predicted improvement.

Run: python examples/gradient_stencil_design.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

import wlsqm_tpu as wt
from wlsqm_tpu.fitter import defs, engine

K, DIM, ORDER = 20, 2, 2
NO = defs.number_of_dofs(DIM, ORDER)
R = 0.3          # design radius: neighbors should stay within this ball
STEPS = 200
LR = 2e-3


def amplification(xk):
    """Noise amplification ||sens[:, i2_X]||_2 of the X-derivative DOF."""
    B = 1
    fk = jnp.zeros((B, K))      # sens depends on geometry only
    _, sens, _, _ = engine.fit_batch(
        xk[None], fk, jnp.full((B,), K, jnp.int32), jnp.zeros((B, DIM)),
        jnp.zeros((B, NO)), jnp.full((B,), ORDER, jnp.int32),
        jnp.zeros((B,), jnp.int64),
        jnp.full((B,), defs.WEIGHT_UNIFORM, jnp.int32),
        dimension=DIM, NO=NO, do_sens=True, precision="f64",
        scaling="jacobi")
    return jnp.sqrt((sens[0, :, defs.i2_X] ** 2).sum())


def objective(xk):
    # soft wall keeping the stencil inside the design radius
    r = jnp.sqrt((xk ** 2).sum(-1))
    wall = (jnp.maximum(r - R, 0.0) ** 2).sum()
    return amplification(xk) + 1e3 * wall


def monte_carlo_noise(xk, trials=4000, sigma=1.0, seed=0):
    """Measured std of the fitted X DOF under i.i.d. data noise."""
    rng = np.random.default_rng(seed)
    fk = sigma * rng.standard_normal((trials, K))
    res = wt.fit_many(np.broadcast_to(np.asarray(xk), (trials, K, DIM)),
                      fk, order=ORDER, precision="f64")
    return float(np.std(np.asarray(res.fi)[:, defs.i2_X]))


def main():
    rng = np.random.default_rng(42)
    # mediocre starting stencil: anisotropic squashed blob
    xk0 = rng.uniform(-R, R, (K, DIM))
    xk0[:, 0] *= 0.25

    amp0 = float(amplification(jnp.asarray(xk0)))
    print("initial   amplification: %.3f" % amp0)

    grad = jax.jit(jax.grad(objective))
    xk = jnp.asarray(xk0)
    for i in range(STEPS):
        xk = xk - LR * grad(xk)
    ampN = float(amplification(xk))
    print("optimized amplification: %.3f  (%.1fx lower)"
          % (ampN, amp0 / ampN))

    # reference layout: well-spread isotropic ring(s)
    th = 2 * np.pi * np.arange(K) / K
    ring = R * np.stack([np.cos(th), np.sin(th)], -1)
    ring[K // 2:] *= 0.55
    ampR = float(amplification(jnp.asarray(ring)))
    print("isotropic-ring baseline: %.3f" % ampR)

    mc0 = monte_carlo_noise(xk0)
    mcN = monte_carlo_noise(np.asarray(xk))
    print("Monte-Carlo DOF noise std: initial %.3f -> optimized %.3f "
          "(predicted %.3f -> %.3f)" % (mc0, mcN, amp0, ampN))

    assert ampN < 0.55 * amp0, "descent should substantially improve the stencil"
    assert abs(mcN - ampN) < 0.15 * ampN, "prediction should match Monte Carlo"
    print("OK")


if __name__ == "__main__":
    main()
