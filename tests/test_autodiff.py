"""JAX autodiff through the fit — a capability beyond the reference.

The reference exposes one hand-derived derivative: the sensitivity array
``sens[k,j] = d fi[j] / d fk[k]`` computed by extra back-substitutions
(reference: wlsqm/fitter/impl.pyx:768-846).  The rebuild's engine
path is built from differentiable XLA ops, so ``jax.grad`` / ``jacrev``
/ ``jacfwd`` deliver that matrix for free — and everything the reference
cannot: gradients with respect to the NEIGHBOR GEOMETRY ``xk`` (sensor
placement / point-cloud optimization), through the evaluated model, and
through compositions (a whole IBVP step, a response-surface pipeline).

Reverse-mode works because the equilibration loops stop gradients on
their scale factors (exact: the fit is invariant to the preconditioner —
see wlsqm_tpu/ops/ruiz.py).  ALGO_ITERATIVE's stagnation-controlled
``lax.while_loop`` supports forward mode only; reverse-mode callers use
the basic algorithm (the fixed point is the same on exact-polynomial
data).  Every public entry point runs the engine, so ``jax.grad``
through ``fit_many`` differentiates with respect to both data and
geometry.  See docs/autodiff.md for the full map.
"""

import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import wlsqm_tpu as wt
from wlsqm_tpu.fitter import defs, engine, interp


def _batch(rng, B=4, K=24, dim=2):
    xk = jnp.asarray(rng.uniform(-1.0, 1.0, (B, K, dim)))
    fk = jnp.sin(1.1 * xk[..., 0]) * jnp.cos(0.9 * xk[..., 1])
    return xk, fk


def _engine_args(B, K, order, knowns=0, weighting=defs.WEIGHT_CENTER):
    NO = defs.number_of_dofs(2, 4)
    return dict(
        nk=jnp.full((B,), K, jnp.int32),
        xi=jnp.zeros((B, 2)),
        fi0=jnp.zeros((B, NO)),
        order=jnp.full((B,), order, jnp.int32),
        knowns=jnp.full((B,), knowns, jnp.int64),
        weighting=jnp.full((B,), weighting, jnp.int32),
        NO=NO,
    )


def _fit(xk, fk, a, **kw):
    return engine.fit_batch(
        xk, fk, a["nk"], a["xi"], a["fi0"], a["order"], a["knowns"],
        a["weighting"], dimension=2, NO=a["NO"], **kw)


def test_jacrev_fk_matches_do_sens(rng):
    """Reverse-mode d fi / d fk reproduces the reference's sensitivity
    array (the engine's do_sens path) to roundoff."""
    B, K = 4, 24
    xk, fk = _batch(rng, B, K)
    a = _engine_args(B, K, order=4)

    J = jax.jacrev(lambda f: _fit(xk, f, a, precision="f64")[0])(fk)
    _, sens, _, _ = _fit(xk, fk, a, precision="f64", do_sens=True)
    diag = jnp.stack([J[b, :, b, :] for b in range(B)])   # (B, NO, K)
    off = sum(float(jnp.abs(J[b, :, c, :]).max())
              for b in range(B) for c in range(B) if b != c)
    assert off == 0.0  # cases are independent
    assert float(jnp.abs(diag - jnp.swapaxes(sens, 1, 2)).max()) < 1e-11


def test_grad_wrt_geometry_matches_fd(rng):
    """d loss / d xk — the derivative the reference cannot provide —
    matches central finite differences."""
    B, K = 3, 24
    xk, fk = _batch(rng, B, K)
    a = _engine_args(B, K, order=3)

    def loss(xk_):
        fi = _fit(xk_, fk, a, precision="f64")[0]
        return (fi ** 2).sum()

    g = jax.grad(loss)(xk)
    eps = 1e-6
    for (b, k, d) in [(0, 0, 0), (1, 5, 1), (2, 17, 0)]:
        pert = np.zeros(xk.shape)
        pert[b, k, d] = eps
        fd = (loss(xk + pert) - loss(xk - pert)) / (2 * eps)
        assert abs(float(g[b, k, d]) - float(fd)) <= 1e-6 * max(
            abs(float(fd)), 1.0)


def test_grad_through_fit_many_traced(rng):
    """jax.grad over the public fit_many traces the engine directly (no
    routing warning) and the gradient matches the engine-direct one."""
    B, K = 4, 20
    xk, fk = _batch(rng, B, K)
    a = _engine_args(B, K, order=2)

    def loss_public(f):
        return (wt.fit_many(xk, f, order=2,
                            weighting=defs.WEIGHT_CENTER).fi ** 2).sum()

    def loss_engine(f):
        return (_fit(xk, f, a, precision="f64")[0][:, :6] ** 2).sum()

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        g_pub = jax.grad(loss_public)(fk)
    g_eng = jax.grad(loss_engine)(fk)
    assert float(jnp.abs(g_pub - g_eng).max()) < 1e-9 * max(
        float(jnp.abs(g_eng).max()), 1.0)


def test_grad_fk_with_knowns(rng):
    """Prescribed (known) DOFs are constants: their fi rows carry zero
    data gradient, and the unknown-DOF gradients match finite
    differences of the eliminated system."""
    B, K = 3, 24
    xk, fk = _batch(rng, B, K)
    kn = int(defs.b2_F)
    a = _engine_args(B, K, order=2, knowns=kn)
    gi = a["fi0"].at[:, defs.i2_F].set(0.7)
    a = dict(a, fi0=gi)

    def fi_of(f):
        return _fit(xk, f, a, precision="f64")[0]

    J = jax.jacrev(fi_of)(fk)
    # the known slot is a passed-through constant
    assert float(jnp.abs(J[:, defs.i2_F]).max()) == 0.0
    eps = 1e-6
    pert = np.zeros(fk.shape)
    pert[1, 3] = eps
    fd = (fi_of(fk + pert) - fi_of(fk - pert)) / (2 * eps)
    assert float(jnp.abs(J[1, :, 1, 3] - fd[1]).max()) < 1e-6


def test_jacfwd_iterative_forward_mode(rng):
    """ALGO_ITERATIVE (stagnation-controlled while_loop) supports
    forward-mode differentiation; tangents stay finite and match the
    basic algorithm's on exact-polynomial data (where refinement is a
    no-op at the fixed point)."""
    B, K = 4, 20
    xk = jnp.asarray(rng.uniform(-1.0, 1.0, (B, K, 2)))
    coef = jnp.asarray([1.0, 2.0, 3.0, 10.0, 4.0, 12.0])

    def poly(f6, xy):
        x, y = xy[..., 0], xy[..., 1]
        return (f6[0] + f6[1] * x + f6[2] * y + 0.5 * f6[3] * x * x
                + f6[4] * x * y + 0.5 * f6[5] * y * y)

    a = _engine_args(B, K, order=2)

    def dofs_iter(f6):
        return _fit(xk, poly(f6, xk), a, precision="f64",
                    iterative=True, max_iter=3)[0][:, :6]

    def dofs_basic(f6):
        return _fit(xk, poly(f6, xk), a, precision="f64")[0][:, :6]

    Ji = jax.jacfwd(dofs_iter)(coef)
    Jb = jax.jacfwd(dofs_basic)(coef)
    assert bool(jnp.isfinite(Ji).all())
    assert float(jnp.abs(Ji - Jb).max()) < 1e-9


def test_fixed_trip_iterative_matches_while_loop(rng):
    """fixed_trip=True (lax.scan form) is bit-identical to the
    while_loop form — DOFs and iteration counts — on noisy data where
    refinement actually takes corrective steps."""
    B, K = 8, 24
    xk, fk = _batch(rng, B, K)
    fk = fk + 1e-3 * jnp.asarray(rng.standard_normal(fk.shape))
    a = _engine_args(B, K, order=4)

    fi_w, _, it_w, _ = _fit(xk, fk, a, precision="f64",
                            iterative=True, max_iter=5)
    fi_s, _, it_s, _ = _fit(xk, fk, a, precision="f64",
                            iterative=True, max_iter=5, fixed_trip=True)
    assert float(jnp.abs(fi_w - fi_s).max()) == 0.0
    assert bool((it_w == it_s).all())
    assert int(it_w.max()) >= 1  # refinement actually ran


@pytest.mark.full
def test_fixed_trip_iterative_matches_while_loop_ds(rng):
    """The ds engine's fixed_trip form is also bit-identical to its
    while_loop form (pair arithmetic identical either way)."""
    B, K = 8, 24
    xk, fk = _batch(rng, B, K)
    fk = fk + 1e-3 * jnp.asarray(rng.standard_normal(fk.shape))
    a = _engine_args(B, K, order=2)

    fi_w, _, it_w, _ = _fit(xk, fk, a, precision="ds",
                            iterative=True, max_iter=4)
    fi_s, _, it_s, _ = _fit(xk, fk, a, precision="ds",
                            iterative=True, max_iter=4, fixed_trip=True)
    assert float(jnp.abs(fi_w - fi_s).max()) == 0.0
    assert bool((it_w == it_s).all())


def test_jacrev_iterative_fixed_trip(rng):
    """Reverse mode through ALGO_ITERATIVE via fixed_trip: the gradient
    is finite and matches central finite differences on noisy data."""
    B, K = 3, 24
    xk, fk = _batch(rng, B, K)
    fk = fk + 1e-3 * jnp.asarray(rng.standard_normal(fk.shape))
    a = _engine_args(B, K, order=3)

    def loss(f):
        fi = _fit(xk, f, a, precision="f64", iterative=True,
                  max_iter=3, fixed_trip=True)[0]
        return (fi ** 2).sum()

    g = jax.grad(loss)(fk)
    assert bool(jnp.isfinite(g).all())
    eps = 1e-6
    pert = np.zeros(fk.shape)
    pert[1, 7] = eps
    fd = (loss(fk + pert) - loss(fk - pert)) / (2 * eps)
    assert abs(float(g[1, 7]) - float(fd)) <= 1e-6 * max(abs(float(fd)), 1.0)


def test_grad_fast_precision_close_to_f64(rng):
    """The fast (f32-preconditioned, f64-residual) rung is differentiable
    and its gradients agree with f64 to the refinement tolerance."""
    B, K = 4, 24
    xk, fk = _batch(rng, B, K)
    a = _engine_args(B, K, order=2)

    def loss(f, precision):
        return (_fit(xk, f, a, precision=precision,
                     scaling="jacobi")[0][:, :6] ** 2).sum()

    g64 = jax.grad(lambda f: loss(f, "f64"))(fk)
    gfa = jax.grad(lambda f: loss(f, "fast"))(fk)
    assert bool(jnp.isfinite(gfa).all())
    assert float(jnp.abs(gfa - g64).max()) < 1e-6 * max(
        float(jnp.abs(g64).max()), 1.0)


def test_grad_through_model_evaluation(rng):
    """Gradient of the evaluated surrogate w.r.t. the evaluation point
    equals the model's own interpolated first derivatives (the
    consistency the DOF layout promises)."""
    B, K = 1, 24
    xk = jnp.asarray(rng.uniform(-0.5, 0.5, (B, K, 2)))
    fk = jnp.sin(1.1 * xk[..., 0]) * jnp.cos(0.9 * xk[..., 1])
    a = _engine_args(B, K, order=4)
    fi = _fit(xk, fk, a, precision="f64")[0][0]
    xi0 = jnp.zeros((2,))
    x = jnp.asarray([0.07, -0.04])

    g = jax.grad(lambda x_: interp.eval_fit(
        fi, xi0, x_[None], dimension=2, order=4, diff=defs.i2_F)[0])(x)
    dx = interp.eval_fit(fi, xi0, x[None], dimension=2, order=4,
                         diff=defs.i2_X)[0]
    dy = interp.eval_fit(fi, xi0, x[None], dimension=2, order=4,
                         diff=defs.i2_Y)[0]
    assert abs(float(g[0]) - float(dx)) < 1e-10
    assert abs(float(g[1]) - float(dy)) < 1e-10


def test_grad_through_prepared_solve(rng):
    """Reverse mode through the prepare/solve split (the IBVP inner
    step): d loss / d fk matches finite differences."""
    B, K = 8, 20
    xk = rng.uniform(-1.0, 1.0, (B, K, 2))
    prep = wt.prepare(xk, np.zeros((B, 2)), order=3, precision="f64")
    fk = jnp.asarray(np.sin(xk[..., 0]))

    def loss(f):
        return (wt.solve(prep, f)[0] ** 2).sum()

    g = jax.grad(loss)(fk)
    eps = 1e-6
    pert = np.zeros(fk.shape)
    pert[2, 3] = eps
    fd = (loss(fk + pert) - loss(fk - pert)) / (2 * eps)
    assert abs(float(g[2, 3]) - float(fd)) < 1e-6 * max(abs(float(fd)), 1.0)


def test_adjoint_through_time_stepping(rng):
    """The adjoint use case the reference cannot serve: differentiate a
    multi-step explicit heat stepping loop (prepared WLSQM Laplacian each
    step, lax.scan) with respect to the initial condition."""
    n, K = 64, 12
    pts = rng.uniform(-1.0, 1.0, (n, 2))
    from wlsqm_tpu.utils import neighbors
    idx, _ = neighbors.knn(pts, pts, K + 1, backend="host")
    idx = jnp.asarray(np.asarray(idx)[:, 1:].astype(np.int32))
    xk = jnp.asarray(pts)[idx]
    prep = wt.prepare(np.asarray(xk), pts, order=2, precision="f64")
    lap = jnp.asarray([defs.i2_X2, defs.i2_Y2])
    dt = 1e-3
    u0 = jnp.asarray(np.exp(-4.0 * (pts ** 2).sum(-1)))

    def step(u, _):
        fi = wt.solve(prep, u[idx])[0]
        return u + dt * fi[:, lap].sum(-1), None

    def loss(u):
        uN, _ = jax.lax.scan(step, u, None, length=3)
        return (uN ** 2).sum()

    g = jax.grad(loss)(u0)
    assert bool(jnp.isfinite(g).all())
    eps = 1e-5
    pert = np.zeros(u0.shape)
    pert[17] = eps
    fd = (loss(u0 + pert) - loss(u0 - pert)) / (2 * eps)
    assert abs(float(g[17]) - float(fd)) < 1e-5 * max(abs(float(fd)), 1.0)


def test_grad_composes_with_jit_and_vmap(rng):
    """grad-of-jit and vmap-of-grad both work over the engine fit."""
    B, K = 4, 20
    xk, fk = _batch(rng, B, K)
    a = _engine_args(B, K, order=2)

    loss = lambda f: (_fit(xk, f, a, precision="f64")[0] ** 2).sum()
    g_eager = jax.grad(loss)(fk)
    g_jit = jax.jit(jax.grad(loss))(fk)
    assert float(jnp.abs(g_eager - g_jit).max()) < 1e-12

    # per-case scalar heads, vmapped gradient
    a1 = _engine_args(1, K, order=2)

    def case_loss(xk1, fk1):
        return _fit(xk1[None], fk1[None], a1,
                    precision="f64")[0][0, defs.i2_X]

    gv = jax.vmap(jax.grad(case_loss, argnums=1))(xk, fk)
    assert gv.shape == fk.shape
    assert bool(jnp.isfinite(gv).all())


