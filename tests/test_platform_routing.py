"""Every public entry point runs the f64 engine on the default device.

With ``jax.default_backend`` reporting a GPU, no entry point may take a
platform-dependent detour: each lands on :func:`engine.fit_batch` (or the
prepared engine) at ``precision="f64"`` on ``jax.devices()[0]``, and none
moves work to another device with ``jax.default_device``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import wlsqm_tpu as wt
from wlsqm_tpu import api
from wlsqm_tpu.fitter import defs, engine
from wlsqm_tpu.parallel import sharding


@pytest.fixture
def on_gpu(monkeypatch):
    """Fake a GPU default backend; record every engine call's precision."""
    calls = []
    orig = engine.fit_batch

    def spy(*args, **kw):
        calls.append(kw.get("precision", engine.PRECISION_F64))
        return orig(*args, **kw)

    def no_detour(*args, **kw):
        raise AssertionError("fit path switched devices")

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax, "default_device", no_detour)
    monkeypatch.setattr(engine, "fit_batch", spy)
    return calls


def _problem(rng, B=64, K=14):
    xi = rng.uniform(-1, 1, (B, 2))
    xk = xi[:, None, :] + rng.uniform(-0.4, 0.4, (B, K, 2))
    fk = np.sin(xk[..., 0]) * np.cos(xk[..., 1])
    return xk, fk, xi


def _on_default_device(a):
    assert a.devices() == {jax.devices()[0]}


def _assert_f64_engine(calls, n=1):
    assert len(calls) >= n and set(calls) == {"f64"}, calls


def test_eager_fit_many(rng, on_gpu):
    xk, fk, xi = _problem(rng)
    res = wt.fit_many(xk, fk, xi, order=2)
    _assert_f64_engine(on_gpu)
    _on_default_device(res.fi)


def test_planned_fit_many_under_jit(rng, on_gpu):
    xk, fk, xi = _problem(rng)
    plan = wt.plan_fit_many(xk, xi, order=2, weighting=wt.WEIGHT_CENTER)
    assert plan == api.FitPlan(precision="f64")
    fi = jax.jit(lambda a, b, c: wt.fit_many(
        a, b, c, order=2, weighting=wt.WEIGHT_CENTER, plan=plan).fi)(
            xk, fk, xi)
    _assert_f64_engine(on_gpu)
    _on_default_device(fi)


def test_fit_stream(rng, on_gpu):
    xk, fk, xi = _problem(rng, B=100)
    res = wt.fit_stream(xk, fk, xi, order=2, chunk=32)
    _assert_f64_engine(on_gpu, n=4)
    assert np.isfinite(res.fi).all()


def test_fit_stream_mesh(rng, on_gpu):
    xk, fk, xi = _problem(rng, B=100)
    mesh = sharding.make_mesh(4)
    res = wt.fit_stream(xk, fk, xi, order=2, chunk=32, mesh=mesh)
    _assert_f64_engine(on_gpu)
    want = np.asarray(wt.fit_many(xk, fk, xi, order=2).fi)
    np.testing.assert_array_equal(res.fi, want)


def test_compat_fit_2d_single_case(rng, on_gpu):
    xk, fk, xi = _problem(rng, B=1)
    fi = np.zeros(6)
    wt.fit_2D(xk=xk[0], fk=fk[0], xi=xi[0], fi=fi, order=2, knowns=0)
    _assert_f64_engine(on_gpu)
    assert np.isfinite(fi).all()


def test_compat_fit_2d_many(rng, on_gpu):
    B, K = 1024, 14
    xk, fk, xi = _problem(rng, B=B, K=K)
    fi = np.zeros((B, 6))
    wt.fit_2D_many(xk, fk, np.full(B, K, np.int32), xi, fi, None, False,
                   np.full(B, 2, np.int32), np.zeros(B, np.int64),
                   np.full(B, wt.WEIGHT_CENTER, np.int32))
    _assert_f64_engine(on_gpu)
    want = np.asarray(wt.fit_many(xk, fk, xi, order=2,
                                  weighting=wt.WEIGHT_CENTER).fi)
    np.testing.assert_allclose(fi, want, rtol=0, atol=1e-12)


def test_expert_solver(rng, on_gpu):
    B, K = 1024, 14
    xk, fk, xi = _problem(rng, B=B, K=K)
    es = wt.ExpertSolver(
        dimension=2, nk=np.full(B, K, np.int32),
        order=np.full(B, 2, np.int32), knowns=np.zeros(B, np.int64),
        weighting_method=np.full(B, wt.WEIGHT_CENTER, np.int32))
    es.prepare(xi=xi, xk=xk)
    assert es.prepared.precision == "f64"
    _on_default_device(es.prepared.c)
    fi = np.zeros((B, 6))
    es.solve(fk=fk, fi=fi)
    want = np.asarray(wt.fit_many(xk, fk, xi, order=2,
                                  weighting=wt.WEIGHT_CENTER).fi)
    np.testing.assert_allclose(fi, want, rtol=0, atol=1e-12)


def test_prepare_solve(rng, on_gpu):
    xk, fk, xi = _problem(rng)
    prep = wt.prepare(xk, xi, order=2)
    assert prep.precision == "f64"
    fi, _ = wt.solve(prep, fk)
    _on_default_device(fi)


def test_sharded_fit_many(rng, on_gpu):
    B, K = 64, 14
    xk, fk, xi = _problem(rng, B=B, K=K)
    mesh = sharding.make_mesh(4)
    fi, _, _, _ = sharding.sharded_fit_many(
        mesh, xk, fk, np.full(B, K, np.int32), xi, np.zeros((B, 6)),
        np.full(B, 2, np.int32), np.zeros(B, np.int64),
        np.full(B, defs.WEIGHT_UNIFORM, np.int32), dimension=2, NO=6)
    _assert_f64_engine(on_gpu)
    assert {s.device for s in fi.addressable_shards} == set(
        mesh.devices.flat)


@pytest.mark.parametrize("precision", ["mixed", "fast"])
def test_explicit_emulation_precision_is_honoured(rng, on_gpu, precision):
    """The emulation modes stay reachable, but only when asked for."""
    xk, fk, xi = _problem(rng)
    wt.fit_many(xk, fk, xi, order=2, precision=precision)
    assert on_gpu == [precision]
    plan = wt.plan_fit_many(xk, xi, order=2, precision=precision)
    wt.fit_many(xk, fk, xi, order=2, plan=plan)
    assert on_gpu == [precision, precision]


def test_removed_options_rejected(rng):
    xk, fk, xi = _problem(rng)
    with pytest.raises(ValueError, match="backend must be"):
        wt.fit_many(xk, fk, xi, backend="pallas")
    with pytest.raises(TypeError):
        wt.fit_many(xk, fk, xi, refine_steps=2)
    with pytest.raises(ValueError, match="precision must be"):
        wt.plan_fit_many(xk, xi, precision="ts")
    with pytest.raises(ValueError, match="scalar order"):
        wt.plan_fit_many(xk, xi, order=np.full(len(xk), 2))


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_backend_argument_deprecated(rng, backend):
    """backend= still validates and is otherwise ignored, with a warning."""
    xk, fk, xi = _problem(rng)
    want = np.asarray(wt.fit_many(xk, fk, xi).fi)
    with pytest.warns(DeprecationWarning, match="backend"):
        got = np.asarray(wt.fit_many(xk, fk, xi, backend=backend).fi)
    np.testing.assert_array_equal(got, want)


def test_knn_backend_names(rng):
    from wlsqm_tpu.utils import neighbors

    pts = rng.uniform(-1, 1, (50, 2))
    idx_d, _ = neighbors.knn(pts, pts[:5], 4, backend="device")
    idx_h, _ = neighbors.knn(pts, pts[:5], 4, backend="host")
    for a, b in zip(np.asarray(idx_d), np.asarray(idx_h)):
        assert set(a.tolist()) == set(b.tolist())
    with pytest.raises(ValueError, match="backend must be"):
        neighbors.knn(pts, pts[:5], 4, backend="gpu")


def test_device_knn_ranking_ignores_global_matmul_precision(rng):
    """The f32 distance product pins HIGHEST precision itself."""
    from wlsqm_tpu.utils import neighbors

    pts = jnp.asarray(rng.uniform(-1, 1, (300, 2)))
    want = np.asarray(neighbors._knn_device(pts, pts[:40], 8)[0])
    with jax.default_matmul_precision("bfloat16"):
        got = np.asarray(neighbors._knn_device.__wrapped__(
            pts, pts[:40], 8)[0])
    np.testing.assert_array_equal(got, want)
