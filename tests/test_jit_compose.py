"""fit_many composes with jit / scan / shard_map.

Every call runs the masked engine, so a traced ``fit_many`` needs no
host-side data inspection; a static :class:`wlsqm_tpu.FitPlan` from
``plan_fit_many`` replays the same engine call.
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import wlsqm_tpu as wt


def _problem(rng, B, K=20):
    xi = rng.uniform(-1, 1, (B, 2))
    xk = xi[:, None, :] + rng.uniform(-0.6, 0.6, (B, K, 2))
    fk = np.sin(xk[..., 0]) * np.cos(xk[..., 1])
    return jnp.asarray(xk), jnp.asarray(fk), jnp.asarray(xi)


def test_jit_fit_many_auto_warns_and_matches(rng):
    """jax.jit(fit_many) with the default backend compiles without any
    routing warning (there is no data-dependent routing left to degrade)
    and matches the eager engine result exactly."""
    xk, fk, xi = _problem(rng, 96)
    ref = wt.fit_many(xk, fk, xi, order=2)
    jfn = jax.jit(lambda a, b, c: wt.fit_many(a, b, c, order=2).fi)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = jfn(xk, fk, xi)
    assert not any("plan_fit_many" in str(w.message) for w in caught)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref.fi))


def test_plan_replay_matches_eager_auto(rng):
    xk, fk, xi = _problem(rng, 96)
    plan = wt.plan_fit_many(xk, xi, order=2)
    eager = wt.fit_many(xk, fk, xi, order=2)
    planned = wt.fit_many(xk, fk, xi, order=2, plan=plan)
    np.testing.assert_allclose(np.asarray(planned.fi),
                               np.asarray(eager.fi), rtol=0, atol=1e-9)


def test_plan_under_jit_and_scan(rng):
    """A planned fit compiles under jit and lax.scan and matches eager."""
    xk, fk, xi = _problem(rng, 64)
    plan = wt.plan_fit_many(xk, xi, order=2)
    eager = wt.fit_many(xk, fk, xi, order=2, plan=plan)

    jfn = jax.jit(
        lambda a, b, c: wt.fit_many(a, b, c, order=2, plan=plan).fi)
    np.testing.assert_array_equal(np.asarray(jfn(xk, fk, xi)),
                                  np.asarray(eager.fi))

    def step(carry, fk_t):
        res = wt.fit_many(xk, fk_t, xi, order=2, plan=plan)
        return carry, res.fi

    fks = jnp.stack([fk, fk * 2.0, fk - 1.0])
    _, fis = jax.lax.scan(step, 0, fks)
    np.testing.assert_array_equal(np.asarray(fis[0]), np.asarray(eager.fi))
    ref1 = wt.fit_many(xk, fk * 2.0, xi, order=2, plan=plan)
    np.testing.assert_array_equal(np.asarray(fis[1]), np.asarray(ref1.fi))


@pytest.mark.skipif(len(jax.devices()) < 2,
                    reason="needs a multi-device (virtual) platform")
def test_plan_under_shard_map(rng):
    """A planned fit_many shards over the case axis with shard_map and
    matches single-device execution bit-for-bit."""
    from jax.sharding import PartitionSpec as P

    from wlsqm_tpu.parallel import sharding

    mesh = sharding.make_mesh()
    ndev = mesh.devices.size
    B = 16 * ndev
    xk, fk, xi = _problem(rng, B)
    plan = wt.plan_fit_many(xk, xi, order=2)

    def local_fit(xk_s, fk_s, xi_s):
        return wt.fit_many(xk_s, fk_s, xi_s, order=2, plan=plan).fi

    sharded = jax.shard_map(
        local_fit, mesh=mesh,
        in_specs=(P("cases"), P("cases"), P("cases")),
        out_specs=P("cases"))
    fi_sh = sharded(xk, fk, xi)
    fi_1 = wt.fit_many(xk, fk, xi, order=2, plan=plan).fi
    np.testing.assert_array_equal(np.asarray(fi_sh), np.asarray(fi_1))
