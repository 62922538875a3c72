"""Composing fit_many with jit / scan / shard_map via a FitPlan.

A :class:`wlsqm_tpu.FitPlan` names one static configuration's engine
precision (native float64 unless an emulation mode is pinned):

1. compute it once: ``plan = wt.plan_fit_many(xk, xi, order=...)``;
2. pass it back: ``wt.fit_many(..., plan=plan)`` — the call traces with
   no host-side inspection, so it nests inside ``jax.jit``, ``lax.scan``
   (e.g. an IBVP time loop) and ``shard_map`` (multi-device data
   parallelism over the case axis).

Run (any backend; uses an 8-device virtual CPU mesh when available):

    JAX_NUM_CPU_DEVICES=8 python examples/jit_plan_sharding.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import wlsqm_tpu as wt


def main():
    rng = np.random.default_rng(0)
    B, K = 1024, 25
    xi = rng.uniform(-1, 1, (B, 2))
    xk = xi[:, None, :] + rng.uniform(-0.4, 0.4, (B, K, 2))
    fk = np.sin(xk[..., 0]) * np.cos(xk[..., 1])

    # 1. plan once for this configuration
    plan = wt.plan_fit_many(xk, xi, order=2)
    print("plan:", plan)

    # 2a. jit
    fit = jax.jit(lambda a, b, c: wt.fit_many(a, b, c, order=2,
                                              plan=plan).fi)
    fi = fit(jnp.asarray(xk), jnp.asarray(fk), jnp.asarray(xi))
    print("jit fit:", fi.shape, "finite:", bool(jnp.isfinite(fi).all()))

    # 2b. scan (a toy 3-step relaxation re-fitting each step)
    def step(u, _):
        res = wt.fit_many(jnp.asarray(xk), u, jnp.asarray(xi), order=2,
                          plan=plan)
        model = res.fi[:, 0]                      # fitted value at xi
        return u * 0.9 + 0.1 * model[:, None], None

    u, _ = jax.lax.scan(step, jnp.asarray(fk), None, length=3)
    print("scan ok:", bool(jnp.isfinite(u).all()))

    # 2c. shard_map over the case axis (pure data parallelism — the fit
    # path needs zero collectives; SURVEY §5)
    if len(jax.devices()) > 1:
        from wlsqm_tpu.parallel import sharding

        mesh = sharding.make_mesh()
        sharded = jax.shard_map(
            lambda a, b, c: wt.fit_many(a, b, c, order=2, plan=plan).fi,
            mesh=mesh, in_specs=(P("cases"), P("cases"), P("cases")),
            out_specs=P("cases"))
        fi_sh = sharded(jnp.asarray(xk), jnp.asarray(fk), jnp.asarray(xi))
        print("shard_map over %d devices: max|diff| vs single = %.1e"
              % (mesh.devices.size,
                 float(jnp.abs(fi_sh - fi).max())))
    else:
        print("single device: shard_map demo skipped "
              "(set JAX_NUM_CPU_DEVICES=8)")


if __name__ == "__main__":
    main()
