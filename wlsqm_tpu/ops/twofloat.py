"""Double-single ("two-float") arithmetic on f32 pairs.

The explicit ``precision="ds"`` mode emulates float64 for devices whose
float64 rate is low.  For the places where the WLSQM pipeline genuinely
needs ~1e-14 effective precision — the basis rows, weights, RHS
contraction, and the residual matvecs of the refinement loop — this module
provides error-free-transformation arithmetic on (hi, lo) float32 pairs,
giving ≈ 48 significant bits at a handful of native f32 flops per
operation.

Robustness note: classic Dekker splitting relies on exact rounding of
separate mul/add ops and silently breaks if the compiler contracts them into
FMAs.  The splits here therefore use mantissa *bit masking* via bitcast,
which no contraction can alter; the remaining building block, two_sum, uses
only additions.  XLA *CPU* can fuse-and-duplicate the chains in large
graphs, degrading pairs to plain f32 — which is why every platform's default
is the native-f64 path and an explicit ds request is guarded by a runtime
canary (:func:`wlsqm_tpu.fitter.engine_ds.ds_backend_ok`).
(``lax.optimization_barrier`` does not help: XLA strips it during
compilation.)

Values are represented as a (hi, lo) tuple of equally-shaped f32 arrays with
``value = hi + lo`` and ``|lo| <= ulp(hi)/2``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "from_f64", "to_f64", "from_f32",
    "two_sum", "quick_two_sum", "two_prod",
    "add", "sub", "mul", "mul_f32", "add_f32", "neg", "div", "sqrt",
    "acc", "mul_add", "renorm",
    "sum_along", "dot",
]

# keep top 11 explicit mantissa bits; a plain int so traced code using
# these ops does not capture an array constant
_HI_MASK = 0xFFFFF000


def from_f64(x):
    """Split a float64 array into an (hi, lo) f32 pair (~49-bit fidelity)."""
    hi = x.astype(jnp.float32)
    lo = (x - hi.astype(x.dtype)).astype(jnp.float32)
    return hi, lo


def from_f32(x):
    """Lift an f32 array into the pair representation (exact)."""
    return x, jnp.zeros_like(x)


def to_f64(d):
    hi, lo = d
    return hi.astype(jnp.float64) + lo.astype(jnp.float64)


def _split_mask(a):
    """Exact split a = h + l with h carrying <= 12 mantissa bits.

    Bit masking keeps the split exact regardless of FMA contraction.
    """
    h = lax.bitcast_convert_type(
        lax.bitcast_convert_type(a, jnp.uint32) & _HI_MASK, jnp.float32
    )
    return h, a - h


def two_sum(a, b):
    """Exact addition: s + e == a + b with s = fl(a+b). 6 flops, adds only."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """two_sum for |a| >= |b| (3 flops)."""
    s = a + b
    e = b - (s - a)
    return s, e


def two_prod(a, b):
    """Exact product: p + e == a*b with p = fl(a*b), via masked splits."""
    p = a * b
    ah, al = _split_mask(a)
    bh, bl = _split_mask(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def add(x, y):
    """Pair + pair."""
    s, e = two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return quick_two_sum(s, e)


def acc(a, x):
    """Relaxed accumulate ``a + x`` WITHOUT renormalization (8 flops).

    The hi channel stays exact (two_sum); rounding errors and the lo
    words pile up un-renormalized in the lo channel, so after n
    accumulations |lo| can reach ~n·ulp(hi) — call :func:`renorm` once
    at the end.  Saves the quick_two_sum of :func:`add` in reduction
    loops (the fused kernel's moment accumulation).
    """
    s, e = two_sum(a[0], x[0])
    return s, a[1] + (e + x[1])


def mul_add(a, x, y):
    """Relaxed fused ``a + x*y`` (~25 flops): exact hi-channel product
    and sum, single-rounded lo channel, no renormalization (see
    :func:`acc` for the growth caveat)."""
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    s, e2 = two_sum(a[0], p)
    return s, a[1] + (e + e2)


def renorm(x):
    """Restore the |lo| <= ulp(hi)/2 invariant after relaxed ops."""
    return quick_two_sum(x[0], x[1])


def split_hi(a):
    """Precompute the masked split of a plane for :func:`mul_presplit`."""
    return _split_mask(a)


def mul_presplit(x, y, ysplit):
    """Pair * pair with ``y[0]``'s split precomputed (saves 3 flops per
    product when the same multiplicand feeds many products — the fused
    kernel's moment chains reuse each axis offset ~20x per neighbor)."""
    yh, yl = ysplit
    p = x[0] * y[0]
    xh, xl = _split_mask(x[0])
    e = ((xh * yh - p) + xh * yl + xl * yh) + xl * yl
    e = e + (x[0] * y[1] + x[1] * y[0])
    return quick_two_sum(p, e)


def neg(x):
    return -x[0], -x[1]


def sub(x, y):
    return add(x, neg(y))


def add_f32(x, a):
    """Pair + plain f32."""
    s, e = two_sum(x[0], a)
    e = e + x[1]
    return quick_two_sum(s, e)


def mul(x, y):
    """Pair * pair."""
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return quick_two_sum(p, e)


def mul_f32(x, a):
    """Pair * plain f32."""
    p, e = two_prod(x[0], a)
    e = e + x[1] * a
    return quick_two_sum(p, e)


def div(x, y):
    """Pair / pair via one Newton correction (~eps32^2 relative error)."""
    q0 = x[0] / y[0]
    e = sub(x, mul(y, from_f32(q0)))
    q1 = e[0] / y[0]
    return quick_two_sum(q0, q1)


def sqrt(x):
    """Pair sqrt via one Newton correction on the f32 estimate."""
    s = jnp.sqrt(x[0])
    safe = jnp.where(s > 0, s, 1.0)
    e = sub(x, mul(from_f32(s), from_f32(s)))
    corr = jnp.where(s > 0, e[0] * (0.5 / safe), 0.0)
    return quick_two_sum(s, corr)


def sum_along(x, axis):
    """Sum a pair array along an axis with a pairwise (tree) ds-reduction.

    The axis is zero-padded to the next power of two first (adding a zero
    pair is exact), so every halving step is a clean slice — no
    concatenates, which keeps the traced graph small and fusion-friendly.
    """
    hi, lo = x
    n = hi.shape[axis]
    hi = jnp.moveaxis(hi, axis, 0)
    lo = jnp.moveaxis(lo, axis, 0)
    m = 1
    while m < n:
        m *= 2
    if m != n:
        pad = [(0, m - n)] + [(0, 0)] * (hi.ndim - 1)
        hi = jnp.pad(hi, pad)
        lo = jnp.pad(lo, pad)
    while m > 1:
        half = m // 2
        hi, lo = add((hi[:half], lo[:half]), (hi[half:], lo[half:]))
        m = half
    return hi[0], lo[0]


def dot(x, y, axis):
    """ds dot product along ``axis`` of two pair arrays."""
    return sum_along(mul(x, y), axis)
