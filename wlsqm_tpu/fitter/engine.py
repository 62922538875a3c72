"""The batched WLSQM fitting engine.

This module replaces the reference's per-case pointer machinery and scalar
loops (reference: wlsqm/fitter/infra.pyx Allocator/CaseManager/Case,
wlsqm/fitter/impl.pyx make_c/make_A/preprocess_A/solve/solve_iterative) with a
fully batched, statically-shaped, functional formulation:

* every case is padded to ``NO`` DOFs and ``K`` neighbors; ragged neighbor
  counts become a weight mask (w = 0 for k >= nk, reproducing the reference's
  "unused elements are not read" contract, reference: wlsqm/fitter/simple.pyx:334);
* per-case polynomial order becomes a DOF *activity* mask (valid because the
  DOF numbering is grouped by derivative order);
* the knowns bitmask becomes a boolean mask, and instead of remapping to an
  (nr, nr) reduced system (reference: wlsqm/fitter/infra.pyx:145-200), known
  rows/columns of A are zeroed with a unit diagonal and the known contribution
  moves to the RHS — algebraically identical to the reference's elimination
  (reference: wlsqm/fitter/impl.pyx:789-818) with static shapes;
* preconditioning is batched Ruiz-2001 equilibration
  (:mod:`wlsqm_tpu.ops.ruiz`), and the factorization is batched Cholesky of
  the scaled SPD normal matrix (:mod:`wlsqm_tpu.ops.solve`); the reference's
  OpenMP ``prange`` over cases becomes the batch axis of one compiled XLA
  program, and multi-chip scaling is plain data-parallel sharding of that
  axis (see :mod:`wlsqm_tpu.parallel`).

Everything here is pure and jit/vmap/shard_map-compatible.  The ``Prepared``
pytree is the batched analogue of the reference ExpertSolver's prepared state
(factorizations resident in device memory, reference: wlsqm/fitter/expert.pyx:66-89):
it can be solved against many times, serialized, donated, or shared between
fields ("guest mode" = reusing the same Prepared object).

Shapes (B = number of cases, K = padded neighbor count, NO = padded DOFs):
  xk (B, K, dim) | fk (B, K) | nk (B,) | xi (B, dim)
  order (B,) | knowns (B,) int64 | weighting (B,) | fi (B, NO)
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from wlsqm_tpu.fitter import defs, tables
from wlsqm_tpu.ops import ruiz as ruiz_ops
from wlsqm_tpu.ops import solve as solve_ops

# weight function constants (reference: wlsqm/fitter/infra.pyx:45-46)
WEIGHT_ALPHA = 1e-4
WEIGHT_BETA = 1.0 - WEIGHT_ALPHA

# Mixed-precision mode: number of f64-residual refinement sweeps applied on
# top of the f32 factorization.  After Ruiz equilibration the scaled normal
# matrix is well conditioned (cond ~ 1e2..1e5 even for order-4 fits), so each
# sweep contracts the error by ~cond * eps_f32; three sweeps reach f64-class
# accuracy while keeping the O(n^3) factorization and O(n^2) substitutions in
# fast native f32.
MIXED_REFINE_STEPS = 3

# Fast mode: EVERYTHING O(n^2)/O(n^3) per case runs in native f32 (assembly
# einsum, Ruiz, Cholesky, substitutions); f64 appears only in the
# O(K·NO) pieces: the basis rows, the RHS contraction, and the residual
# matvecs of the refinement loop, which iterates the f32 solver to the TRUE
# f64 normal-equations fixed point.  The refinement contraction factor is
# ~cond(scaled A) * eps_f32, so more steps are needed than in mixed mode.
FAST_REFINE_STEPS = 6

PRECISION_F64 = "f64"      # factor/solve in the input dtype (reference-exact path)
PRECISION_MIXED = "mixed"  # f64 assembly, f32 factor/solve + f64 refinement
PRECISION_FAST = "fast"    # f32 assembly+factor/solve, f64 refinement through C
PRECISION_DS = "ds"        # double-single f32 pairs everywhere; no bulk f64


# -----------------------------------------------------------------------------
# Basis construction
# -----------------------------------------------------------------------------

def basis(delta: jax.Array, dimension: int, NO: int) -> jax.Array:
    """Baked monomial basis rows for offsets ``delta``.

    delta: (..., dim) offsets (x - xi).  Returns (..., NO) with
    ``c[..., j] = prod_a delta[..., a] ** EXP[j, a] / prod_a EXP[j, a]!``.

    The powers are built by the same multiplication sequence as the reference
    (d2 = d*d, d3 = d2*d, d4 = d2*d2; reference: wlsqm/fitter/impl.pyx:107-117)
    so roundoff matches to the last ulp.
    """
    dtype = delta.dtype
    exp = tables.EXPONENTS[dimension][:NO]          # (NO, dim) static
    invfact = tables.INV_FACT[dimension][:NO]       # (NO,) static
    max_pow = int(exp.max()) if NO > 1 else 0

    cols = []
    for a in range(dimension):
        d = delta[..., a]
        powers = [jnp.ones_like(d), d]
        if max_pow >= 2:
            d2 = d * d
            powers.append(d2)
            if max_pow >= 3:
                powers.append(d2 * d)
                if max_pow >= 4:
                    powers.append(d2 * d2)
        p = jnp.stack(powers, axis=-1)              # (..., max_pow+1)
        cols.append(p[..., exp[:, a]])              # (..., NO)
    c = cols[0]
    for col in cols[1:]:
        c = c * col
    return c * jnp.asarray(invfact, dtype)


def dof_masks(order: jax.Array, knowns: jax.Array, dimension: int, NO: int):
    """(active, known, unknown) boolean masks of shape (..., NO)."""
    counts = np.asarray(defs._DOF_COUNTS[dimension], dtype=np.int32)  # (5,)
    no = jnp.asarray(counts)[jnp.clip(order, 0, defs.MAX_ORDER)]      # (...,)
    j = jnp.arange(NO, dtype=jnp.int32)
    active = j[None, :] < no[..., None] if order.ndim else j < no
    bits = (knowns[..., None].astype(jnp.int64) >> j.astype(jnp.int64)) & 1
    known = jnp.logical_and(bits.astype(bool), active)
    unknown = jnp.logical_and(active, jnp.logical_not(known))
    return active, known, unknown


def radius_pow2_scale(d2: jax.Array, kmask: jax.Array):
    """Per-case power-of-two neighborhood radius scale.

    Returns (inv_s, e) with s = 2**e >= max|delta| (approximately) and
    inv_s = 2**-e exactly representable.  Scaling the offsets by inv_s before
    building the monomial basis keeps all basis columns O(1), which is what
    makes f32 assembly of order-4 systems viable on small neighborhoods —
    the raw basis spans h^0..h^4 and its Gram matrix h^0..h^8, far beyond
    f32's dynamic usefulness.  Being an exact power of two, the scaling is
    exactly invertible: the solved DOFs transform by s**degree.
    """
    d2m = jnp.where(kmask, d2, 0.0)
    h2 = d2m.max(axis=-1)
    e = jnp.ceil(0.5 * jnp.log2(jnp.where(h2 > 0, h2, 1.0)))
    return jnp.exp2(-e), e


def neighbor_weights(d2: jax.Array, kmask: jax.Array, weighting: jax.Array) -> jax.Array:
    """Fitting weights from squared distances.

    WEIGHT_UNIFORM: w = 1.  WEIGHT_CENTER: w = alpha + beta*(1 - sqrt(d2/max_d2))^2
    normalized by the neighborhood's max squared distance
    (reference: wlsqm/fitter/infra.pyx:668-702 ``Case_make_weights``).
    Padded neighbors (kmask False) get w = 0.
    """
    dtype = d2.dtype
    d2m = jnp.where(kmask, d2, 0.0)
    max_d2 = d2m.max(axis=-1, keepdims=True)
    safe = jnp.where(max_d2 > 0, max_d2, 1.0)
    tmp = 1.0 - jnp.sqrt(d2m / safe)
    center = WEIGHT_ALPHA + WEIGHT_BETA * tmp * tmp
    w = jnp.where(
        (weighting[..., None] == defs.WEIGHT_CENTER), center, jnp.ones_like(center)
    )
    return jnp.where(kmask, w, jnp.zeros((), dtype))


# -----------------------------------------------------------------------------
# Prepared state (the ExpertSolver "prepare" product, as a pytree)
# -----------------------------------------------------------------------------

@partial(
    jax.tree_util.register_dataclass,
    data_fields=(
        "c",
        "c_lo",
        "w",
        "w_lo",
        "fac",
        "A_scaled",
        "dof_scale",
        "row_scale",
        "col_scale",
        "active",
        "known",
        "unknown",
        "xi",
        "cond_orig",
        "cond_scaled",
        "ruiz_iters",
    ),
    meta_fields=("dimension", "solver", "precision"),
)
@dataclasses.dataclass(frozen=True)
class Prepared:
    """Cached geometry: basis rows, weights, scaled+factored normal matrices.

    The batched analogue of the reference's prepared Case arrays (c, w, LU(A),
    row/col scalings; reference: wlsqm/fitter/infra.pxd:124-183).  Immutable;
    solving against it is a pure function of (Prepared, fk, fi).
    """

    c: jax.Array            # (B, K, NO) baked basis rows (ds mode: hi part)
    c_lo: jax.Array | None  # ds mode: lo part of the basis rows
    w: jax.Array            # (B, K) weights; 0 for padded neighbors (ds: hi)
    w_lo: jax.Array | None  # ds mode: lo part of the weights
    fac: tuple              # factorization of the scaled masked normal matrix
    A_scaled: jax.Array | None  # scaled matrix kept for mixed-precision refinement
    dof_scale: jax.Array | None  # (B, NO) f64 DOF de-scaling s**-deg (fast/ds modes)
    row_scale: jax.Array    # (B, NO)
    col_scale: jax.Array    # (B, NO)
    active: jax.Array       # (B, NO) bool
    known: jax.Array        # (B, NO) bool
    unknown: jax.Array      # (B, NO) bool
    xi: jax.Array           # (B, dim) fit origins
    cond_orig: jax.Array    # (B,) 2-norm condition numbers (NaN unless debug)
    cond_scaled: jax.Array  # (B,)
    ruiz_iters: jax.Array   # (B,) equilibration sweeps taken
    dimension: int
    solver: str
    precision: str

    @property
    def ncases(self) -> int:
        return self.c.shape[0]

    @property
    def nk_max(self) -> int:
        return self.c.shape[1]

    @property
    def no_max(self) -> int:
        return self.c.shape[2]


def prepare(
    xk: jax.Array,
    nk: jax.Array,
    xi: jax.Array,
    order: jax.Array,
    knowns: jax.Array,
    weighting: jax.Array,
    *,
    dimension: int,
    NO: int,
    solver: str = solve_ops.SOLVER_CHOLESKY,
    debug: bool = False,
    ruiz_max_iter: int = ruiz_ops.RUIZ_MAX_ITER,
    ruiz_eps: float = ruiz_ops.RUIZ_EPS,
    precision: str = PRECISION_F64,
    scaling: str = "ruiz",
) -> Prepared:
    """Build + precondition + factor the normal matrices for a batch of cases.

    Fuses the reference's make_c → make_A → preprocess_A pipeline
    (reference: wlsqm/fitter/impl.pyx:47-689) into one batched program.

    ``ruiz_max_iter`` / ``ruiz_eps``: equilibration loop controls.  The
    reference iterates to 1e-15 (≤ 100 sweeps); the 1e-15 test may never
    trigger on some geometries, and because any diagonal scaling is exact
    algebra, truncating the loop changes only the conditioning quality, not
    the semantics — ~10 sweeps is fully converged in practice.

    ``precision``: PRECISION_F64 runs factor/solve in the input dtype
    (reference-exact); PRECISION_MIXED factors in f32 and recovers f64-class
    accuracy via f64-residual refinement at solve time (an explicit
    emulation mode for devices whose float64 rate is low).
    """
    dtype = xk.dtype
    B, K, _ = xk.shape

    if precision == PRECISION_DS:
        from wlsqm_tpu.fitter import engine_ds

        parts = engine_ds.prepare_ds(
            xk, nk, xi, order, knowns, weighting,
            dimension=dimension, NO=NO, solver=solver, debug=debug,
            ruiz_max_iter=ruiz_max_iter, scaling=scaling,
            dof_masks_fn=dof_masks,
        )
        return Prepared(
            A_scaled=None, xi=xi, dimension=dimension, solver=solver,
            precision=precision, **parts,
        )

    kmask = jnp.arange(K, dtype=nk.dtype)[None, :] < nk[:, None]
    delta = xk - xi[:, None, :]                       # (B, K, dim)
    # Padded neighbor slots may hold arbitrary (even non-finite) values; the
    # reference never reads them (reference: wlsqm/fitter/simple.pyx:334).
    # Zero them so 0-weight times non-finite cannot poison the contraction.
    delta = jnp.where(kmask[:, :, None], delta, 0.0)
    d2 = jnp.sum(delta * delta, axis=-1)              # (B, K)

    if precision == PRECISION_FAST:
        # exact power-of-two radius normalization: keeps every basis column
        # O(1) so the f32 assembly/factorization below stays well scaled
        inv_s, e_s = radius_pow2_scale(d2, kmask)
        delta = delta * inv_s[:, None, None]
        d2 = d2 * (inv_s * inv_s)[:, None]
        deg = jnp.asarray(tables.DEGREE[dimension][:NO], dtype)
        dof_scale = jnp.exp2(-e_s[:, None] * deg[None, :])
    else:
        dof_scale = None

    c = basis(delta, dimension, NO)                   # (B, K, NO)
    w = neighbor_weights(d2, kmask, weighting)

    active, known, unknown = dof_masks(order, knowns, dimension, NO)

    # A[j,m] = sum_k w_k c[k,j] c[k,m] over unknown DOFs; identity elsewhere
    # (reference: wlsqm/fitter/impl.pyx:566-602 make_A). The contraction runs
    # as a batched matmul.  In FAST mode the whole O(n^2)/O(n^3)
    # chain (assembly, Ruiz, factorization) runs in native f32; f64 accuracy
    # is recovered at solve time by refinement through the f64 basis rows.
    asm_dtype = jnp.float32 if precision == PRECISION_FAST else dtype
    c_a = c.astype(asm_dtype)
    w_a = w.astype(asm_dtype)
    cw = c_a * w_a[..., None]
    # HIGHEST matmul precision: a GPU may otherwise run f32 contractions in
    # TF32 (10 mantissa bits), which destroys the preconditioner quality
    A_full = jnp.einsum("bkj,bkm->bjm", cw, c_a,
                        preferred_element_type=asm_dtype,
                        precision=jax.lax.Precision.HIGHEST)
    unk2 = jnp.logical_and(unknown[:, :, None], unknown[:, None, :])
    eye = jnp.eye(NO, dtype=asm_dtype)
    A = jnp.where(unk2, A_full, 0.0) + jnp.where(unknown, 0.0, 1.0)[:, :, None] * eye

    if precision == PRECISION_FAST:
        # an f32 iteration can never satisfy the f64-grade 1e-15 test
        ruiz_eps = max(ruiz_eps, 1e-6)
    if scaling == "jacobi":
        row_scale, col_scale, ruiz_iters = ruiz_ops.jacobi_scale(A)
    else:
        row_scale, col_scale, ruiz_iters = ruiz_ops.ruiz_scale(
            A, max_iter=ruiz_max_iter, eps=ruiz_eps
        )
    A_scaled = ruiz_ops.apply_scaling(A, row_scale, col_scale)

    if debug:
        cond_orig = solve_ops.cond_2norm(A.astype(dtype))
        cond_scaled = solve_ops.cond_2norm(A_scaled.astype(dtype))
    else:
        cond_orig = jnp.full((B,), jnp.nan, dtype)
        cond_scaled = jnp.full((B,), jnp.nan, dtype)

    if precision == PRECISION_MIXED:
        fac = solve_ops.factor(A_scaled.astype(jnp.float32), solver)
        A_keep = A_scaled
    elif precision == PRECISION_FAST:
        fac = solve_ops.factor(A_scaled, solver)  # already f32
        A_keep = None
    else:
        fac = solve_ops.factor(A_scaled, solver)
        A_keep = None
    row_scale = row_scale.astype(dtype)
    col_scale = col_scale.astype(dtype)

    return Prepared(
        c=c,
        c_lo=None,
        w=w,
        w_lo=None,
        fac=fac,
        A_scaled=A_keep,
        dof_scale=dof_scale,
        row_scale=row_scale,
        col_scale=col_scale,
        active=active,
        known=known,
        unknown=unknown,
        xi=xi,
        cond_orig=cond_orig,
        cond_scaled=cond_scaled,
        ruiz_iters=ruiz_iters,
        dimension=dimension,
        solver=solver,
        precision=precision,
    )


# -----------------------------------------------------------------------------
# Solving
# -----------------------------------------------------------------------------

def _rhs(prep: Prepared, resid: jax.Array) -> jax.Array:
    """Row-scaled, masked RHS b_j = rs_j * sum_k w_k resid_k c[k,j]."""
    cw = prep.c * prep.w[..., None]
    b = jnp.einsum("bkj,bk->bj", cw, resid, preferred_element_type=resid.dtype)
    return jnp.where(prep.unknown, b * prep.row_scale, 0.0)


def _matvec_scaled(prep: Prepared, x: jax.Array) -> jax.Array:
    """A_scaled @ x computed in f64 through the basis rows (no stored A).

    A_scaled = diag(rs)·(CᵀWC masked to unknowns)·diag(cs) + I on the rest;
    two O(K·NO) einsums per RHS instead of an O(NO²) matmul, and in f64 even
    when the stored factorization is f32 (PRECISION_FAST refinement).
    x: (B, NO, m).
    """
    xs = jnp.where(prep.unknown[..., :, None], x * prep.col_scale[..., :, None], 0.0)
    t = jnp.einsum("bkj,bjm->bkm", prep.c, xs)
    t = t * prep.w[..., :, None]
    y = jnp.einsum("bkj,bkm->bjm", prep.c, t)
    y = y * prep.row_scale[..., :, None]
    return jnp.where(prep.unknown[..., :, None], y, x)


def _solve_scaled(prep: Prepared, b: jax.Array,
                  mixed_steps: int | None = None) -> jax.Array:
    """Solve A_scaled X = b through the prepared factorization.

    b: (..., n, m) multi-RHS.  ``mixed_steps`` overrides the number of
    refinement sweeps in the mixed/fast modes (the class defaults below
    are tuned for cond ~ 1e2..1e5).

    * PRECISION_F64: direct back-substitution in the input dtype.
    * PRECISION_MIXED: f32 factorization + MIXED_REFINE_STEPS rounds of
      f64-residual refinement against the stored f64 scaled matrix.
    * PRECISION_FAST: f32 factorization + FAST_REFINE_STEPS rounds of
      f64-residual refinement with the matrix applied through the f64 basis
      rows (:func:`_matvec_scaled`) — converges to the true f64
      normal-equations solution without ever materializing a f64 matrix.
    """
    if prep.precision == PRECISION_F64:
        return solve_ops.solve_factored(prep.fac, b, prep.solver)
    dtype = b.dtype
    x = solve_ops.solve_factored(
        prep.fac, b.astype(jnp.float32), prep.solver
    ).astype(dtype)
    if prep.precision == PRECISION_MIXED:
        def body_mixed(_, x):
            r = b - prep.A_scaled @ x
            return x + solve_ops.solve_factored(
                prep.fac, r.astype(jnp.float32), prep.solver
            ).astype(dtype)

        n = MIXED_REFINE_STEPS if mixed_steps is None else mixed_steps
        x = lax.fori_loop(0, n, body_mixed, x)
    else:  # PRECISION_FAST
        def body_fast(_, x):
            r = b - _matvec_scaled(prep, x)
            return x + solve_ops.solve_factored(
                prep.fac, r.astype(jnp.float32), prep.solver
            ).astype(dtype)

        n = FAST_REFINE_STEPS if mixed_steps is None else mixed_steps
        x = lax.fori_loop(0, n, body_fast, x)
    return x


@partial(jax.jit, static_argnames=("iters",))
def cond_estimate(prep: Prepared, iters: int = 20) -> jax.Array:
    """Cheap per-case 2-norm condition estimates of the scaled matrices.

    The reference only exposes condition numbers in debug mode, where they
    are computed by full SVDs during prepare (reference:
    wlsqm/fitter/impl.pyx:661-682, wlsqm/fitter/expert.pyx:429-464).  This
    estimator instead runs ``iters`` rounds of batched power iteration
    (λmax, through the stored basis rows) and inverse iteration (1/λmin,
    through the stored factorization), so it works on any prepared batch —
    no debug mode, no O(n³) SVD — at the cost of being an estimate (a lower
    bound that is typically within a few percent for SPD spectra).

    Returns (B,) estimates of cond₂(A_scaled).
    """
    B, n = prep.active.shape
    dtype = prep.row_scale.dtype
    # deterministic dense start vector, unlikely to be orthogonal to the
    # extremal eigenvectors
    v0 = jnp.cos(jnp.arange(n, dtype=dtype) * 0.7) + jnp.float64(0.3).astype(dtype)
    v0 = jnp.broadcast_to(v0, (B, n))[..., None]

    def _norm(x):
        return jnp.sqrt(jnp.sum(x * x, axis=(-2, -1), keepdims=True))

    def pow_body(_, v):
        w = _matvec_scaled(prep, v)
        return w / jnp.maximum(_norm(w), 1e-300)

    v = lax.fori_loop(0, iters, pow_body, v0)
    lmax = _norm(_matvec_scaled(prep, v))[..., 0, 0]

    def inv_body(_, v):
        w = _solve_scaled(prep, v)
        return w / jnp.maximum(_norm(w), 1e-300)

    u = lax.fori_loop(0, iters, inv_body, v0)
    inv_lmin = _norm(_solve_scaled(prep, u))[..., 0, 0]
    return lmax * inv_lmin


def solve_prepared(prep: Prepared, fk: jax.Array, fi: jax.Array,
                   do_sens: bool = False, mixed_steps: int | None = None):
    """Fit the model against data ``fk`` using prepared geometry.

    Knowns elimination moves the known DOFs' contribution to the RHS
    (reference: wlsqm/fitter/impl.pyx:789-818); column scaling cancels for
    eliminated DOFs exactly as in the reference.

    Returns (fi_out, sens).  ``sens[b,k,j] = d fi[b,j] / d fk[b,k]`` for
    unknown DOFs, NaN for known DOFs, 0 for inactive padding
    (reference: wlsqm/fitter/impl.pyx:768-846).  ``sens`` is None when
    ``do_sens`` is False.
    """
    if prep.precision == PRECISION_DS:
        from wlsqm_tpu.fitter import engine_ds

        return engine_ds.solve_prepared_ds(prep, fk, fi, do_sens)
    dtype = fk.dtype
    known_vals = jnp.where(prep.known, fi, 0.0)
    if prep.dof_scale is not None:
        # basis rows are radius-normalized; DOFs in the scaled space carry
        # a factor s**degree, applied exactly (powers of two)
        known_vals = (known_vals / prep.dof_scale).astype(dtype)
    model_known = jnp.einsum(
        "bkj,bj->bk", prep.c, known_vals, preferred_element_type=dtype
    )
    # mask padded-neighbor slots (w == 0) so non-finite fk padding is inert
    resid = jnp.where(prep.w > 0, fk - model_known, 0.0)
    b = _rhs(prep, resid)
    x = _solve_scaled(prep, b[..., None], mixed_steps)[..., 0]
    sol = x * prep.col_scale
    if prep.dof_scale is not None:
        sol = sol * prep.dof_scale
    fi_out = jnp.where(prep.unknown, sol, fi)

    sens = None
    if do_sens:
        # all-nk multi-RHS triangular solves in one shot
        S = (prep.c * prep.w[..., None]).swapaxes(-1, -2)       # (B, NO, K)
        S = jnp.where(prep.unknown[..., None], S * prep.row_scale[..., None], 0.0)
        X = _solve_scaled(prep, S, mixed_steps)                  # (B, NO, K)
        sens = X.swapaxes(-1, -2) * prep.col_scale[..., None, :]  # (B, K, NO)
        if prep.dof_scale is not None:
            sens = sens * prep.dof_scale[..., None, :]
        sens = jnp.where(prep.unknown[..., None, :], sens, 0.0)
        sens = jnp.where(prep.known[..., None, :], jnp.nan, sens)
    return fi_out, sens


def solve_iterative_prepared(
    prep: Prepared,
    fk: jax.Array,
    fi: jax.Array,
    max_iter: int,
    do_sens: bool = False,
    mixed_steps: int | None = None,
    fixed_trip: bool = False,
):
    """Fit with iterative refinement (ALGO_ITERATIVE).

    Refinement loop semantics follow the reference
    (reference: wlsqm/fitter/impl.pyx:986-1083 ``solve_iterative``): before
    each corrective fit, evaluate the model at the data points, compute the
    l∞ residual norm over valid neighbors, and stop on *exact* norm
    stagnation (norm == previous norm) or after ``max_iter`` corrective fits.
    Sensitivities come from the initial solve only, as in the reference.

    ``fixed_trip=True`` runs the same body as a fixed-length ``lax.scan``
    over ``max_iter`` trips instead of an early-exiting ``while_loop``:
    stagnated cases are masked (bit-identical results, identical iteration
    counts), trips past all-stagnation are no-ops.  The scan form is
    reverse-mode differentiable (``while_loop`` has no transpose rule), at
    the cost of always paying for ``max_iter`` trips.

    Returns (fi_out, sens, iterations) with per-case iteration counts.
    """
    if prep.precision == PRECISION_DS:
        from wlsqm_tpu.fitter import engine_ds

        return engine_ds.solve_iterative_prepared_ds(
            prep, fk, fi, max_iter, do_sens, fixed_trip=fixed_trip)
    fi1, sens = solve_prepared(prep, fk, fi, do_sens, mixed_steps)
    dtype = fk.dtype
    kmask = prep.w > 0

    def body_core(done, fi_cur, prev_norm, iters):
        coeffs = jnp.where(prep.active, fi_cur, 0.0)
        if prep.dof_scale is not None:
            coeffs = (coeffs / prep.dof_scale).astype(dtype)
        model = jnp.einsum(
            "bkj,bj->bk", prep.c, coeffs, preferred_element_type=dtype
        )
        resid = jnp.where(kmask, fk - model, 0.0)
        norm = jnp.abs(resid).max(axis=-1)
        done_now = jnp.logical_or(done, norm == prev_norm)

        b = _rhs(prep, resid)
        dx = _solve_scaled(prep, b[..., None], mixed_steps)[..., 0]
        corr = dx * prep.col_scale
        if prep.dof_scale is not None:
            corr = corr * prep.dof_scale
        fi_new = jnp.where(prep.unknown, fi_cur + corr, fi_cur)
        fi_next = jnp.where(done_now[:, None], fi_cur, fi_new)
        iters = iters + jnp.logical_not(done_now).astype(jnp.int32)
        return (done_now, fi_next, norm, iters)

    # carries derived from fk (zeros_like/full_like) so they inherit sharding
    # metadata under shard_map
    init_core = (
        jnp.zeros_like(fk[:, 0], dtype=bool),
        fi1,
        jnp.full_like(fk[:, 0], -1.0),  # invalid prev norm, as in the reference
        jnp.zeros_like(fk[:, 0], dtype=jnp.int32),
    )
    if fixed_trip:
        def scan_body(state, _):
            return body_core(*state), None

        (_, fi_out, _, iters), _ = lax.scan(
            scan_body, init_core, None, length=max_iter)
        return fi_out, sens, iters

    def cond(state):
        i, done, *_ = state
        return jnp.logical_and(i < max_iter, jnp.logical_not(done.all()))

    def body(state):
        i = state[0]
        return (i + 1,) + body_core(*state[1:])

    _, _, fi_out, _, iters = lax.while_loop(
        cond, body, (jnp.array(0, jnp.int32),) + init_core)
    return fi_out, sens, iters


# -----------------------------------------------------------------------------
# One-shot fit (prepare + solve), the jit entry point for the simple API
# -----------------------------------------------------------------------------

@partial(
    jax.jit,
    static_argnames=(
        "dimension",
        "NO",
        "do_sens",
        "iterative",
        "max_iter",
        "solver",
        "debug",
        "ruiz_max_iter",
        "ruiz_eps",
        "precision",
        "scaling",
        "mixed_steps",
        "fixed_trip",
    ),
)
def fit_batch(
    xk: jax.Array,
    fk: jax.Array,
    nk: jax.Array,
    xi: jax.Array,
    fi: jax.Array,
    order: jax.Array,
    knowns: jax.Array,
    weighting: jax.Array,
    *,
    dimension: int,
    NO: int,
    do_sens: bool = False,
    iterative: bool = False,
    max_iter: int = 10,
    solver: str = solve_ops.SOLVER_CHOLESKY,
    debug: bool = False,
    ruiz_max_iter: int = ruiz_ops.RUIZ_MAX_ITER,
    ruiz_eps: float = ruiz_ops.RUIZ_EPS,
    precision: str = PRECISION_F64,
    scaling: str = "ruiz",
    mixed_steps: int | None = None,
    fixed_trip: bool = False,
):
    """Fit a batch of local models end to end.

    Returns (fi_out, sens, iterations, cond_scaled).  This is the batched,
    compiled equivalent of the reference's
    ``generic_fit_{basic,iterative}_many_parallel`` call stacks
    (reference: wlsqm/fitter/simple.pyx:953-1171) — the OpenMP prange becomes
    the batch axis.  See :func:`prepare` for ``ruiz_*`` and ``precision``;
    ``fixed_trip=True`` makes ALGO_ITERATIVE reverse-mode differentiable
    (see :func:`solve_iterative_prepared`).
    """
    prep = prepare(
        xk, nk, xi, order, knowns, weighting,
        dimension=dimension, NO=NO, solver=solver, debug=debug,
        ruiz_max_iter=ruiz_max_iter, ruiz_eps=ruiz_eps, precision=precision,
        scaling=scaling,
    )
    if iterative:
        fi_out, sens, iters = solve_iterative_prepared(
            prep, fk, fi, max_iter, do_sens, mixed_steps,
            fixed_trip=fixed_trip,
        )
    else:
        fi_out, sens = solve_prepared(prep, fk, fi, do_sens, mixed_steps)
        iters = jnp.zeros(fk.shape[0], jnp.int32)
    if sens is None:
        sens = jnp.zeros((0,), fk.dtype)  # jit-friendly placeholder
    return fi_out, sens, iters, prep.cond_scaled
