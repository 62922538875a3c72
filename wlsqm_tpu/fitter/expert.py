"""ExpertSolver: prepare-once / solve-many API with cached factorizations.

Batched rebuild of the reference's expert mode
(reference: wlsqm/fitter/expert.pyx:66-781).  The reference caches per-case
C buffers (basis matrix, scaled+LU-factored normal matrix) inside a
CaseManager and reuses them across solves; here the prepared state is a
:class:`wlsqm_tpu.fitter.engine.Prepared` pytree of batched device arrays
resident in device memory, and ``solve()`` is one jit-compiled batched program against
it.  This is the natural fit for IBVP explicit time stepping: geometry is
prepared once, then each time step solves with new data.

Guest mode (``host=``) shares the host solver's prepared arrays instead of
recomputing them (reference: wlsqm/fitter/expert.pyx:110-124,161-189) — with
immutable pytrees this is literally sharing the same ``Prepared`` object, and
the reference's "host must stay alive" footgun disappears.

Global interpolation patches the local models into a piecewise global
surrogate (reference: wlsqm/fitter/expert.pyx:658-781): 'nearest' evaluates
each query with the Voronoi-nearest local model; 'continuous' blends all
models within radius ``r`` with weight ``(1 - sqrt(d²/r²))²``.  The kNN /
radius searches run on a host k-d tree; the model evaluations are batched on
device.
"""

from __future__ import annotations

import operator
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from wlsqm_tpu.fitter import defs, engine, tables
from wlsqm_tpu.ops import solve as solve_ops

__all__ = ["ExpertSolver", "number_of_dofs"]

# re-export (reference: wlsqm/fitter/expert.pyx:57-63)
number_of_dofs = defs.number_of_dofs


_prepare_jit = partial(
    jax.jit,
    static_argnames=("dimension", "NO", "solver", "debug",
                     "ruiz_max_iter", "ruiz_eps", "precision", "scaling"),
)(engine.prepare)

_solve_jit = jax.jit(engine.solve_prepared,
                     static_argnames=("do_sens", "mixed_steps"))

_SOLVE_API_JIT = []


def _solve_api_jit():
    """jit-wrapped :func:`wlsqm_tpu.api.solve` (lazy: api imports expert).

    One compiled call keeps solve_device's dispatch to a single launch
    instead of one dispatch per op of api.solve's graph.
    """
    if not _SOLVE_API_JIT:
        from wlsqm_tpu import api

        _SOLVE_API_JIT.append(jax.jit(
            api.solve,
            static_argnames=("do_sens", "iterative", "max_iter",
                             "mixed_steps")))
    return _SOLVE_API_JIT[0]
_solve_iter_jit = jax.jit(
    engine.solve_iterative_prepared,
    static_argnames=("max_iter", "do_sens", "mixed_steps")
)


@partial(jax.jit, static_argnames=("dimension", "NO", "diff"))
def _eval_models_at_points(fi, active, xi, x, *, dimension, NO, diff):
    """Evaluate model b at point x[b], for b = 0..M-1 (one point per model).

    fi (M, NO) padded coefficients, ``active`` masks each case's true DOF
    count so heterogeneous per-case orders evaluate correctly.
    """
    coeffs = jnp.where(active, fi, 0.0)
    P = tables.diff_projection(dimension, diff)[:NO, :NO]
    coeffs = coeffs @ jnp.asarray(P.T, fi.dtype)
    delta = x - xi                                  # (M, dim)
    c = engine.basis(delta, dimension, NO)          # (M, NO)
    return jnp.einsum("mj,mj->m", c, coeffs)


class ExpertSolver:
    """Advanced API with separate prepare and solve stages.

    Typical usage::

        s = ExpertSolver(dimension, nk, order, knowns, weighting_method, ...)
        s.prepare(xi, xk)     # build + precondition + factor (once)
        s.solve(fk, fi)       # many times, with different data fk

    Constructor arguments mirror the reference
    (reference: wlsqm/fitter/expert.pyx:92-157): per-case arrays ``nk``,
    ``order``, ``knowns``, ``weighting_method`` of shape (ncases,);
    ``algorithm`` one of ALGO_BASIC/ALGO_ITERATIVE; ``do_sens``; ``max_iter``;
    ``ntasks`` (accepted for compatibility — parallelism is the batch axis);
    ``debug`` (compute 2-norm condition numbers during prepare);
    ``host`` (guest mode: share another prepared solver's geometry arrays);
    ``precision`` — None or "f64" (default: native float64, the
    reference's arithmetic), or one of the explicit emulation modes
    "mixed"/"fast"/"ds" (~1e-12 agreement with f64 on benchmark-scale
    neighborhoods; see :mod:`wlsqm_tpu.fitter.engine`).

    Unlike the reference, the prepared state is an immutable pytree of JAX
    arrays (:attr:`prepared`), so solvers are cheap to snapshot/serialize and
    guest instances cannot dangle.
    """

    def __init__(self, dimension, nk, order, knowns, weighting_method,
                 algorithm=defs.ALGO_BASIC, do_sens=False, max_iter=10,
                 ntasks=1, debug=False, host=None,
                 precision=None, scaling=None, solver=None):
        nk = np.asarray(nk, dtype=np.int32)
        order = np.asarray(order, dtype=np.int32)
        knowns = np.asarray(knowns, dtype=np.int64)
        weighting_method = np.asarray(weighting_method, dtype=np.int32)

        # Per-case arrays are the contract (reference:
        # wlsqm/fitter/expert.pyx:92-103); a scalar here is a usage error —
        # report it as one instead of an IndexError on .shape[0].
        for name, arr in (("nk", nk), ("order", order), ("knowns", knowns),
                          ("weighting_method", weighting_method)):
            if arr.ndim != 1:
                raise ValueError(
                    "%s must be a 1D per-case array of shape (ncases,); got "
                    "ndim=%d (broadcast scalars with e.g. np.full(ncases, v))"
                    % (name, arr.ndim))

        ncases = nk.shape[0]
        if (order.shape[0] != ncases or knowns.shape[0] != ncases
                or weighting_method.shape[0] != ncases):
            raise ValueError(
                "nk, order, knowns and weighting_method must have the same "
                "length; got len(nk)=%d, len(order)=%d, len(knowns)=%d, "
                "len(weighting_method)=%d"
                % (nk.shape[0], order.shape[0], knowns.shape[0],
                   weighting_method.shape[0]))
        if dimension not in (1, 2, 3):
            raise ValueError("Dimension must be 1, 2 or 3, got %s" % (dimension,))
        # algorithm is a scalar in the reference too (one `int` for the whole
        # solver, wlsqm/fitter/expert.pyx:93); a per-case array is a usage
        # error — report it as one instead of numpy's ambiguous-truth-value
        # error.  Size-1 arrays coerce like the reference's int() would.
        try:
            algorithm = operator.index(
                algorithm.item() if isinstance(algorithm, np.ndarray)
                and algorithm.size == 1 else algorithm)
        except TypeError:
            raise TypeError(
                "algorithm must be a single ALGO_* integer for the whole "
                "solver (the reference takes one int, not a per-case array); "
                "got %r" % (type(algorithm).__name__,)) from None
        if algorithm not in (defs.ALGO_BASIC, defs.ALGO_ITERATIVE):
            raise ValueError(
                "Unknown algorithm specifier %s; see wlsqm_tpu.fitter.defs "
                "for valid specifiers ALGO_*" % (algorithm,))
        if ntasks is None or ntasks < 1:
            raise ValueError("ntasks must be >= 1, got %s" % (ntasks,))

        if host is not None:
            if not host.ready:
                raise RuntimeError(
                    "In guest mode, host must be in the ready state "
                    "(host.prepare() must have been called first).")
            if host.ncases != ncases:
                raise RuntimeError(
                    "In guest mode, number of cases must match; got %d, host "
                    "has %d" % (ncases, host.ncases))
            if host.dimension != dimension:
                raise ValueError(
                    "In guest mode, dimension must match; got %d, host has %d"
                    % (dimension, host.dimension))
            if bool(host.debug) != bool(debug):
                raise ValueError(
                    "In guest mode, debug flag must match; got %s, host has %s"
                    % (bool(debug), bool(host.debug)))
            for name, mine, theirs in (
                ("nk", nk, host.nk), ("order", order, host.order),
                ("knowns", knowns, host.knowns),
                ("weighting_method", weighting_method, host.weighting_method),
            ):
                if (np.asarray(theirs) != mine).any():
                    raise ValueError(
                        "In guest mode, '%s' must match element-by-element."
                        % name)

        self.host = host
        self.ready = False
        self.dimension = int(dimension)
        self.algorithm = int(algorithm)
        self.max_iter = int(max_iter)
        self.ncases = int(ncases)
        self.do_sens = bool(do_sens)
        self.ntasks = int(ntasks)
        self.debug = bool(debug)

        self.nk = nk
        self.order = order
        self.knowns = knowns
        self.weighting_method = weighting_method

        # precision mode for the engine ("f64" reference-exact; "mixed",
        # "fast" or "ds" emulate it in float32 — see wlsqm_tpu.fitter.engine)
        self.precision = "f64" if precision is None else precision
        precision = self.precision
        if scaling is None:
            scaling = "ruiz" if precision == "f64" else "jacobi"
        if solver is None:
            solver = (solve_ops.SOLVER_CHOLESKY if precision in ("f64", "mixed")
                      else solve_ops.SOLVER_CHOLESKY_UNROLLED)
        self.scaling = scaling
        self.solver = solver

        self.NO = defs.number_of_dofs(self.dimension, int(order.max()))
        self.xk = None
        self.xi = None
        self.tree = None
        self.prepared: engine.Prepared | None = None
        self._fi_internal = None  # last solved coefficients, (ncases, NO)
        self._fi0_dev = None      # cached device zeros for knowns-free solves
        # active-DOF write-back mask (reference Case_get_fi copies the
        # active DOFs only; trailing inactive DOFs stay untouched)
        counts = np.asarray(defs._DOF_COUNTS[self.dimension])
        no_per = counts[np.clip(self.order, 0, defs.MAX_ORDER)]
        self._active_np = (np.arange(self.NO)[None, :] < no_per[:, None])

    # -- prepare -----------------------------------------------------------

    def prepare(self, xi, xk):
        """Build, precondition and factor the problem matrix for each case.

        (reference: wlsqm/fitter/expert.pyx:309-426)

        xi: (ncases, dim) fit origins ((ncases,) in 1D)
        xk: (ncases, max(nk), dim) neighbor coordinates ((ncases, max(nk)) in 1D)
        """
        self.ready = False

        if self.host is not None:
            # guest mode: borrow the host's prepared arrays outright
            self.prepared = self.host.prepared
            self.xk = self.host.xk
            self.xi = self.host.xi
            self.tree = self.host.tree
            self.ready = True
            return

        xi = np.asarray(xi, dtype=np.float64)
        xk = np.asarray(xk, dtype=np.float64)
        if self.dimension == 1:
            xi_b = xi.reshape(self.ncases, 1)
            xk_b = xk.reshape(self.ncases, -1, 1)
        else:
            xi_b = xi
            xk_b = xk

        self.xi = xi
        self.xk = xk
        self._fi0_dev = None
        self.tree = None

        self.prepared = _prepare_jit(
            jnp.asarray(xk_b),
            jnp.asarray(self.nk),
            jnp.asarray(xi_b),
            jnp.asarray(self.order),
            jnp.asarray(self.knowns),
            jnp.asarray(self.weighting_method),
            dimension=self.dimension,
            NO=self.NO,
            solver=self.solver,
            debug=self.debug,
            precision=self.precision,
            scaling=self.scaling,
        )
        self.ready = True

    def conds(self, estimate=False):
        """Per-case 2-norm condition numbers of the scaled problem matrices.

        Requires ``debug=True`` and a prior :meth:`prepare`
        (reference: wlsqm/fitter/expert.pyx:429-464).

        ``estimate=True`` (extension): return cheap power-iteration
        estimates from the prepared factorizations instead — available
        without debug mode and without the O(n³) SVDs
        (:func:`wlsqm_tpu.fitter.engine.cond_estimate`).
        """
        if not self.ready:
            raise RuntimeError(
                "Solver is not in the ready state; prepare() must be called "
                "before conds()")
        if estimate:
            return np.asarray(engine.cond_estimate(self.prepared))
        if not self.debug:
            raise RuntimeError(
                "Not in debug mode; condition number data has not been computed")
        return np.asarray(self.prepared.cond_scaled)

    def memory_used(self):
        """Bytes held by the prepared device arrays, as (used, total).

        The reference reports its bump-allocator fill
        (reference: wlsqm/fitter/expert.pyx:289-306); here the analogous
        quantity is the footprint of the Prepared pytree in device memory.
        """
        if self.prepared is None:
            return (0, 0)
        total = sum(
            leaf.size * leaf.dtype.itemsize
            for leaf in jax.tree_util.tree_leaves(self.prepared)
            if hasattr(leaf, "dtype")
        )
        return (total, total)

    # -- solve -------------------------------------------------------------

    def solve(self, fk, fi, sens=None):
        """Fit the model to data ``fk`` using the prepared geometry.

        (reference: wlsqm/fitter/expert.pyx:467-655)

        fk  : (ncases, max(nk)) function values at the neighbor points —
              a NumPy array, or a device (JAX) array (skips the upload)
        fi  : (ncases, NO) in/out NumPy — knowns in, unknowns filled in
              place (use :meth:`solve_device` for device-resident output)
        sens: (ncases, max(nk), NO) out if ``do_sens`` was set

        Returns the maximum number of refinement iterations taken (0 for
        ALGO_BASIC).

        Boundary notes (round 3): device-array ``fk`` is consumed without
        a host copy; the knowns seed ``fi`` is uploaded only when the
        batch actually has known DOFs (a cached device zero-buffer serves
        otherwise); all outputs come back in ONE ``jax.device_get`` (one
        host sync instead of up to three).
        """
        if not self.ready:
            raise RuntimeError(
                "Solver is not in the ready state; prepare() must be called "
                "before solve()")

        fk_is_dev = isinstance(fk, jax.Array)
        fk_j = fk if fk_is_dev else jnp.asarray(np.asarray(fk, np.float64))
        K = int(fk_j.shape[1])
        kn = int(np.asarray(self.knowns).max())
        fi_np = np.asarray(fi)
        if kn or self.algorithm == defs.ALGO_ITERATIVE:
            fi_in = jnp.asarray(
                np.ascontiguousarray(fi_np[:, :self.NO], dtype=np.float64))
        else:
            if self._fi0_dev is None:
                self._fi0_dev = jnp.zeros((self.ncases, self.NO))
            fi_in = self._fi0_dev

        if self.algorithm == defs.ALGO_ITERATIVE:
            fi_out, sens_out, iters = _solve_iter_jit(
                self.prepared, fk_j, fi_in,
                max_iter=self.max_iter, do_sens=self.do_sens)
        else:
            fi_out, sens_out = _solve_jit(
                self.prepared, fk_j, fi_in, do_sens=self.do_sens)
            iters = None

        self._fi_internal = fi_out
        outs = [fi_out]
        if iters is not None:
            outs.append(iters)
        if self.do_sens:
            outs.append(sens_out)
        host_out = jax.device_get(outs)  # one transfer/sync for everything
        # reference Case_get_fi copies each case's ACTIVE DOFs; inactive
        # trailing DOFs of lower-order cases stay untouched
        np.copyto(fi[:, :self.NO], host_out[0], where=self._active_np)
        nxt = 1
        max_iters = 0
        if iters is not None:
            max_iters = int(host_out[nxt].max(initial=0))
            nxt += 1
        if self.do_sens:
            if sens is None:
                raise ValueError("do_sens solver requires a sens output array")
            sens[:, :K, :self.NO] = host_out[nxt]
        return max_iters

    def solve_device(self, fk, fi_init=None):
        """Device-resident solve: JAX arrays in, JAX arrays out, no sync.

        The extension :meth:`solve` cannot offer under the reference's
        in-place NumPy contract: nothing crosses the host boundary, so
        back-to-back calls (an IBVP time loop, a multi-field sweep)
        pipeline asynchronously on device.  Runs the prepared-path engine
        at the prepared precision.

        fk: (ncases, max_nk) for one field, or (F, ncases, max_nk) to
        solve F fields against the same factorizations in one call.
        fi_init: optional (…, ncases, NO) knowns/seed values.

        Returns ``(fi, sens, iterations)`` — device arrays; ``sens`` is
        None unless ``do_sens``; ``iterations`` is zeros for ALGO_BASIC.
        """
        if not self.ready:
            raise RuntimeError(
                "Solver is not in the ready state; prepare() must be called "
                "before solve_device()")
        out = _solve_api_jit()(
            self.prepared, fk, fi_init, do_sens=self.do_sens,
            iterative=self.algorithm == defs.ALGO_ITERATIVE,
            max_iter=self.max_iter)
        if len(out) == 2:
            fi_out, sens_out = out
            iters = jnp.zeros(fi_out.shape[:-1], jnp.int32)
        else:
            fi_out, sens_out, iters = out
        self._fi_internal = fi_out[0] if fi_out.ndim == 3 else fi_out
        return fi_out, sens_out, iters

    def solve_stream(self, fk_iter, fi_init=None):
        """Pipelined repeated solves: one solve kept in flight.

        Generator over an iterable of ``fk`` arrays (time steps, field
        sweeps).  Step i+1 is DISPATCHED (async, device-side) before step
        i's results are fetched, so the host transfer + sync of step i
        overlaps the device compute of step i+1 — the double-buffer
        pattern the in-place :meth:`solve` contract cannot express
        (its output array must be filled before it returns).  Where the
        per-call sync dominates, this halves the effective per-step
        latency of a host-driven time loop; device-resident loops should
        use :meth:`solve_device` inside ``lax.scan`` instead.

        fk_iter: iterable of (ncases, max_nk) host or device arrays.
        fi_init: optional (ncases, NO) knowns/seed, reused every step.

        Yields ``(fi, max_iters)`` per step — ``fi`` a fresh host
        (ncases, NO) float64 array, ``max_iters`` an int (0 for
        ALGO_BASIC), matching :meth:`solve`'s return convention.
        """
        # validate eagerly (a generator body would defer these errors to
        # the first next(), far from the faulty call site)
        if not self.ready:
            raise RuntimeError(
                "Solver is not in the ready state; prepare() must be called "
                "before solve_stream()")
        if self.do_sens:
            raise ValueError(
                "solve_stream does not support do_sens (the sensitivity "
                "tensor would dominate the transfer); use solve()")
        return self._solve_stream_inner(fk_iter, fi_init)

    def _solve_stream_inner(self, fk_iter, fi_init):
        def finalize(pending):
            fi_d, it_d = pending
            fi_np, it_np = jax.device_get([fi_d, it_d])
            return fi_np, int(np.asarray(it_np).max(initial=0))

        pending = None
        for fk in fk_iter:
            fi_d, _sens, it_d = self.solve_device(fk, fi_init)
            if pending is not None:
                yield finalize(pending)
            pending = (fi_d, it_d)
        if pending is not None:
            yield finalize(pending)

    # -- global interpolation ---------------------------------------------

    def prep_interpolate(self):
        """Index the xi points for fast nearest/radius lookups.

        (reference: wlsqm/fitter/expert.pyx:658-681)
        """
        if not self.ready:
            raise RuntimeError(
                "Solver is not in the ready state; prepare() must be called "
                "before prep_interpolate()")
        if self.host is not None:
            self.tree = self.host.tree
        else:
            from wlsqm_tpu.utils.neighbors import host_tree

            xi_rank2 = (self.xi if self.dimension >= 2
                        else np.atleast_2d(self.xi).T)
            self.tree = host_tree(xi_rank2)

    def interpolate(self, x, mode="nearest", r=None, diff=0, I=None,
                    device=False):
        """Interpolate the patched global model (or a derivative) at ``x``.

        (reference: wlsqm/fitter/expert.pyx:687-781)

        mode='nearest':   Voronoi-piecewise — each query uses the local model
                          whose origin is nearest (jumps across cell borders).
        mode='continuous': weighted average of all local models with origin
                          within radius ``r``; weight (1 - sqrt(d²/r²))²
                          falls to zero at r, giving a continuous patching.
        I: optional per-query model indices to skip the nearest-model search.
        device=True (extension, mode='continuous', homogeneous order): run
        the blending fully on device — no host k-d tree, no
        prep_interpolate needed
        (:func:`wlsqm_tpu.fitter.interp.interpolate_continuous`).

        Returns (out, I_out); I_out is None in 'continuous' mode.
        """
        if mode not in ("nearest", "continuous"):
            raise ValueError(
                "mode must be one of 'nearest', 'continuous'; got '%s'" % (mode,))
        if mode == "continuous" and r is None:
            raise ValueError("r must be specified in mode='continuous'")
        if diff is None:
            raise ValueError("diff cannot be None")
        if device and mode == "continuous":
            if self._fi_internal is None:
                raise RuntimeError(
                    "solve() must be called before interpolate()")
            order = np.asarray(self.order)
            if order.min() != order.max():
                raise ValueError(
                    "device=True requires a homogeneous per-case order")
            from wlsqm_tpu.fitter.interp import interpolate_continuous

            x = np.asarray(x, dtype=np.float64)
            xq = x.reshape(-1, 1) if self.dimension == 1 else x
            xi_b = (self.xi.reshape(-1, 1) if self.dimension == 1
                    else np.asarray(self.xi))
            num, den = interpolate_continuous(
                self._fi_internal, jnp.asarray(xi_b), jnp.asarray(xq), r,
                dimension=self.dimension, order=int(order[0]),
                diff=int(diff))
            with np.errstate(invalid="ignore", divide="ignore"):
                out = np.asarray(num) / np.asarray(den)
            return (out, None)
        if self.tree is None:
            raise RuntimeError(
                "Points xi have not been indexed; prep_interpolate() must be "
                "called before interpolate()")
        if self._fi_internal is None:
            raise RuntimeError("solve() must be called before interpolate()")
        if I is not None and len(I) != len(x):
            raise ValueError(
                "When 'I' is specified, 'I' must have the same length as x; "
                "got len(I) = %d, len(x) = %d." % (len(I), len(x)))

        x = np.asarray(x, dtype=np.float64)
        xq = x.reshape(-1, 1) if self.dimension == 1 else x
        nx = xq.shape[0]
        xi_b = (self.xi.reshape(-1, 1) if self.dimension == 1
                else np.asarray(self.xi))

        if mode == "nearest":
            if I is None:
                _, idx = self.tree.query(xq, k=1)
                idx = np.asarray(idx, dtype=np.int64)
            else:
                idx = np.asarray(I, dtype=np.int64)
            fi_g = self._fi_internal[jnp.asarray(idx)]
            act_g = self.prepared.active[jnp.asarray(idx)]
            xi_g = jnp.asarray(xi_b)[jnp.asarray(idx)]
            out = _eval_models_at_points(
                fi_g, act_g, xi_g, jnp.asarray(xq),
                dimension=self.dimension, NO=self.NO, diff=int(diff))
            return (np.asarray(out), idx)

        # continuous mode: radius query on the host tree, batched eval on device
        neighbor_lists = self.tree.query_ball_point(xq, r)
        pair_q = np.concatenate(
            [np.full(len(lst), m, dtype=np.int64)
             for m, lst in enumerate(neighbor_lists)]
        ) if nx else np.zeros(0, np.int64)
        pair_m = np.concatenate(
            [np.asarray(lst, dtype=np.int64) for lst in neighbor_lists]
        ) if nx else np.zeros(0, np.int64)

        out = np.zeros(nx, dtype=np.float64)
        if pair_q.size:
            fi_g = self._fi_internal[jnp.asarray(pair_m)]
            act_g = self.prepared.active[jnp.asarray(pair_m)]
            xi_g = jnp.asarray(xi_b)[jnp.asarray(pair_m)]
            xpts = jnp.asarray(xq[pair_q])
            vals = np.asarray(_eval_models_at_points(
                fi_g, act_g, xi_g, xpts,
                dimension=self.dimension, NO=self.NO, diff=int(diff)))
            d2 = ((xq[pair_q] - np.asarray(xi_b)[pair_m]) ** 2).sum(axis=-1)
            # alpha = 0 variant of the center weight; falls to 0 at r
            # (reference: wlsqm/fitter/expert.pyx:40-46,978-980)
            tmp = 1.0 - np.sqrt(d2 / (r * r))
            wgt = tmp * tmp
            num = np.zeros(nx)
            den = np.zeros(nx)
            np.add.at(num, pair_q, wgt * vals)
            np.add.at(den, pair_q, wgt)
            with np.errstate(invalid="ignore", divide="ignore"):
                out = num / den
        return (out, None)
