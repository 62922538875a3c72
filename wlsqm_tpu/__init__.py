"""wlsqm_tpu — batched JAX Weighted Least SQuares Meshless framework.

A from-scratch JAX/XLA rebuild of the capabilities of the reference
``wlsqm`` package (Weighted Least SQuares Meshless: a fast and accurate
meshless interpolator/differentiator for scalar data on scattered 1D/2D/3D
point clouds).  For each reference point xi, a local polynomial surrogate of
order 0–4 is fitted over a neighborhood by weighted least squares; the solved
DOFs directly equal the function value and all partial derivatives of the
surrogate at xi.

Two API layers:

* **Compatibility layer** (this namespace): mirrors the reference's public
  surface — ``fit_{1D,2D,3D}[_iterative][_many][_parallel]``,
  ``ExpertSolver``, ``interpolate_fit`` / ``lambdify_fit``, the ``i?_*`` DOF
  index and ``b?_*`` knowns-bitmask constants, ``ALGO_*`` / ``WEIGHT_*`` ids
  and ``number_of_dofs`` (reference: wlsqm/__init__.py:25-28).  NumPy arrays
  in, in-place outputs, same defaults.

* **Functional JAX layer** (:mod:`wlsqm_tpu.api`,
  :mod:`wlsqm_tpu.fitter.engine`): pure, jittable, batch-first functions and
  the ``Prepared`` pytree for prepare-once/solve-many workflows, composable
  with ``jax.jit`` / ``vmap`` / ``shard_map`` for multi-device scaling
  (:mod:`wlsqm_tpu.parallel`).

float64 mode is enabled at import (see :mod:`wlsqm_tpu.config`).
"""

from wlsqm_tpu import config  # noqa: F401  (enables x64 first)

from wlsqm_tpu.fitter.defs import *  # noqa: F401,F403  constants + number_of_dofs
from wlsqm_tpu.fitter.simple import *  # noqa: F401,F403  fit_* family
from wlsqm_tpu.fitter.interp import (  # noqa: F401
    interpolate_fit,
    lambdify_fit,
    interpolate_continuous,
)
from wlsqm_tpu.fitter.expert import ExpertSolver  # noqa: F401
from wlsqm_tpu.api import (  # noqa: F401
    fit,
    fit_many,
    fit_stream,
    plan_fit_many,
    prepare,
    solve,
    interpolate,
    FitPlan,
    FitResult,
)
from wlsqm_tpu.fitter.engine import Prepared  # noqa: F401

__version__ = "0.3.0"
