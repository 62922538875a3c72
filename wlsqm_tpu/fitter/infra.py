"""Problem-size helpers and DOF remapping (compat surface).

The reference's ``infra`` module is C-only memory infrastructure: a bump
Allocator, CaseManager and per-case Case structs with per-thread scratch
(reference: wlsqm/fitter/infra.pyx).  In the JAX rebuild that machinery has
no counterpart — state is batched device arrays inside the
:class:`wlsqm_tpu.fitter.engine.Prepared` pytree, XLA manages temporaries,
and "allocation" is array creation.  What remains here are the Python-useful
helpers: DOF counting and the original↔reduced DOF mappings implied by a
knowns bitmask (the reduction itself is done by masking in the engine, but
the mappings are handy for interpreting reduced-system quantities).
"""

from __future__ import annotations

import numpy as np

from wlsqm_tpu.fitter.defs import number_of_dofs, number_of_reduced_dofs

__all__ = ["number_of_dofs", "number_of_reduced_dofs", "remap"]


def remap(n: int, mask: int):
    """DOF index mappings between the full and knowns-reduced systems.

    Returns (o2r, r2o, nr): original→reduced and reduced→original index
    arrays (int32, -1 for non-existent entries) and the reduced DOF count
    (reference: wlsqm/fitter/infra.pyx:145-200).
    """
    o2r = np.full(n, -1, dtype=np.int32)
    r2o = np.full(n, -1, dtype=np.int32)
    k = 0
    for j in range(n):
        if not (mask >> j) & 1:
            o2r[j] = k
            r2o[k] = j
            k += 1
    return o2r, r2o, k
