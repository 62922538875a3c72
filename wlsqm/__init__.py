"""Drop-in ``wlsqm`` namespace backed by the JAX wlsqm_tpu framework.

Reference users can ``import wlsqm`` unchanged; every public name
(fit_* family, ExpertSolver, interpolate_fit, DOF constants, bitmasks,
number_of_dofs) resolves to the wlsqm_tpu implementation.  Mirrors the
reference's star-re-export layout (reference: wlsqm/__init__.py:25-28).
"""

from wlsqm.fitter.defs import *        # noqa: F401,F403
from wlsqm.fitter.simple import *      # noqa: F401,F403
from wlsqm.fitter.interp import *      # noqa: F401,F403
from wlsqm.fitter.expert import *      # noqa: F401,F403

from wlsqm_tpu import __version__      # noqa: F401
