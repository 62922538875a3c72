"""Test fixtures for wlsqm_tpu.

The suite runs on CPU with 8 virtual devices so that sharding tests exercise
real multi-device partitioning without accelerator hardware; the GPU run is
``python chip_smoke.py`` (and ``--four``).  Environment variables must be
set before JAX is imported, hence the assignments at module import time.
The persistent compilation cache is off, so the suite neither reads nor
writes compiled programs on disk (tests/test_compile_cache.py checks the
cache's configuration in subprocesses).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest

SEED = 42


def pytest_configure(config):
    # honor WLSQM_TPU_RUN_SLOW=1: undo the default "-m 'not slow'" addopts
    # so the multi-minute interpret-mode kernel tests run too
    if os.environ.get("WLSQM_TPU_RUN_SLOW") and config.option.markexpr == "not slow":
        config.option.markexpr = ""


@pytest.fixture
def rng():
    """Seeded generator, fresh per test, for reproducible failures."""
    return np.random.default_rng(SEED)


# ---------------------------------------------------------------------------
# Analytic polynomials used as exact-recovery oracles.
#
# Each helper returns (f, fi_expected) where fi_expected is in the
# "partially baked" DOF convention: entries are derivative VALUES at the
# origin (so a monomial coefficient a of x^2 contributes 2a to the X2 slot).
# ---------------------------------------------------------------------------

def quadratic_2d():
    """f(x,y) = 1 + 2x + 3y + 4xy + 5x² + 6y²; origin derivatives below."""
    def f(xy):
        x, y = xy[..., 0], xy[..., 1]
        return 1.0 + 2.0 * x + 3.0 * y + 4.0 * x * y + 5.0 * x**2 + 6.0 * y**2
    # DOF order F, X, Y, X2, XY, Y2 -> derivative values 1, 2, 3, 10, 4, 12
    return f, np.array([1.0, 2.0, 3.0, 10.0, 4.0, 12.0])


def quadratic_1d():
    """f(x) = 1 + 2x + 3x²; (F, X, X2) = (1, 2, 6)."""
    def f(x):
        return 1.0 + 2.0 * x + 3.0 * x**2
    return f, np.array([1.0, 2.0, 6.0])


def quadratic_3d():
    """f(x,y,z) = 1 + 2x - y + 3z + xy; 10 DOFs at order 2."""
    def f(p):
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        return 1.0 + 2.0 * x - y + 3.0 * z + x * y
    return f, np.array([1.0, 2.0, -1.0, 3.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0])


def cubic_2d():
    """f = 1 + x - 2y + 3x² - xy + 2y² + x³ - 4x²y + y³; 10 DOFs at order 3."""
    def f(xy):
        x, y = xy[..., 0], xy[..., 1]
        return (1.0 + x - 2.0 * y + 3.0 * x**2 - x * y + 2.0 * y**2
                + x**3 - 4.0 * x**2 * y + y**3)
    return f, np.array(
        [1.0, 1.0, -2.0, 6.0, -1.0, 4.0, 6.0, -8.0, 0.0, 6.0]
    )
