"""Precision and compile-cache configuration for wlsqm_tpu.

WLSQM solves small, potentially ill-conditioned dense systems; the reference
implementation (reference: wlsqm/fitter/impl.pyx, README.md:76-78) is float64
throughout, and the parity bar for this rebuild is 1e-10 relative agreement.
Therefore the package enables JAX 64-bit mode on import unless the user opts
out by setting the environment variable ``WLSQM_TPU_NO_X64=1`` *before*
importing :mod:`wlsqm_tpu`.
"""

from __future__ import annotations

import os

import jax

_X64_WANTED = os.environ.get("WLSQM_TPU_NO_X64", "0") != "1"

if _X64_WANTED:
    jax.config.update("jax_enable_x64", True)

# On NVIDIA GPUs XLA may run float32 contractions in TF32 (10 mantissa
# bits), which is far too coarse for normal-matrix assembly in the f32
# emulation modes.  The critical einsums pass precision=HIGHEST explicitly;
# this global default protects the remaining float32 contractions as well.
# float64 contractions are unaffected.  Opt out with
# WLSQM_TPU_DEFAULT_MATMUL_PRECISION=default.
_MM_PREC = os.environ.get("WLSQM_TPU_DEFAULT_MATMUL_PRECISION", "highest")
if _MM_PREC != "default":
    jax.config.update("jax_default_matmul_precision", _MM_PREC)

# Persistent compilation cache.  JAX_COMPILATION_CACHE_DIR, when set, is
# read by JAX itself and used as is.  Otherwise the cache lives at one fixed
# directory inside the checkout: the path is part of the cache key, so a
# directory that moves between runs never hits.
_REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")
_CACHE = os.environ.get("JAX_COMPILATION_CACHE_DIR") or _REPO_CACHE
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", _CACHE)


def cache_dir() -> str:
    """The persistent cache directory.

    Shared by the XLA compilation cache and the ds-fidelity canary verdict
    (:func:`wlsqm_tpu.fitter.engine_ds.ds_backend_ok`).
    """
    return _CACHE


def default_dtype():
    """The default floating dtype for fitting (float64 unless x64 disabled)."""
    import jax.numpy as jnp

    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
