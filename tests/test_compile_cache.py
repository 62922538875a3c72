"""The persistent compilation cache lands where it should.

``JAX_COMPILATION_CACHE_DIR``, when set, is used as is; otherwise the
package points JAX at one fixed directory inside the checkout.  Each case
runs in a fresh interpreter, since the setting applies at import.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import json, jax, wlsqm_tpu
from wlsqm_tpu import config
from wlsqm_tpu.fitter import engine_ds
print(json.dumps({"jax": jax.config.jax_compilation_cache_dir,
                  "pkg": config.cache_dir(),
                  "canary": engine_ds._canary_store()}))
"""


def _probe(extra_env, code=PROBE):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(extra_env)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_env_directory_is_used_as_is(tmp_path):
    d = str(tmp_path / "cache")
    got = _probe({"JAX_COMPILATION_CACHE_DIR": d})
    assert got["jax"] == d and got["pkg"] == d
    assert got["canary"] == os.path.join(d, "ds_canary.json")


def test_default_is_fixed_in_checkout_path():
    got = _probe({})
    want = os.path.join(REPO, ".jax_cache")
    assert got["jax"] == want and got["pkg"] == want
    # the same path in a second interpreter: never pid- or time-derived
    assert _probe({}) == got


def test_default_path_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compiled_program_written_to_env_directory(tmp_path):
    d = tmp_path / "cache"
    code = """
import jax, jax.numpy as jnp, wlsqm_tpu
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
print(float(jax.jit(lambda x: jnp.sin(x) * 2.0)(jnp.ones(3)).sum()))
print('{}')
"""
    _probe({"JAX_COMPILATION_CACHE_DIR": str(d)}, code)
    assert d.is_dir() and any(d.iterdir())
