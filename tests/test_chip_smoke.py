"""chip_smoke.py: refusal without a GPU, and its phases rehearsed small.

The script itself runs only on a GPU; here its phase functions run on the
CPU at shrunken sizes, so wrong paths, shapes and comparisons show up
before a chip run does.
"""

import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

SMALL = dict(
    HEADLINE_CASES=4000, HEADLINE_CHUNK=1000, STREAM_CASES=2500,
    IBVP_POINTS=6000, COMPAT_CASES=300, WIDE_CASES=512, SENS_CASES=256,
    PARITY_CASES=128, FOUR_POINTS=2048, FOUR_QUERIES=256,
    FOUR_STREAM_CASES=3000, FOUR_STREAM_CHUNK=1024)


@pytest.fixture
def small(monkeypatch):
    for name, value in SMALL.items():
        monkeypatch.setattr(chip_smoke, name, value)
    return jax.devices()[0]


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_without_gpu():
    out = _run(REPO, "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path), "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_headline_phase_rehearsal(small, capsys):
    chip_smoke.headline_phase(0, small)
    assert "fits/s" in capsys.readouterr().out


def test_ibvp_phase_rehearsal(small, capsys):
    chip_smoke.ibvp_phase(0, small)
    assert "ms per step" in capsys.readouterr().out


def test_wide_phase_rehearsal(small, capsys):
    chip_smoke.wide_phase(0, small)
    assert "iterations" in capsys.readouterr().out


def test_rel_err_requires_matching_nans():
    nan = float("nan")
    assert chip_smoke.rel_err([1.0, nan, 2.0], [1.0, nan, 2.0]) == 0.0
    assert chip_smoke.rel_err([1.0, 0.0, 2.0], [1.0, nan, 2.0]) == float("inf")
    assert chip_smoke.rel_err([1.0, 2.0], [1.0, 4.0]) == 0.5


def test_four_phase_rehearsal(small, capsys):
    if len(jax.devices()) < 4:
        pytest.skip("needs four (virtual) devices")
    chip_smoke.four_phase(0)
    assert "fit_stream(mesh=) vs one device" in capsys.readouterr().out
