"""Persistence of the ds-fidelity canary verdict across processes.

The canary (engine_ds.ds_backend_ok) costs two engine compiles per process;
the verdict is stored on disk in the persistent cache directory, keyed by
(canary version, backend, jax version), so the compiles are one-time per
machine — like the XLA compilation cache it shares the directory with.
"""

import json

import jax
import pytest

from wlsqm_tpu.fitter import engine_ds


@pytest.fixture
def canary_env(monkeypatch, tmp_path):
    """Fresh in-process canary cache + a tmp persistent store."""
    monkeypatch.setattr(engine_ds, "_DS_CANARY", {})
    store = tmp_path / "ds_canary.json"
    monkeypatch.setattr(engine_ds, "_canary_store", lambda: str(store))
    return store


def test_persisted_verdict_short_circuits_the_canary(canary_env, monkeypatch):
    def boom():  # pragma: no cover - must not run
        raise AssertionError("canary re-ran despite a persisted verdict")

    monkeypatch.setattr(engine_ds, "_run_ds_canary", boom)
    canary_env.write_text(json.dumps({engine_ds._canary_key("cpu"): True}))
    assert engine_ds.ds_backend_ok() is True
    # and the opposite verdict is honored too
    monkeypatch.setattr(engine_ds, "_DS_CANARY", {})
    canary_env.write_text(json.dumps({engine_ds._canary_key("cpu"): False}))
    assert engine_ds.ds_backend_ok() is False


def test_fresh_verdict_is_persisted(canary_env, monkeypatch):
    monkeypatch.setattr(engine_ds, "_run_ds_canary", lambda: False)
    assert engine_ds.ds_backend_ok() is False
    data = json.loads(canary_env.read_text())
    assert data[engine_ds._canary_key("cpu")] is False


def test_corrupt_store_remeasures(canary_env, monkeypatch):
    canary_env.write_text("{not json")
    monkeypatch.setattr(engine_ds, "_run_ds_canary", lambda: True)
    assert engine_ds.ds_backend_ok() is True
    # the re-measured verdict replaces the corrupt store
    assert json.loads(canary_env.read_text())[engine_ds._canary_key("cpu")]


def test_key_is_version_scoped(canary_env, monkeypatch):
    """A verdict from another jax version or canary version is ignored."""
    canary_env.write_text(json.dumps({
        f"v{engine_ds._CANARY_VERSION}:cpu:jax-0.0.0": True,
        f"v{engine_ds._CANARY_VERSION - 1}:cpu:jax-{jax.__version__}": True,
    }))
    ran = []
    monkeypatch.setattr(engine_ds, "_run_ds_canary",
                        lambda: ran.append(1) or False)
    assert engine_ds.ds_backend_ok() is False
    assert ran, "stale keys must not satisfy the lookup"


def test_no_store_means_no_persistence(monkeypatch):
    monkeypatch.setattr(engine_ds, "_DS_CANARY", {})
    monkeypatch.setattr(engine_ds, "_canary_store", lambda: None)
    monkeypatch.setattr(engine_ds, "_run_ds_canary", lambda: True)
    assert engine_ds.ds_backend_ok() is True


def test_store_path_follows_config(monkeypatch, tmp_path):
    from wlsqm_tpu import config

    monkeypatch.setattr(config, "_CACHE", str(tmp_path))
    assert engine_ds._canary_store() == str(tmp_path / "ds_canary.json")
    # the store's directory is created on first write
    sub = tmp_path / "fresh"
    monkeypatch.setattr(config, "_CACHE", str(sub))
    engine_ds._persist_verdict("cpu", True)
    assert sub.joinpath("ds_canary.json").exists()
