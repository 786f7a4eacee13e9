"""The compile-cache helper and chip_smoke.py's refusal to run without a GPU."""

import os
import subprocess
import sys

import jax

from uvol_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record_config_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    return calls


def test_compile_cache_env_set_changes_nothing(monkeypatch, tmp_path):
    calls = _record_config_updates(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_env_unset_uses_checkout_dir(monkeypatch):
    calls = _record_config_updates(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(ROOT, ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]
    # a fixed path: the same directory on every call
    assert compile_cache.enable_compile_cache() == want


def test_chip_smoke_fails_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", HOME=str(tmp_path))
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path),
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU: JAX_PLATFORMS='cpu' names none" in r.stderr


def test_chip_smoke_fails_when_jax_finds_no_gpu(tmp_path):
    """With no platform named, JAX's own search finds only the CPU here."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["HOME"] = str(tmp_path)
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path),
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU: JAX backend is cpu" in r.stderr
