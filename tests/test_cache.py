"""Compile-cache directory rules (utils/cache.py).

Each case runs in a fresh process: the test harness has already
configured this process's cache."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import sys
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp
from se3_icp.utils import cache
path = cache.enable_persistent_cache()
jax.jit(lambda x: jnp.sin(x) * 3.0 + 1.0)(jnp.arange(7.0)).block_until_ready()
print("CACHE_DIR=" + path)
print("CONFIG_DIR=" + jax.config.jax_compilation_cache_dir)
"""


def _probe(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run([sys.executable, "-c", PROBE, REPO], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = dict(ln.split("=", 1) for ln in out.stdout.splitlines()
                 if "=" in ln)
    return lines["CACHE_DIR"], lines["CONFIG_DIR"]


def test_env_dir_used_as_is(tmp_path):
    """JAX_COMPILATION_CACHE_DIR is used exactly: no suffix, no other
    directory, and the compiled entries land in it."""
    d = tmp_path / "jaxcache"
    path, cfg = _probe(d)
    assert path == cfg == str(d)
    entries = os.listdir(d)
    assert entries, "no cache entries written"
    assert all(os.path.isfile(d / e) for e in entries), entries


def test_default_dir_is_checkout_jax_cache():
    path, cfg = _probe(None)
    assert path == cfg == os.path.join(REPO, ".jax_cache")


def test_cache_dir_reads_env(monkeypatch, tmp_path):
    from se3_icp.utils import cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert cache.cache_dir() == cache.DEFAULT_DIR
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    assert cache.cache_dir() == cache.DEFAULT_DIR
