"""Persistent XLA compilation cache setup.

Every entry point (tests, CLI, bench, chip_smoke.py) calls
``enable_persistent_cache()`` so compiled executables are reused across
processes.  The directory is, in order:

  * ``JAX_COMPILATION_CACHE_DIR`` when set, used exactly as given;
  * otherwise the fixed ``.jax_cache/`` inside the checkout (a fixed
    path: the path is part of the cache's key, so a directory that
    moves never hits).
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")

_DONE = False


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_persistent_cache() -> str:
    """Point JAX's persistent compilation cache at ``cache_dir()`` and
    cache every compile; returns the directory."""
    global _DONE
    path = cache_dir()
    if _DONE:
        return path
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    _DONE = True
    return path
