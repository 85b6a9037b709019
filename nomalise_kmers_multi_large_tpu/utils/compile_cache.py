"""Persistent XLA compilation cache placement.

A cold CLI run spends most of its set-up compiling the jitted batch steps;
the persistent cache lets the next run on the same machine load them
instead. One rule for every entry point (the CLI, ``bench.py``,
``chip_smoke.py``):

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself and nothing is
  configured here.
- otherwise: the cache lives at one fixed path inside the checkout,
  ``<repo>/.jax_cache`` (git-ignored). The path is part of what makes a
  cache hit possible, so it never depends on a pid, a time or a temp dir.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``cache_dir()``; returns it."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
