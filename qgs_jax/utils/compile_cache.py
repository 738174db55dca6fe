"""Persistent XLA compilation cache for the repository's entry scripts."""

from __future__ import annotations

import os
import pathlib

import jax

REPO = pathlib.Path(__file__).resolve().parents[2]


def enable_compile_cache():
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX has already read it and
    nothing is changed.  Otherwise the cache lives at ``<repo>/.jax_cache``
    (listed in ``.gitignore``): a fixed path, since the path is part of the
    cache key."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(REPO / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
