"""One place that decides where JAX's persistent compilation cache lives.

A cache directory is part of the cache key, so it has to be fixed: when
``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and nothing here
sets another; otherwise the cache is ``<repo>/.jax_cache`` (git-ignored).
Never a temporary, per-process or timed path.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


# Programs that compile faster than this are not worth a disk round trip.
MIN_COMPILE_TIME_SECS = 0.5


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory."""
    env_dir = os.environ.get(ENV_VAR)
    if not env_dir:
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", MIN_COMPILE_TIME_SECS)
    return env_dir or REPO_CACHE_DIR
