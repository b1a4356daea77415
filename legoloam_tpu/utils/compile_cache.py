"""Persistent XLA compilation cache location, shared by every entry point.

The cache key includes the directory, so the path must not move between runs:
``<checkout>/.jax_cache`` (gitignored), unless ``JAX_COMPILATION_CACHE_DIR``
is set, in which case JAX reads that variable itself and nothing is set here.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory."""
    import jax

    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
