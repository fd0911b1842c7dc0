"""Where the persistent XLA compilation cache lives, for every entry point.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is changed here. Otherwise the cache goes to ``<checkout>/.jax_cache``, a
fixed path: the cache is keyed by what was compiled, so a directory that
stays put lets every later process on the same host skip the compile.
"""

from __future__ import annotations

import os

import jax

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory. Call before the first compile."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
