"""Persistent XLA compilation cache.

Compiling the encoder pipeline at a new shape takes a long time (the
candidate-shift unrolls produce large programs); JAX's persistent
compilation cache lets every later process load the executables instead.
Used by the CLI apps and the benchmark.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no directory. Otherwise the cache lives at one fixed path
inside the checkout (``<repo>/.jax_cache``, ignored by git): the path is
part of what a cache hit needs, so it must not move between runs.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ),
    ".jax_cache",
)

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def enable_persistent_cache() -> None:
    """Enable the JAX compilation cache (see the module docstring)."""
    import jax

    if not os.environ.get(ENV_VAR):
        os.makedirs(DEFAULT_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
