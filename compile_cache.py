"""Persistent compilation cache for the repository's scripts.

A 1M-particle sweep or PGAS chain takes long enough to compile that every
benchmark and smoke script keeps JAX's persistent compilation cache.  Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing here
changes it; otherwise the cache lives at a fixed ``<checkout>/.jax_cache``
(listed in ``.gitignore``), so one checkout's runs find each other's entries.
"""

from __future__ import annotations

import os

import jax

__all__ = ["CHECKOUT_CACHE_DIR", "enable_compile_cache"]

CHECKOUT_CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; return its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
