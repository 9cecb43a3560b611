"""Persistent XLA compilation cache.

The chain and sketch programs take tens of seconds to compile the first
time (large sorts and the chain-DP kernel); the persistent cache brings
repeat runs — CLI invocations, benchmarks, CI — down to seconds.  The
reference binding has no compilation step at all, so amortising ours is
part of matching its interactive latency.
"""

from __future__ import annotations

import os

_DEFAULT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")
_enabled = False


def enable_compilation_cache() -> str:
    """Point JAX at a persistent on-disk compilation cache.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its
    cache there and no other directory is set.  Otherwise the cache is
    ``.jax_cache/`` at the checkout root.  Idempotent.
    Returns the cache directory, or ``""`` when no persistent cache is
    used (on the CPU backend).
    """
    global _enabled
    import jax

    # accelerator executables serialize portably; XLA:CPU AOT results
    # are compiled for the exact host CPU feature set, and DEserialising
    # one written by a different machine can SIGILL/segfault (observed:
    # a cache populated on an avx512 host crashed the CPU test suite on
    # the next host).  CPU compiles are fast — skip the persistent
    # cache entirely off-accelerator.
    if jax.default_backend() == "cpu":
        return ""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if not _enabled:
        os.makedirs(_DEFAULT, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", _DEFAULT)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        _enabled = True
    return _DEFAULT
