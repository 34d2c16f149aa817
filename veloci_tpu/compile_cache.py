"""Persistent XLA compilation cache for the serving entry points.

Compiles are the dominant cold-start cost of a serving process: the banded
sweep kernel at each dictionary length-window width plus dozens of fused
search programs. JAX's persistent compilation cache serialises compiled
executables to disk keyed by (HLO, backend, flags), so every process after
the first loads them instead of recompiling.

Where the cache lives:

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself, and nothing is
  set here.
* otherwise: ``.jax_cache`` at the root of the checkout (gitignored), a
  fixed path, so reruns on one checkout hit it.

CPU-only processes (``JAX_PLATFORMS=cpu``: the tests, the host reference)
get no cache from here: CPU executables are pinned to the machine's
features, and CPU compiles are fast. ``VELOCI_COMPILE_CACHE=0`` disables.

The reference engine (Rust, CPU) has no compile step at all; persisting
executables is how a jit-compiled engine meets its cold-start bar.
"""

from __future__ import annotations

import os

__all__ = ["enable_compile_cache", "DEFAULT_DIR"]

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compile_cache() -> str | None:
    """Turn on the persistent compilation cache before the first compile
    and return its directory (None when off). Idempotent and cheap; it
    never initialises a backend, so host-only processes stay off the
    device."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if os.environ.get("VELOCI_COMPILE_CACHE") == "0":
        return None
    import jax

    platforms = os.environ.get("JAX_PLATFORMS") or str(
        jax.config.jax_platforms or ""
    )
    if platforms.split(",")[0] == "cpu":
        return None
    if jax.config.jax_compilation_cache_dir != DEFAULT_DIR:
        os.makedirs(DEFAULT_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
    return DEFAULT_DIR
