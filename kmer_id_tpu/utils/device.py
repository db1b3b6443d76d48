"""Process-level JAX set-up shared by the CLI, bench.py and chip_smoke.py.

* :func:`setup_compile_cache` points JAX's persistent compilation cache at
  one fixed directory, so a second process (or a second run) with the same
  shapes loads its executables instead of compiling them again.
* :func:`device_summary` names the backend a run is really on, so a run that
  silently came up on the CPU is visible in its log.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def setup_compile_cache() -> str:
    """Enable the persistent compile cache; returns the directory in use.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is left
    alone.  Otherwise the cache lives at ``<repo>/.jax_cache``: a fixed path,
    because the directory is part of what makes a later run find its entries.
    """
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def device_summary() -> dict:
    """Platform, device kind and device count of the default backend."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }
