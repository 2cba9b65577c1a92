"""One place that decides where JAX keeps its persistent compile cache.

Every entry point (the CLI, bench.py, chip_smoke.py, __graft_entry__.py,
the tests and the scripts) calls enable_compile_cache() before its first
jit. When JAX_COMPILATION_CACHE_DIR is set, that directory is used and
nothing else is configured. Otherwise the cache lives at one fixed path
inside the checkout (DEFAULT_DIR, listed in .gitignore): the path is part
of the cache key, so a directory that moved between runs would never hit.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; -> the path."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path
