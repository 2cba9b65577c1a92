"""The one compile-cache helper every entry point calls."""

import os

import jax
import pytest

from fulgor_tpu import compile_cache
from fulgor_tpu.compile_cache import DEFAULT_DIR, enable_compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(compile_cache.__file__)))


@pytest.mark.parametrize("source", ["env", "default"])
def test_compile_cache_dir(source, tmp_path, monkeypatch):
    prev = jax.config.jax_compilation_cache_dir
    try:
        if source == "env":
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            first, second = enable_compile_cache(), enable_compile_cache()
            assert first == second == DEFAULT_DIR
            assert first == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == first
            with open(os.path.join(REPO, ".gitignore")) as f:
                assert ".jax_cache/" in f.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
