"""Placement of JAX's persistent compile cache."""

import jax
import pytest

from polychase_tpu import compile_cache


@pytest.fixture
def cache_dir_config():
    old = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_variable_set_is_used_as_is(monkeypatch, cache_dir_config, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the code sets no other directory.
    assert jax.config.jax_compilation_cache_dir is None


def test_variable_unset_uses_fixed_checkout_path(monkeypatch,
                                                 cache_dir_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.configure_compile_cache()
    assert path == compile_cache.DEFAULT_DIR
    assert path.endswith(".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # The same path on every call, whatever the working directory.
    assert compile_cache.configure_compile_cache() == path


def test_directory_chosen_in_code_is_kept(monkeypatch, cache_dir_config,
                                          tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    assert compile_cache.configure_compile_cache() == str(tmp_path)


def test_default_dir_is_gitignored():
    import os

    root = os.path.dirname(compile_cache.DEFAULT_DIR)
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
