"""Persistent compilation cache placement (runtime.cache).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX uses it and the program
sets no directory of its own; otherwise the cache is one fixed directory
inside the checkout, so every run finds the previous run's executables.
"""

import os

import jax
import pytest

from svc_tpu.runtime import cache as cache_mod


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_dir_is_used_and_not_overridden(
    tmp_path, monkeypatch, restore_cache_dir
):
    monkeypatch.setenv(cache_mod.ENV_VAR, str(tmp_path))
    # JAX reads the variable itself when it starts; stand in for that
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    cache_mod.enable_persistent_cache()
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_default_dir_is_inside_the_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(cache_mod.ENV_VAR, raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache_mod.DEFAULT_DIR == os.path.join(repo, ".jax_cache")
    cache_mod.enable_persistent_cache()
    assert jax.config.jax_compilation_cache_dir == cache_mod.DEFAULT_DIR
    assert os.path.isdir(cache_mod.DEFAULT_DIR)


def test_default_dir_is_fixed(monkeypatch, restore_cache_dir):
    """No version or home directory in the path: a directory that moves
    between runs never hits."""
    monkeypatch.delenv(cache_mod.ENV_VAR, raising=False)
    import svc_tpu

    monkeypatch.setattr(svc_tpu, "__version__", "999.0.0")
    monkeypatch.setenv("HOME", "/nonexistent-home")
    cache_mod.enable_persistent_cache()
    assert jax.config.jax_compilation_cache_dir == cache_mod.DEFAULT_DIR
    assert os.path.basename(cache_mod.DEFAULT_DIR) == ".jax_cache"
