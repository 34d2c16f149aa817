"""The one compile-cache rule: JAX_COMPILATION_CACHE_DIR wins untouched;
otherwise a fixed ``.jax_cache`` in the checkout, never for CPU-only
processes."""

import os

import jax
import pytest

from veloci_tpu import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of applying them."""
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("VELOCI_COMPILE_CACHE", raising=False)
    return calls


def test_env_dir_is_left_to_jax(monkeypatch, config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/dir")
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    assert compile_cache.enable_compile_cache() == "/some/dir"
    assert config_updates == []


def test_default_dir_is_fixed_inside_the_checkout(monkeypatch, config_updates):
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    assert compile_cache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    assert compile_cache.enable_compile_cache() == compile_cache.DEFAULT_DIR
    assert ("jax_compilation_cache_dir", compile_cache.DEFAULT_DIR) in config_updates
    # a second call finds the same fixed path: one cache, same key
    assert compile_cache.enable_compile_cache() == compile_cache.DEFAULT_DIR


@pytest.mark.parametrize("env", [{"JAX_PLATFORMS": "cpu"}, {"VELOCI_COMPILE_CACHE": "0"}])
def test_cpu_only_or_disabled_sets_nothing(monkeypatch, config_updates, env):
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert compile_cache.enable_compile_cache() is None
    assert config_updates == []


def test_persistence_uses_the_same_rule(monkeypatch, config_updates):
    """Library entry points go through the same function (no second cache
    under the home directory)."""
    from veloci_tpu import persistence

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/dir")
    persistence.Persistence.create_from_str('{"a": "b"}', "{}")
    assert config_updates == []
    assert not hasattr(persistence, "enable_compilation_cache")
