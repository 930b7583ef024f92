"""The single compile-cache helper (utils/runtime.py)."""

from pathlib import Path

import jax
import pytest

from otto_tpu.utils import runtime


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in before.items():
        jax.config.update(k, v)


def test_env_variable_wins_and_nothing_is_set(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "from_env"))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compilation_cache() == str(tmp_path / "from_env")
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_checkout_directory(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = Path(__file__).resolve().parents[1]
    assert runtime.DEFAULT_CACHE_DIR == repo / ".jax_cache"
    assert runtime.enable_compilation_cache() == str(repo / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == str(repo / ".jax_cache")
    assert (repo / ".jax_cache").is_dir()
    assert ".jax_cache/" in (repo / ".gitignore").read_text().split()
