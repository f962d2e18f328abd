"""Where utils.enable_compilation_cache puts JAX's persistent cache."""

from pathlib import Path

import jax
import pytest

from qkd_ldpc_v_tpu.utils import enable_compilation_cache

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_dir_is_left_to_jax(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    before = jax.config.jax_compilation_cache_dir
    enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "cache").exists()


def test_default_is_fixed_path_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")
    assert (REPO / ".jax_cache").is_dir()
