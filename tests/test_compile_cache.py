"""The compilation-cache helper: JAX_COMPILATION_CACHE_DIR when set,
otherwise a fixed directory in the checkout; GEMM autotuning fixed."""

import os

import jax
import pytest

from rabbit_transcoding_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("env_dir", ["/var/cache/rabbit-jax", None])
def test_cache_dir(env_dir, monkeypatch, restore_cache_dir):
    monkeypatch.setenv("XLA_FLAGS", "")
    jax.config.update("jax_compilation_cache_dir", None)
    if env_dir is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        want = os.path.join(REPO, ".jax_cache")
    else:
        monkeypatch.setenv(compile_cache.ENV_VAR, env_dir)
        want = env_dir
    assert compile_cache.enable_compile_cache() == want
    assert compile_cache.cache_dir() == want
    # with the variable set, JAX reads it itself and code sets nothing
    assert jax.config.jax_compilation_cache_dir == (
        None if env_dir else want)


@pytest.mark.parametrize("user_flags", ["", "--xla_gpu_autotune_level=4"])
def test_autotune_level_fixed(user_flags, monkeypatch, restore_cache_dir):
    monkeypatch.setenv("XLA_FLAGS", user_flags)
    compile_cache.enable_compile_cache()
    flags = os.environ["XLA_FLAGS"].split()
    if user_flags:
        assert flags == [user_flags]  # an explicit level is left alone
    else:
        assert flags == [compile_cache.AUTOTUNE_FLAG]
