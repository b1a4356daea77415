"""Entry-point plumbing: the shared compile-cache location and the GPU smoke
script's refusal to run without a GPU."""

import json
import os
import subprocess
import sys

import jax
import pytest

from legoloam_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_default_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    path = compile_cache.enable()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_env_var_left_to_jax(monkeypatch, restore_cache_dir,
                                           tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", "untouched")
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == "untouched"


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
