"""Persistent compile cache placement: JAX_COMPILATION_CACHE_DIR when set,
else one fixed directory inside the checkout; none for CPU runs."""

import os
import subprocess
import sys

import pytest

from image_stitch_tpu.ops import device as D

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_env_dir_wins(tmp_path):
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path), "JAX_PLATFORMS": "cuda"}
    assert D.compile_cache_dir(env) == str(tmp_path)


@pytest.mark.parametrize("platforms", ["", "cuda", "gpu"])
def test_default_dir_is_fixed_inside_checkout(platforms):
    got = D.compile_cache_dir({"JAX_PLATFORMS": platforms})
    assert got == D.COMPILE_CACHE_DIR == os.path.join(REPO, ".jax_cache")


def test_cpu_runs_keep_no_cache():
    assert D.compile_cache_dir({"JAX_PLATFORMS": "cpu"}) is None


def test_never_under_home_cache():
    home_cache = os.path.join(os.path.expanduser("~"), ".cache")
    assert not D.COMPILE_CACHE_DIR.startswith(home_cache)
    assert not D.COMPILE_CACHE_DIR.startswith(os.path.realpath(home_cache))


def _child(code: str, **env) -> str:
    full = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    full.update(env)
    full["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, env=full, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_env_dir_receives_compiled_programs(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, importing the device module sets
    no other directory, and compiled programs land in the env's."""
    code = (
        "import jax, jax.numpy as jnp\n"
        "import image_stitch_tpu.ops.device\n"
        "jax.jit(lambda x: x * 3 + 1)(jnp.arange(8)).block_until_ready()\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    got = _child(
        code, JAX_COMPILATION_CACHE_DIR=str(tmp_path), JAX_PLATFORMS="cpu",
        JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
        JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0",
    )
    assert got == str(tmp_path)
    assert os.listdir(tmp_path)
