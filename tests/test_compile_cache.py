"""Compile-cache policy (pre3_tpu/__init__.py): JAX_COMPILATION_CACHE_DIR
wins when set; otherwise one fixed directory inside the checkout."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir(env_value):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, pre3_tpu; print(jax.config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, timeout=120, check=True,
    )
    return out.stdout.strip()


@pytest.mark.parametrize("env_value", ["/nonexistent/elsewhere", None])
def test_cache_dir(env_value):
    want = env_value or os.path.join(REPO, ".jax_cache")
    assert _cache_dir(env_value) == want


def test_in_checkout_dir_is_gitignored():
    lines = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in lines
