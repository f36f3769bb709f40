"""The compile-cache helper: the environment's directory wins, otherwise the
fixed <repo>/.jax_cache.  Each case runs in a fresh interpreter so the test
process's own cache setting is untouched."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import json, jax
from flgp_tpu.utils.compile_cache import enable_compile_cache
used = enable_compile_cache()
print(json.dumps({"used": used, "config": jax.config.jax_compilation_cache_dir}))
"""


def _run(env_dir):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], env=env, capture_output=True, text=True,
        timeout=120, check=True,
    )
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("env_dir", [None, "/var/cache/jax-elsewhere"])
def test_cache_directory(env_dir):
    got = _run(env_dir)
    if env_dir is None:
        assert got["used"] == got["config"] == os.path.join(REPO, ".jax_cache")
    else:
        # JAX reads the variable itself; the helper sets no other directory
        assert got["used"] == got["config"] == env_dir
