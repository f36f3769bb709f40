"""Test configuration: 8 virtual CPU devices, float64 enabled.

Tests run on CPU (fast, deterministic, f64-capable) with a faked 8-device
mesh so multi-device sharding logic is exercised without hardware, per the
strategy in SURVEY.md §4.  Tests marked ``gpu`` need a CUDA device; they
skip here (the ``gpu_device`` fixture decides, at run time) and
``chip_smoke.py`` runs what they cover on the card.
"""

import os

# Force CPU before JAX picks a backend: set both the environment and the
# config, since a JAX imported earlier in the process has already read the
# environment.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the suite is compile-bound on small hosts;
# re-runs hit disk instead of re-invoking XLA.
from flgp_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test where there is none."""
    try:
        devs = jax.devices("cuda")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a CUDA device; chip_smoke.py runs this on the card")
    return devs[0]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)
