"""README-golden reproduction on the GPU with x64 enabled (run by bench.py
as a subprocess with JAX_ENABLE_X64=1, before bench.py itself touches the
card).

The committed parity evidence for the spiral goldens is CPU-f64 + the exact
R-session anchor replay (tests/test_golden.py: SE 0.50322 vs golden 0.5032,
reference README.md:149).  This script reproduces the same numbers on
the GPU: the f32-default configuration next to the f64 solve tail
(FitConfig.solve_dtype — graph stage stays f32, the train/predict tail is
cast, fit/drivers.py:_solve_cast), both on the exact Hartigan–Wong anchors
(datasets.spiral_r_anchors).  Prints one JSON line; exits non-zero without
a GPU.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

import flgp_tpu
from flgp_tpu import FitConfig, GraphConfig
from flgp_tpu.datasets import spiral_r, spiral_r_anchors
from flgp_tpu.utils.compile_cache import enable_compile_cache

GOLDEN_SE = 0.5032   # README.md:149
GOLDEN_LAE = 0.4582  # README.md:169


def main():
    assert jax.config.jax_enable_x64, "run with JAX_ENABLE_X64=1"
    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench_golden_f64: needs a GPU, JAX found {jax.devices()[0].platform}")
    ds = spiral_r()
    anchors = spiral_r_anchors()
    key = jax.random.PRNGKey(0)
    out = {"golden_platform": jax.devices()[0].platform}

    def rmse(res):
        return float(np.sqrt(np.mean((res.y_test - ds.y_test) ** 2)))

    g = GraphConfig(s=500, r=3, K=100)
    configs = {
        "f32": FitConfig(graph=g, sigma=1e-5, dtype=jnp.float32),
        "f64tail": FitConfig(graph=g, sigma=1e-5, dtype=jnp.float32, solve_dtype=jnp.float64),
    }
    for name, cfg in configs.items():
        r_se = flgp_tpu.fit_se_regression_gp(
            key, ds.x_train, ds.y_train, ds.x_test, cfg, anchors=anchors["se"]
        )
        out[f"golden_se_rmse_{name}_anchors"] = round(rmse(r_se), 5)
        r_lae = flgp_tpu.fit_lae_regression_gp(
            key, ds.x_train, ds.y_train, ds.x_test, cfg, anchors=anchors["lae"]
        )
        out[f"golden_lae_rmse_{name}_anchors"] = round(rmse(r_lae), 5)
    out["golden_se_rmse_ref"] = GOLDEN_SE
    out["golden_lae_rmse_ref"] = GOLDEN_LAE
    print(json.dumps(out))


if __name__ == "__main__":
    main()
