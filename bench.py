"""Benchmark harness: README-parity goldens + throughput on one GPU.

    python bench.py

Covers every BASELINE.json config:
  1/2. README goldens on the reference's exact R-stream splits (PARITY.md) —
       torus GPC (LAE + SE kernels), spiral GPR (LAE + SE), plus a seed sweep
       for the anchor-draw distribution.
  3.   Multiclass (one-vs-rest) GPC at n=7e4 with an SMC posterior over the
       per-class diffusion times.
  4.   Kernel ablation at n=1e5 — LAE vs SE vs Nyström — with NUTS over
       (u, t, noise), chains vmapped on the device.
  5.   The n=1e6/1e7 spectral-stage and GPC-fit numbers, and the Triton LAE
       kernel against the XLA scan (kernel alone and end to end).

Headline metric stays the flagship LKFLGP fit wall-clock vs the reference's
committed 3.97 s (/root/reference/README.md:106).  Steady-state timing: each
jitted pipeline compiles on a first call, then is timed to
``jax.block_until_ready``.  Needs a GPU and exits non-zero without one or
when any stage fails.  Prints ONE JSON line; parity/secondary numbers ride
as extra fields.  Everything runs f32 with Precision.HIGHEST-pinned
contractions (config.PRECISION).
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import flgp_tpu
from flgp_tpu import FitConfig, GraphConfig
from flgp_tpu.datasets import digits_large, spiral, spiral_r, torus_rings_r
from flgp_tpu.utils.compile_cache import enable_compile_cache
from flgp_tpu.utils.metrics import MetricsReport

_HERE = os.path.dirname(os.path.abspath(__file__))


def _mark(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)

BASELINE_TORUS_LKFLGP_S = 3.97      # README.md:106
BASELINE_TORUS_SKFLGP_S = 20.95     # README.md:91
BASELINE_TORUS_ERR = 0.02702       # README.md:109
BASELINE_TORUS_SE_ERR = 0.0        # README.md:94
BASELINE_SPIRAL_RMSE = 0.4582      # README.md:169
BASELINE_SPIRAL_SE_RMSE = 0.5032   # README.md:149


def _timed(fn, key):
    """Compile and warm with one call, then time a second identical call."""
    jax.block_until_ready(fn(key))
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(key))
    return out, time.perf_counter() - t0


def bench_goldens(report: MetricsReport):
    key = jax.random.PRNGKey(0)
    tor = torus_rings_r()
    sp = spiral_r()
    cfg = FitConfig(graph=GraphConfig(s=600, r=3, K=100), sigma=1e-3)
    cfg_r = FitConfig(graph=GraphConfig(s=500, r=3, K=100), sigma=1e-5)
    out = {}

    _mark("goldens: torus LAE")
    with report.stage("torus_lae_fit"):
        res, dt = _timed(
            lambda k: flgp_tpu.fit_lae_logit_gp(k, tor.x_train, tor.y_train, tor.x_test, cfg=cfg),
            key,
        )
    # capture NOW: `res` is reassigned by every later fit, and the sampling
    # benchmark needs the *torus* eigenpair (pairing spiral eigenvectors with
    # torus labels would silently measure a meaningless posterior)
    torus_res = res
    out["torus_fit_s"] = dt
    out["torus_err"] = float(np.mean(res.y_test != tor.y_test))

    _mark("goldens: torus SE")
    with report.stage("torus_se_fit"):
        res, dt = _timed(
            lambda k: flgp_tpu.fit_se_logit_gp(k, tor.x_train, tor.y_train, tor.x_test, cfg=cfg),
            key,
        )
    out["torus_se_fit_s"] = dt
    out["torus_se_err"] = float(np.mean(res.y_test != tor.y_test))

    _mark("goldens: spiral LAE (+12-seed anchor sweep)")
    with report.stage("spiral_lae_fit"):
        res, dt = _timed(
            lambda k: flgp_tpu.fit_lae_regression_gp(k, sp.x_train, sp.y_train, sp.x_test, cfg_r),
            key,
        )
    out["spiral_fit_s"] = dt
    out["spiral_rmse"] = float(np.sqrt(np.mean((res.y_test - sp.y_test) ** 2)))
    rmses = [out["spiral_rmse"]]
    for seed in range(1, 12):
        r = flgp_tpu.fit_lae_regression_gp(
            jax.random.PRNGKey(seed), sp.x_train, sp.y_train, sp.x_test, cfg_r
        )
        rmses.append(float(np.sqrt(np.mean((r.y_test - sp.y_test) ** 2))))
    out["spiral_rmse_seed_mean"] = float(np.mean(rmses))
    out["spiral_rmse_seed_min"] = float(np.min(rmses))

    _mark("goldens: spiral SE")
    with report.stage("spiral_se_fit"):
        res, dt = _timed(
            lambda k: flgp_tpu.fit_se_regression_gp(k, sp.x_train, sp.y_train, sp.x_test, cfg_r),
            key,
        )
    out["spiral_se_fit_s"] = dt
    out["spiral_se_rmse"] = float(np.sqrt(np.mean((res.y_test - sp.y_test) ** 2)))
    return out, torus_res


def bench_sampling(report: MetricsReport, torus_eig):
    """ESS/sec/chip on the torus GPC posterior — HMC and NUTS (north star).
    The eigenpair must be the torus one (see bench_goldens)."""
    from flgp_tpu.datasets import torus_rings_r
    from flgp_tpu.inference.diagnostics import ess
    from flgp_tpu.inference.hmc import run_hmc
    from flgp_tpu.inference.nuts import run_nuts
    from flgp_tpu.models.latent import GpcLogPost, make_whitened

    tor = torus_rings_r()
    K = 100
    m = tor.x_train.shape[0]
    gp = make_whitened(torus_eig, jnp.arange(m), K, 1e-3)
    logpost = GpcLogPost(
        gp, jnp.asarray(tor.y_train, jnp.float32), jnp.ones((m,), jnp.float32),
        1e-2, 10.0, 2.0,
    )
    n_chains, n_samp = 16, 512
    x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (n_chains, K + 1), jnp.float32)
    out = {}

    _mark("sampling: HMC (adaptive)")
    hmc = jax.jit(lambda k, x: run_hmc(k, logpost, x, n_warmup=256, n_samples=n_samp, n_leapfrog=16))
    jax.block_until_ready(hmc(jax.random.PRNGKey(2), x0).samples)
    with report.stage("hmc") as slot:
        t0 = time.perf_counter()
        run = hmc(jax.random.PRNGKey(3), x0)
        jax.block_until_ready(run.samples)
        hmc_s = time.perf_counter() - t0
        slot["wall"] = hmc_s
    out["gpc_min_ess_per_sec_per_chip_incl_warmup"] = float(
        np.min(ess(np.asarray(run.samples, np.float64)))
    ) / hmc_s
    out["hmc_accept_mean"] = float(jnp.mean(run.accept_prob))

    # north star: steady-state sampling throughput — adapted (step, mass)
    # fixed, long chain so the estimate is tight and warmup amortized
    # (production chains run thousands of post-warmup draws)
    from flgp_tpu.inference.hmc import run_hmc_fixed
    from flgp_tpu.inference.nuts import run_nuts_fixed

    _mark("sampling: HMC (steady-state)")
    n_fixed, n_leap = 2048, 16
    x_adapted = run.samples[-1]
    hmc_f = jax.jit(
        lambda k, x: run_hmc_fixed(
            k, logpost, x, run.step, run.inv_mass, n_samples=n_fixed, n_leapfrog=n_leap
        )
    )
    jax.block_until_ready(hmc_f(jax.random.PRNGKey(6), x_adapted).samples)
    with report.stage("hmc_fixed") as slot:
        t0 = time.perf_counter()
        frun = hmc_f(jax.random.PRNGKey(7), x_adapted)
        jax.block_until_ready(frun.samples)
        hmc_fs = time.perf_counter() - t0
        slot["wall"] = hmc_fs
    out["gpc_min_ess_per_sec_per_chip"] = float(
        np.min(ess(np.asarray(frun.samples, np.float64)))
    ) / hmc_fs
    out["hmc_fixed_accept_mean"] = float(jnp.mean(frun.accept_prob))
    # raw leapfrog throughput (BASELINE north-star: "vectorized log-prob +
    # leapfrog throughput per chip").  One gradient per leapfrog step; each
    # whitened-GPC gradient is dominated by two (m, K) matvecs fwd + two in
    # reverse ≈ 8·m·K flops.  Cross-check (sat_hmc_*_xla_grad_gflops): XLA's
    # cost analysis counts ~4.6·m·K per gradient — the hand model is ~1.7×
    # high because XLA counts each fused multiply-add once and shares the
    # forward V·(scale·u) product with the VJP; both numbers ride in the
    # JSON, the XLA count is the authoritative one.
    steps = n_chains * n_fixed * n_leap
    out["hmc_leapfrog_steps_per_sec"] = steps / hmc_fs
    out["hmc_logprob_grad_est_gflops"] = steps * 8.0 * m * K / hmc_fs / 1e9

    _mark("sampling: NUTS (adaptive)")
    nuts = jax.jit(lambda k, x: run_nuts(k, logpost, x, n_warmup=256, n_samples=n_samp, max_depth=8))
    jax.block_until_ready(nuts(jax.random.PRNGKey(4), x0).samples)
    with report.stage("nuts") as slot:
        t0 = time.perf_counter()
        nrun = nuts(jax.random.PRNGKey(5), x0)
        jax.block_until_ready(nrun.samples)
        nuts_s = time.perf_counter() - t0
        slot["wall"] = nuts_s
    out["gpc_nuts_min_ess_per_sec_per_chip_incl_warmup"] = float(
        np.min(ess(np.asarray(nrun.samples, np.float64)))
    ) / nuts_s
    out["nuts_accept_mean"] = float(jnp.mean(nrun.accept_stat))

    _mark("sampling: NUTS (steady-state)")
    nuts_f = jax.jit(
        lambda k, x: run_nuts_fixed(
            k, logpost, x, nrun.step, nrun.inv_mass, n_samples=1024, max_depth=8
        )
    )
    jax.block_until_ready(nuts_f(jax.random.PRNGKey(8), nrun.samples[-1]).samples)
    with report.stage("nuts_fixed") as slot:
        t0 = time.perf_counter()
        nfrun = nuts_f(jax.random.PRNGKey(9), nrun.samples[-1])
        jax.block_until_ready(nfrun.samples)
        nuts_fs = time.perf_counter() - t0
        slot["wall"] = nuts_fs
    out["gpc_nuts_min_ess_per_sec_per_chip"] = float(
        np.min(ess(np.asarray(nfrun.samples, np.float64)))
    ) / nuts_fs
    return out


def bench_sampling_saturation(report: MetricsReport, torus_eig):
    """Chip-saturation sweep for the north-star sampler: chains ∈
    {16 … 16384} × K ∈ {100, 256} on the torus GPC posterior, steady-state
    HMC (run_hmc_fixed with metrics adapted once on 16 chains and tiled —
    chains are exchangeable).  Reports ESS/sec/chip and leapfrog throughput
    at each point, the plateau, and MEASURED GFLOP/s: XLA's cost analysis of
    one batched log-prob gradient (the cost model counts a scan body ONCE,
    so analyzing the full scanned program undercounts by the trip count)
    times the known gradient-evaluation count — an XLA-counted cross-check
    of the 8·m·K hand model.

    Estimator hygiene: the timed dispatch starts
    from the WARM dispatch's final states — the warm run doubles as an
    untimed decorrelation segment, so the 256-chain ESS subset no longer
    contains replicas of the 16 adapted states — and n_samp is fixed at 256
    across the whole sweep.  ESS at C > 256 chains is computed on a
    256-chain subset and scaled by C/256 (chains are iid: same kernel,
    independent keys; the estimator note rides in the JSON as
    ``ess_estimator``).  The GPC posterior carries the proper lognormal
    t-prior (models/latent.py).
    """
    from flgp_tpu.datasets import torus_rings_r
    from flgp_tpu.fit.spectral import build_spectrum
    from flgp_tpu.inference.diagnostics import ess
    from flgp_tpu.inference.hmc import run_hmc, run_hmc_fixed
    from flgp_tpu.models.latent import GpcLogPost, make_whitened

    tor = torus_rings_r()
    m = tor.x_train.shape[0]
    Y = jnp.asarray(tor.y_train, jnp.float32)
    N1 = jnp.ones((m,), jnp.float32)
    X_all = jnp.concatenate(
        [jnp.asarray(tor.x_train, jnp.float32), jnp.asarray(tor.x_test, jnp.float32)]
    )
    n_leap = 16
    out = {
        "ess_estimator": (
            "min-ESS over a 256-chain subset x C/256 (iid chains); timed "
            "dispatch starts from the warm dispatch's final states "
            "(decorrelated); n_samp=256 at every sweep point"
        )
    }
    best_ess_rate, best_cfg = 0.0, None

    for K in (100, 256):
        if K == 100:
            eig = torus_eig
        else:
            gK = GraphConfig(s=600, r=3, K=256)
            eig = jax.jit(lambda k: build_spectrum(k, X_all, gK)[0])(jax.random.PRNGKey(42))
        gp = make_whitened(eig, jnp.arange(m), K, 1e-3)
        logpost = GpcLogPost(gp, Y, N1, 1e-2, 10.0, 2.0)

        _mark(f"saturation: adapt K={K}")
        x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (16, K + 1), jnp.float32)
        adapt = jax.jit(
            lambda k, x: run_hmc(k, logpost, x, n_warmup=256, n_samples=64, n_leapfrog=n_leap)
        )
        arun = adapt(jax.random.PRNGKey(2), x0)
        jax.block_until_ready(arun.samples)

        for C in (16, 64, 256, 1024, 4096, 16384):
            reps = C // 16
            stepC = jnp.tile(arun.step, reps)
            imC = jnp.tile(arun.inv_mass, (reps, 1))
            x0C = jnp.tile(arun.samples[-1], (reps, 1))
            n_samp = 256
            _mark(f"saturation: K={K} C={C}")
            fit = jax.jit(
                lambda k, x, s=stepC, im=imC, ns=n_samp: run_hmc_fixed(
                    k, logpost, x, s, im, n_samples=ns, n_leapfrog=n_leap
                )
            )
            compiled = fit.lower(jax.random.PRNGKey(3), x0C).compile()
            warm = compiled(jax.random.PRNGKey(3), x0C)
            # the warm dispatch doubles as the decorrelation segment: its
            # final states seed the timed run
            x1C = jax.block_until_ready(warm.samples[-1])
            del warm
            with report.stage(f"sat_hmc_K{K}_C{C}") as slot:
                t0 = time.perf_counter()
                run = jax.block_until_ready(compiled(jax.random.PRNGKey(4), x1C))
                dt = time.perf_counter() - t0
                slot["wall"] = dt
            steps = C * n_samp * n_leap
            sub = min(C, 256)
            es = ess(np.asarray(run.samples[:, :sub], np.float64))
            del run
            ess_total = float(np.min(es)) * (C / sub)
            out[f"sat_hmc_K{K}_C{C}_leap_steps_per_sec"] = steps / dt
            out[f"sat_hmc_K{K}_C{C}_min_ess_per_sec"] = ess_total / dt
            grad_fn = jax.jit(jax.vmap(jax.value_and_grad(logpost)))
            grad_flops = grad_fn.lower(x0C).compile().cost_analysis().get("flops", 0.0)
            out[f"sat_hmc_K{K}_C{C}_xla_grad_gflops"] = grad_flops * n_samp * n_leap / dt / 1e9
            if np.isfinite(ess_total) and ess_total / dt > best_ess_rate:
                best_ess_rate = ess_total / dt
                best_cfg = (K, C)

    out["gpc_ess_per_sec_per_chip_saturated"] = best_ess_rate
    if best_cfg is not None:
        out["gpc_saturation_K"] = best_cfg[0]
        out["gpc_saturation_chains"] = best_cfg[1]

    # NUTS-fixed sweep at K=100.  Batched NUTS terminates trees in lockstep
    # (a vmapped while_loop runs every chain to the slowest chain's depth),
    # so unlike HMC its ESS/sec DEGRADES at wide batch — wide-batch sampling
    # wants fixed-shape trajectories (HMC, or adaptively: ChEES).  The sweep
    # runs through run_nuts_fixed_chunked, which splits the draws over
    # dispatches whose worst-case wall is bounded.
    from flgp_tpu.inference.nuts import run_nuts, run_nuts_fixed_chunked

    K = 100
    gp = make_whitened(torus_eig, jnp.arange(m), K, 1e-3)
    logpost = GpcLogPost(gp, Y, N1, 1e-2, 10.0, 2.0)
    _mark("saturation: NUTS adapt")
    x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(11), (16, K + 1), jnp.float32)
    nadapt = jax.jit(lambda k, x: run_nuts(k, logpost, x, n_warmup=256, n_samples=64, max_depth=8))
    nrun = nadapt(jax.random.PRNGKey(12), x0)
    jax.block_until_ready(nrun.samples)
    best_nuts = 0.0
    for C in (256, 1024, 4096, 16384):
        reps = C // 16
        stepC = jnp.tile(nrun.step, reps)
        imC = jnp.tile(nrun.inv_mass, (reps, 1))
        x0C = jnp.tile(nrun.samples[-1], (reps, 1))
        n_samp = 256
        _mark(f"saturation: NUTS C={C} (chunked dispatches)")
        with report.stage(f"sat_nuts_K{K}_C{C}") as slot:
            t0 = time.perf_counter()
            run = run_nuts_fixed_chunked(
                jax.random.PRNGKey(14), logpost, x0C, stepC, imC,
                n_samples=n_samp, max_depth=8, max_dispatch_seconds=20.0,
            )
            jax.block_until_ready(run)
            dt = time.perf_counter() - t0
            slot["wall"] = dt
        sub = min(C, 256)
        es = ess(np.asarray(run.samples[:, :sub], np.float64))
        grads = float(jnp.sum(run.n_leapfrog))
        del run
        ess_total = float(np.min(es)) * (C / sub)
        out[f"sat_nuts_K{K}_C{C}_min_ess_per_sec"] = ess_total / dt
        out[f"sat_nuts_K{K}_C{C}_ess_per_grad"] = ess_total / grads
        if np.isfinite(ess_total):
            best_nuts = max(best_nuts, ess_total / dt)
    out["gpc_nuts_ess_per_sec_per_chip_saturated"] = best_nuts
    return out


def bench_sampling_chees(report: MetricsReport, torus_eig):
    """ChEES-HMC — ADAPTIVE trajectory lengths at fixed batch shape — on
    the torus GPC posterior.

    Closes the HMC/NUTS wide-batch split: vmapped NUTS collapses past ~1024
    chains (lockstep tree doubling), fixed HMC leaves trajectory quality on
    the table.  ChEES adapts (ε, τ, M⁻¹) from CROSS-chain statistics during
    one moderate-batch warmup, then the frozen triple drives any chain
    count with one batch-uniform jittered trajectory per iteration.

    Reported: saturated min-ESS/s at C ∈ {1024, 16384}, the TF32 variant
    (logpost_with_precision DEFAULT: on the GPU an f32 matmul at DEFAULT
    precision runs on the tensor cores in TF32) with statistical gates
    against the f32 run, and the narrow-batch sanity gate:
    ESS-per-gradient at C=16 vs NUTS on the same posterior.
    """
    from flgp_tpu.datasets import torus_rings_r
    from flgp_tpu.inference.chees import run_chees, run_chees_fixed
    from flgp_tpu.inference.diagnostics import ess
    from flgp_tpu.inference.nuts import run_nuts, run_nuts_fixed_chunked
    from flgp_tpu.models.latent import GpcLogPost, logpost_with_precision, make_whitened

    tor = torus_rings_r()
    K = 100
    m = tor.x_train.shape[0]
    gp = make_whitened(torus_eig, jnp.arange(m), K, 1e-3)
    logpost = GpcLogPost(
        gp, jnp.asarray(tor.y_train, jnp.float32), jnp.ones((m,), jnp.float32),
        1e-2, 10.0, 2.0,
    )
    out = {}

    _mark("chees: cross-chain adapt (C=128)")
    C0 = 128
    x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (C0, K + 1), jnp.float32)
    adapt = jax.jit(
        lambda k, x: run_chees(k, logpost, x, n_warmup=512, n_samples=64, max_steps=256)
    )
    with report.stage("chees_adapt") as slot:
        t0 = time.perf_counter()
        arun = adapt(jax.random.PRNGKey(2), x0)
        jax.block_until_ready(arun.samples)
        slot["wall"] = time.perf_counter() - t0
    out["chees_step"] = float(arun.step)
    out["chees_traj_len"] = float(arun.traj_len)
    out["chees_adapt_accept"] = float(jnp.mean(arun.accept_prob))

    n_samp = 256
    variants = {
        "f32": logpost,
        "tf32": logpost_with_precision(logpost, jax.lax.Precision.DEFAULT),
    }
    stats = {}
    for C in (1024, 16384):
        for vname, lp in variants.items():
            if C != 16384 and vname == "tf32":
                continue
            reps = C // C0
            x0C = jnp.tile(arun.samples[-1], (reps, 1))
            _mark(f"chees: C={C} {vname}")
            fit = jax.jit(
                lambda k, x, lp=lp: run_chees_fixed(
                    k, lp, x, arun.step, arun.traj_len, arun.inv_mass,
                    n_samples=n_samp, max_steps=256,
                )
            )
            compiled = fit.lower(jax.random.PRNGKey(3), x0C).compile()
            warm = compiled(jax.random.PRNGKey(3), x0C)
            x1C = jax.block_until_ready(warm.samples[-1])
            del warm
            with report.stage(f"sat_chees_C{C}_{vname}") as slot:
                t0 = time.perf_counter()
                run = jax.block_until_ready(compiled(jax.random.PRNGKey(4), x1C))
                dt = time.perf_counter() - t0
                slot["wall"] = dt
            sub = min(C, 256)
            S = np.asarray(run.samples[:, :sub], np.float64)
            nleap = int(run.n_leapfrog_total)
            del run
            es = ess(S)
            ess_total = float(np.min(es)) * (C / sub)
            key = f"sat_chees_C{C}" + ("" if vname == "f32" else f"_{vname}")
            out[f"{key}_min_ess_per_sec"] = ess_total / dt
            out[f"{key}_leap_per_draw"] = nleap / n_samp
            out[f"{key}_leap_steps_per_sec"] = C * nleap / dt
            stats[(C, vname)] = dict(
                mean=S.reshape(-1, K + 1).mean(0), sd=S.reshape(-1, K + 1).std(0),
                rate=ess_total / dt, wall=dt,
            )
    out["gpc_chees_ess_per_sec_per_chip_saturated"] = stats[(16384, "f32")]["rate"]
    f32s, t32s = stats[(16384, "f32")], stats[(16384, "tf32")]
    # gates: sd ratio within 5%, mean shift within 0.1 posterior sd — two
    # independent finite runs of the SAME sampler differ at this order, and
    # the MC error at ~2M total ESS is far below it
    out["chees_tf32_sd_ratio_worst"] = float(np.max(np.abs(t32s["sd"] / f32s["sd"] - 1.0)))
    out["chees_tf32_mean_shift_sd_max"] = float(
        np.max(np.abs(t32s["mean"] - f32s["mean"]) / f32s["sd"])
    )
    out["chees_tf32_speedup"] = f32s["wall"] / t32s["wall"]

    # narrow-batch sanity gate: ESS-per-gradient at C=16 vs NUTS
    _mark("chees: C=16 ESS/grad vs NUTS")
    x16 = jnp.tile(arun.samples[-1][:16], (1, 1))
    cfit = jax.jit(
        lambda k, x: run_chees_fixed(
            k, logpost, x, arun.step, arun.traj_len, arun.inv_mass,
            n_samples=512, max_steps=256,
        )
    )
    crun = cfit(jax.random.PRNGKey(7), x16)
    jax.block_until_ready(crun.samples)
    ces = ess(np.asarray(crun.samples, np.float64))
    chees_epg = float(np.min(ces)) / (int(crun.n_leapfrog_total) * 16)
    out["chees_c16_ess_per_grad"] = chees_epg

    nadapt = jax.jit(
        lambda k, x: run_nuts(k, logpost, x, n_warmup=256, n_samples=32, max_depth=8)
    )
    nrun = nadapt(jax.random.PRNGKey(8), x16)
    jax.block_until_ready(nrun.samples)
    nfix = run_nuts_fixed_chunked(
        jax.random.PRNGKey(9), logpost, nrun.samples[-1], nrun.step, nrun.inv_mass,
        n_samples=512, max_depth=8, max_dispatch_seconds=20.0,
    )
    nes = ess(np.asarray(nfix.samples, np.float64))
    nuts_epg = float(np.min(nes)) / float(jnp.sum(nfix.n_leapfrog))
    out["nuts_c16_ess_per_grad"] = nuts_epg
    out["chees_vs_nuts_ess_per_grad_ratio"] = chees_epg / max(nuts_epg, 1e-12)
    return out


def bench_svi(report: MetricsReport, torus_eig):
    """SVI as a measured capability (BASELINE: "stochastic VI"): mean-field
    fit of the torus GPC posterior with ELBO, wall-clock, and posterior-
    moment error against NUTS reference draws on the same posterior."""
    from flgp_tpu.datasets import torus_rings_r
    from flgp_tpu.inference.nuts import run_nuts
    from flgp_tpu.inference.svi import fit_svi
    from flgp_tpu.models.latent import GpcLogPost, make_whitened

    tor = torus_rings_r()
    K = 100
    m = tor.x_train.shape[0]
    gp = make_whitened(torus_eig, jnp.arange(m), K, 1e-3)
    logpost = GpcLogPost(
        gp, jnp.asarray(tor.y_train, jnp.float32), jnp.ones((m,), jnp.float32),
        1e-2, 10.0, 2.0,
    )
    dim = K + 1
    out = {}

    _mark("svi: mean-field fit")
    # 8000 steps: log_t must travel ~8 units from its zero init; at 2000
    # steps it lands mid-transit (measured 17-sd mean error on log_t, vs
    # 0.16-sd max across all 101 coords when converged)
    svi = jax.jit(lambda k: fit_svi(k, logpost, dim, steps=8000, n_mc=8, lr=0.02))
    jax.block_until_ready(svi(jax.random.PRNGKey(20)).elbo_trace)
    with report.stage("svi_fit") as slot:
        t0 = time.perf_counter()
        sres = svi(jax.random.PRNGKey(21))
        jax.block_until_ready(sres.elbo_trace)
        svi_s = time.perf_counter() - t0
        slot["wall"] = svi_s
    out["svi_fit_s"] = svi_s
    out["svi_elbo_final"] = float(jnp.mean(sres.elbo_trace[-50:]))

    _mark("svi: NUTS reference moments")
    x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(22), (16, dim), jnp.float32)
    nuts = jax.jit(lambda k, x: run_nuts(k, logpost, x, n_warmup=256, n_samples=512, max_depth=8))
    jax.block_until_ready(nuts(jax.random.PRNGKey(23), x0).samples)
    t0 = time.perf_counter()
    nref = nuts(jax.random.PRNGKey(24), x0)
    jax.block_until_ready(nref.samples)
    nuts_s = time.perf_counter() - t0
    S = np.asarray(nref.samples, np.float64).reshape(-1, dim)
    mu_ref, sd_ref = S.mean(0), S.std(0)
    mu_q = np.asarray(sres.posterior.mu, np.float64)
    sd_q = np.exp(np.asarray(sres.posterior.log_scale, np.float64))
    out["svi_mean_err_sd_units_max"] = float(np.max(np.abs(mu_q - mu_ref) / sd_ref))
    out["svi_mean_err_sd_units_avg"] = float(np.mean(np.abs(mu_q - mu_ref) / sd_ref))
    out["svi_sd_ratio_median"] = float(np.median(sd_q / sd_ref))
    out["svi_speedup_vs_nuts_wall"] = nuts_s / svi_s

    # low-rank-plus-diag family (rank 5): the upgrade tier for correlated
    # posteriors the mean-field family zeroes (inference/svi.py docstring)
    from flgp_tpu.inference.svi import fit_svi_lowrank

    _mark("svi: low-rank fit")
    # 16k steps (vs mean-field's 8k): the factor adds dim·rank parameters
    # whose gradient signal is weak on this near-independent posterior, and
    # at 8k steps the mean was still in transit (measured 1.28 sd max err)
    svi_lr = jax.jit(
        lambda k: fit_svi_lowrank(k, logpost, dim, rank=5, steps=16000, n_mc=8, lr=0.02)
    )
    jax.block_until_ready(svi_lr(jax.random.PRNGKey(25)).elbo_trace)
    with report.stage("svi_lowrank_fit") as slot:
        t0 = time.perf_counter()
        lres = svi_lr(jax.random.PRNGKey(26))
        jax.block_until_ready(lres.elbo_trace)
        svi_lr_s = time.perf_counter() - t0
        slot["wall"] = svi_lr_s
    out["svi_lowrank_fit_s"] = svi_lr_s
    out["svi_lowrank_elbo_final"] = float(jnp.mean(lres.elbo_trace[-50:]))
    out["svi_lowrank_elbo_gain_vs_meanfield"] = (
        out["svi_lowrank_elbo_final"] - out["svi_elbo_final"]
    )
    mu_l = np.asarray(lres.posterior.mu, np.float64)
    sd_l = np.sqrt(np.asarray(jnp.diagonal(lres.posterior.covariance()), np.float64))
    out["svi_lowrank_mean_err_sd_units_max"] = float(np.max(np.abs(mu_l - mu_ref) / sd_ref))
    out["svi_lowrank_sd_ratio_median"] = float(np.median(sd_l / sd_ref))
    return out


def bench_multiclass_smc(report: MetricsReport):
    """BASELINE config 3: fit_lae_logit_mult at n=7e4 + SMC over per-class t."""
    from flgp_tpu.fit.multiclass import one_hot_labels
    from flgp_tpu.fit.spectral import build_spectrum
    from flgp_tpu.inference.hyperparam import mult_t_posterior

    ds = digits_large(n=70_000, m_train=500)
    key = jax.random.PRNGKey(0)
    cfg = FitConfig(graph=GraphConfig(s=600, r=3, K=100), sigma=1e-3, n_gibbs=50, gibbs_avg_sweeps=25)
    out = {
        "mult_data_provenance": (
            "sklearn load_digits (1797 real 8x8 images) replicated to n=7e4 "
            "via random sub-pixel bilinear shifts (<=1px) + N(0,0.02) pixel noise"
        )
    }

    _mark("multiclass: fit n=7e4 (compile)")
    with report.stage("mult_mnist_fit"):
        res, dt = _timed(
            lambda k: flgp_tpu.fit_lae_logit_mult_gp(k, ds.x_train, ds.y_train, ds.x_test, cfg=cfg),
            key,
        )
    out["mult_n7e4_fit_s"] = dt
    out["mult_n7e4_err"] = float(np.mean(res.y_test != ds.y_test))

    _mark("multiclass: SMC over per-class t (VALIDATED 64/5 budget, chunked)")
    X_all = jnp.concatenate(
        [jnp.asarray(ds.x_train, jnp.float32), jnp.asarray(ds.x_test, jnp.float32)]
    )
    eig, _ = build_spectrum(key, X_all, cfg.graph)
    aug_y = one_hot_labels(jnp.asarray(ds.y_train, jnp.float32), 10)
    idx = jnp.arange(ds.x_train.shape[0])
    # The 64-particle/5-mutation budget the CPU test validates at ≤1 sd;
    # the tempering ladder runs as host dispatches of ≤2 stages each
    # (run_smc_chunked — the tiny SMC state carries over).  Not jitted at
    # this level: the host loop owns re-dispatch.
    def run_smc_budget(k):
        return mult_t_posterior(
            k, eig, aug_y, idx, 100, 1e-3,
            n_particles=64, n_mutation_steps=5, newton_max_iter=25,
            stages_per_dispatch=2,
        )

    jax.block_until_ready(run_smc_budget(jax.random.PRNGKey(6)).t_mean)
    with report.stage("mult_smc"):
        t0 = time.perf_counter()
        post = run_smc_budget(jax.random.PRNGKey(7))
        jax.block_until_ready(post.t_mean)
        smc_s = time.perf_counter() - t0
    out["mult_smc_s"] = smc_s
    out["mult_smc_budget"] = "64 particles / 5 mutations, <=2 stages per dispatch"
    out["mult_smc_n_stages"] = int(post.smc.n_stages)
    out["mult_smc_t_mean"] = float(jnp.mean(post.t_mean))
    out["mult_smc_t_sd"] = float(jnp.mean(post.t_sd))

    # statistical validation: the target is 1-D per class, so quadrature
    # over log t is exact ground truth for the SMC moments (two-pass
    # refined grid — inference.hyperparam.mult_t_quadrature).
    _mark("multiclass: t-posterior quadrature check")
    from flgp_tpu.inference.hyperparam import mult_t_quadrature

    quad = jax.jit(
        lambda: mult_t_quadrature(eig, aug_y, idx, 100, 1e-3, newton_max_iter=25)
    )()
    jax.block_until_ready(quad.t_mean)
    qerr = jnp.abs(post.t_mean - quad.t_mean) / quad.t_sd
    out["mult_t_quad_coarse_max_weight"] = float(quad.coarse_max_weight)
    out["mult_t_quad_mean"] = float(jnp.mean(quad.t_mean))
    out["mult_smc_t_mean_quad_err"] = float(jnp.mean(qerr))
    out["mult_smc_t_mean_quad_err_max"] = float(jnp.max(qerr))
    return out


def bench_ablation_nuts(report: MetricsReport):
    """BASELINE config 4: n=1e5 kernel ablation (LAE/SE/Nyström) with NUTS
    over (u, t, noise), 16 chains on the device."""
    import dataclasses

    from flgp_tpu.config import KernelType
    from flgp_tpu.fit.spectral import build_spectrum, nystrom_anchor_eigs, nystrom_extend, nystrom_setup
    from flgp_tpu.inference.diagnostics import ess
    from flgp_tpu.inference.nuts import run_nuts
    from flgp_tpu.models.latent import GprLogPost, make_whitened

    ds = spiral(n=100_000, m_train=1000, seed=7)
    X_all = jnp.concatenate(
        [jnp.asarray(ds.x_train, jnp.float32), jnp.asarray(ds.x_test, jnp.float32)]
    )
    m = ds.x_train.shape[0]
    Y = jnp.asarray(ds.y_train, jnp.float32)
    g = GraphConfig(s=1024, r=3, K=128)
    K = 128
    key = jax.random.PRNGKey(0)
    out = {}

    def spectrum_for(kernel: str):
        if kernel == "nystrom":
            # rcond clamps the extension's 1/λ at near-null anchor
            # eigenvalues (fit/spectral.py:nystrom_extend): without it the
            # posterior's adapted-metric Hessian condition is ~3e16 and NUTS
            # mixes ~40× worse than LAE/SE
            out["ablation_nystrom_rcond"] = 1e-3

            @jax.jit
            def build(k):
                basis = nystrom_setup(k, X_all, g)
                anchor, Z_UU = nystrom_anchor_eigs(basis, jnp.float32(1.0), K)
                return nystrom_extend(
                    anchor, Z_UU, basis.dist_allU, jnp.float32(1.0),
                    basis.dist_mean, True, rcond=1e-3,
                )
            return build
        gk = dataclasses.replace(g, kernel=KernelType(kernel))

        @jax.jit
        def build(k):
            eig, _ = build_spectrum(k, X_all, gk)
            return eig
        return build

    n_chains, n_samp = 16, 256
    for kernel in ("lae", "se", "nystrom"):
        _mark(f"ablation: {kernel} spectrum + NUTS")
        build = spectrum_for(kernel)
        jax.block_until_ready(build(jax.random.PRNGKey(50)).values)
        with report.stage(f"ablation_{kernel}_spectrum"):
            t0 = time.perf_counter()
            eig = build(key)
            jax.block_until_ready(eig.values)
            out[f"ablation_{kernel}_spectral_s"] = time.perf_counter() - t0

        gp = make_whitened(eig, jnp.arange(m), K, 1e-5)
        logpost = GprLogPost(gp, Y, 1.0, 10.0, 2.0, 0.1, 1e-3)
        x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (n_chains, K + 2), jnp.float32)
        nuts = jax.jit(lambda k, x: run_nuts(k, logpost, x, n_warmup=200, n_samples=n_samp, max_depth=7))
        jax.block_until_ready(nuts(jax.random.PRNGKey(2), x0).samples)
        with report.stage(f"ablation_{kernel}_nuts"):
            t0 = time.perf_counter()
            run = nuts(jax.random.PRNGKey(3), x0)
            jax.block_until_ready(run.samples)
            dt = time.perf_counter() - t0
        out[f"ablation_{kernel}_nuts_ess_per_sec"] = float(
            np.min(ess(np.asarray(run.samples[:, :, -2:], np.float64)))
        ) / dt
    return out


def bench_golden_f64_subprocess():
    """README-golden reproduction with the f64 solve tail + exact anchors
    (bench_golden_f64.py), run as a SUBPROCESS with JAX_ENABLE_X64=1 — x64
    must be set before JAX initializes and must not leak into the f32
    stages.  It has to finish before this process touches the GPU: a JAX
    process reserves most of the card's memory when it first uses it, so
    two processes on the card at once run out of memory."""
    from jax._src import xla_bridge

    assert not xla_bridge.backends_are_initialized(), (
        "golden_f64 must run before this process initializes a JAX backend"
    )
    _mark("golden_f64: subprocess (x64)")
    env = dict(os.environ)
    env["JAX_ENABLE_X64"] = "1"
    proc = subprocess.run(
        [sys.executable, os.path.join(_HERE, "bench_golden_f64.py")],
        capture_output=True, text=True, env=env, timeout=1500,
    )
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(f"golden_f64 subprocess produced no JSON: {proc.stderr[-400:]}")


def gpc_fit_fn(m: int, K: int = 128, s: int = 1024):
    """The n=1e6 binary GPC fit: minibatch-k-means anchors, LAE graph,
    empirical-Bayes t, and the O(n·K) low-rank predict tail at every point
    (fit/streaming._gpc_lowrank_tail — the dense (n, m) cross-covariance of
    src/Predict.cpp:11-26 never exists).  Returns a jitted
    (key, X_all, Y_train) → (labels at every point, t); a new jitted
    function per call, so a caller can trace it under a different LAE."""
    from flgp_tpu.config import Subsample
    from flgp_tpu.fit.drivers import _train_gpc
    from flgp_tpu.fit.spectral import build_spectrum
    from flgp_tpu.fit.streaming import _gpc_lowrank_tail

    cfg = FitConfig(
        graph=GraphConfig(s=s, r=3, K=K, subsample=Subsample.MINIBATCH_KMEANS),
        sigma=1e-3, n_gibbs=50, gibbs_avg_sweeps=25,
    )

    @jax.jit
    def fit(key, X_all, Y):
        N1 = jnp.ones((m,), X_all.dtype)
        idx = jnp.arange(m)
        k_spec, k_pg = jax.random.split(key)
        eig, _ = build_spectrum(k_spec, X_all, cfg.graph)
        res = _train_gpc(eig, Y, N1, idx, K, cfg)
        labels, _, _, _ = _gpc_lowrank_tail(k_pg, eig, Y, N1, idx, K, cfg, res.x, 1)
        return labels, res.x

    return fit


def torus_gpc_data(n: int = 1_000_000, m: int = 1000):
    """The six-ring torus GPC problem of the n=1e6 fit: the split, every
    point (train first) on the device, and the train labels."""
    from flgp_tpu.datasets import torus_rings

    ds = torus_rings(n=n, m_train=m, seed=3)
    X_all = jnp.asarray(np.concatenate([ds.x_train, ds.x_test]), jnp.float32)
    return ds, X_all, jnp.asarray(ds.y_train, jnp.float32)


def bench_spectral_1e6(report: MetricsReport):
    """North-star scale metric: full spectral stage (minibatch-kmeans
    subsampling included) at n=1e6, single device."""
    from flgp_tpu.config import EPS, LaplacianType, Subsample
    from flgp_tpu.ops.kmeans import subsample
    from flgp_tpu.ops.knn import knn
    from flgp_tpu.ops.lae import lae_weights
    from flgp_tpu.ops.laplacian import normalize_graph_laplacian
    from flgp_tpu.ops.spectrum import spectrum_fused
    from flgp_tpu.types import EllMatrix
    from flgp_tpu.utils.metrics import profiler_trace

    out = {}
    s_big, K_big = 1024, 128

    def graph_spectrum(X, U):
        res = knn(X, U, 3)
        w = lae_weights(X, U, res.indices)
        return spectrum_fused(w, res.indices, s_big, K_big, LaplacianType.NORMALIZED, True)

    n1, d1 = 1_000_000, 3
    X1 = jax.random.normal(jax.random.PRNGKey(7), (n1, d1), jnp.float32)

    @jax.jit
    def full_stage(X, k):
        sub = subsample(k, X, s_big, Subsample.MINIBATCH_KMEANS, 1, 50)
        return graph_spectrum(X, sub.centers)

    _mark("spectral1e6: compiling")
    jax.block_until_ready(full_stage(X1, jax.random.PRNGKey(3)))
    _mark("spectral1e6: timing")
    with profiler_trace(os.environ.get("FLGP_PROFILE_DIR")):
        with report.stage("spectral_n1e6"):
            t0 = time.perf_counter()
            jax.block_until_ready(full_stage(X1, jax.random.PRNGKey(3)))
            dt6 = time.perf_counter() - t0
            out["spectral_stage_n1e6_s"] = dt6

    # per-substage breakdown (separately jitted, so the sum carries a little
    # extra dispatch + device-memory round-trip vs the fused stage):
    # subsampler vs graph assembly (kNN+LAE+normalize+Gram) vs the eigh
    sub_fn = jax.jit(lambda X, k: subsample(k, X, s_big, Subsample.MINIBATCH_KMEANS, 1, 50))

    def graph_parts(X, U):
        res = knn(X, U, 3)
        w = lae_weights(X, U, res.indices)
        Z = normalize_graph_laplacian(
            EllMatrix(w, res.indices, s_big), LaplacianType.NORMALIZED
        )
        return Z.scale_cols(1.0 / jnp.sqrt(jnp.abs(Z.colsum()) + EPS)).gram()

    gram_fn = jax.jit(graph_parts)
    eigh_fn = jax.jit(jnp.linalg.eigh)
    sub6, out["spectral_n1e6_subsample_s"] = _timed(lambda k: sub_fn(X1, k), jax.random.PRNGKey(4))
    G6, out["spectral_n1e6_graph_s"] = _timed(lambda _: gram_fn(X1, sub6.centers), None)
    _, out["spectral_n1e6_eigh_s"] = _timed(lambda _: eigh_fn(G6)[0], None)
    # the fused stage additionally contains the eigenvector back-extension
    # U = A·V·Σ⁻¹ (the 512 MB (n, K) write) which this three-way split does
    # not time separately — surface the remainder explicitly instead of
    # letting it read as dispatch overhead
    out["spectral_n1e6_extension_plus_dispatch_s"] = max(
        dt6
        - out["spectral_n1e6_subsample_s"]
        - out["spectral_n1e6_graph_s"]
        - out["spectral_n1e6_eigh_s"],
        0.0,
    )

    # analytic cost model for the stage (dominant terms): distance matmul,
    # LAE G/b assembly + FISTA, ELL gram/matmat, eigh
    r_ = 3
    flops = (
        2 * n1 * s_big * d1                       # kNN distances
        + 2 * n1 * r_ * r_ * d1 + 2 * n1 * r_ * d1  # LAE Gram + b
        + 150 * n1 * (2 * r_ * r_ + 10 * r_)      # FISTA iterations
        + 2 * n1 * r_ * s_big                     # ELL gram scatter
        + 2 * n1 * r_ * K_big                     # A @ V
        + 10 * s_big ** 3                         # eigh
    )
    bytes_moved = 4 * n1 * (d1 + 2 * r_ + 2 * r_ + K_big)  # X, idx+vals (rw), V out
    out["spectral_n1e6_est_gflops"] = flops / dt6 / 1e9
    out["spectral_n1e6_est_gbps"] = bytes_moved / dt6 / 1e9
    return out


def bench_scale_accuracy(report: MetricsReport):
    """End-to-end binary GPC at n=1e6 WITH measured accuracy — six-ring
    torus at 1e6 points, 1000 labels (gpc_fit_fn) — and the same fit at
    n=1e7 through the chunked colmajor spectrum.  The reference cannot run
    this size at all (dense R vectors + one-thread kmeans callback)."""
    from flgp_tpu.config import Subsample
    from flgp_tpu.datasets import torus_rings
    from flgp_tpu.fit.drivers import _train_gpc
    from flgp_tpu.fit.streaming import _gpc_lowrank_tail
    from flgp_tpu.ops.colmajor import heat_kernel_spectrum_colmajor, kmeans_anchors_colmajor

    m = 1000
    ds, X_all, Y = torus_gpc_data(m=m)
    out = {}
    fit = gpc_fit_fn(m)
    _mark("scale_accuracy: n=1e6 GPC fit (compile)")
    jax.block_until_ready(fit(jax.random.PRNGKey(31), X_all, Y))
    _mark("scale_accuracy: timing")
    with report.stage("gpc_fit_n1e6"):
        t0 = time.perf_counter()
        labels, t_opt = jax.block_until_ready(fit(jax.random.PRNGKey(31), X_all, Y))
        out["gpc_fit_n1e6_s"] = time.perf_counter() - t0
    out["gpc_fit_n1e6_err"] = float(np.mean(np.asarray(labels[m:]) != np.asarray(ds.y_test)))
    out["gpc_fit_n1e6_t"] = float(t_opt)
    del labels

    # ---- n=1e7: colmajor spectrum + the same low-rank tail --------------
    n7 = 10_000_000
    ds7 = torus_rings(n=n7, m_train=m, seed=4)
    Xt7 = jnp.asarray(np.concatenate([ds7.x_train, ds7.x_test]).T.astype(np.float32))
    Y7 = jnp.asarray(ds7.y_train, jnp.float32)
    cfg = FitConfig(
        graph=GraphConfig(s=1024, r=3, K=128, subsample=Subsample.MINIBATCH_KMEANS),
        sigma=1e-3, n_gibbs=50, gibbs_avg_sweeps=25,
    )
    K = 128
    N1 = jnp.ones((m,), jnp.float32)

    # k-means anchors (k-means‖ + Lloyd on a 2^17 uniform column sample)
    # keep the reference's anchor semantics (src/Utils.cpp:37-56)
    @jax.jit
    def full_fit7(key):
        k_anc, k_pg = jax.random.split(key)
        anchors = kmeans_anchors_colmajor(k_anc, Xt7, cfg.graph.s, n_sample=1 << 17)
        eig = heat_kernel_spectrum_colmajor(Xt7, anchors, cfg.graph.r, K)
        res = _train_gpc(eig, Y7, N1, jnp.arange(m), K, cfg)
        labels, _, _, _ = _gpc_lowrank_tail(k_pg, eig, Y7, N1, jnp.arange(m), K, cfg, res.x, 1)
        return labels, res.x

    # the compile call draws its own anchors (another key): both errors
    # ride in the JSON so the anchor-draw spread is visible
    _mark("scale_accuracy: n=1e7 GPC fit (compile)")
    lab_w, _ = jax.block_until_ready(full_fit7(jax.random.PRNGKey(40)))
    out["gpc_fit_n1e7_err_second_anchor_draw"] = float(
        np.mean(np.asarray(lab_w[m:]) != np.asarray(ds7.y_test))
    )
    del lab_w
    _mark("scale_accuracy: n=1e7 timing")
    with report.stage("gpc_fit_n1e7"):
        t0 = time.perf_counter()
        lab7, t7 = jax.block_until_ready(full_fit7(jax.random.PRNGKey(41)))
        out["gpc_fit_n1e7_s"] = time.perf_counter() - t0
    out["gpc_fit_n1e7_err"] = float(np.mean(np.asarray(lab7[m:]) != np.asarray(ds7.y_test)))
    out["gpc_fit_n1e7_anchors"] = "kmeans|| on 131072-point uniform subsample"
    out["gpc_fit_n1e7_t"] = float(t7)
    return out


def bench_spectral_1e7(report: MetricsReport):
    """n=1e7 graph+spectrum, single device, through the chunked colmajor
    pipeline (peak device memory is the (n, K) eigenvector output plus
    O(chunk) intermediates).  Cold first dispatch and the median of three
    warm dispatches."""
    from flgp_tpu.config import LaplacianType
    from flgp_tpu.ops.colmajor import heat_kernel_spectrum_colmajor

    out = {}
    s_big, K_big = 1024, 128
    n2, d1 = 10_000_000, 3
    Xt2 = jax.random.normal(jax.random.PRNGKey(8), (d1, n2), jnp.float32)
    U2 = Xt2[:, :: n2 // s_big][:, :s_big].T
    stage7 = jax.jit(
        lambda Xt, U: heat_kernel_spectrum_colmajor(Xt, U, 3, K_big, LaplacianType.NORMALIZED, True)
    )
    _mark("spectral1e7: AOT compiling")
    compiled = stage7.lower(Xt2, U2).compile()
    _mark("spectral1e7: cold dispatch")
    t0 = time.perf_counter()
    jax.block_until_ready(compiled(Xt2, U2))
    out["spectral_stage_n1e7_cold_s"] = time.perf_counter() - t0
    times = []
    with report.stage("spectral_n1e7"):
        for i in range(3):
            _mark(f"spectral1e7: warm dispatch {i}")
            t0 = time.perf_counter()
            jax.block_until_ready(compiled(Xt2, U2))
            times.append(time.perf_counter() - t0)
    out["spectral_stage_n1e7_s"] = sorted(times)[1]
    return out


def bench_lobpcg_scale(report: MetricsReport):
    """The large-n GLGP selling point, measured: sparse kNN self-graph at
    n=1e5 (r=8), K=128 spectrum via blocked LOBPCG — the operator the
    reference hands to RSpectra::eigs_sym after densifying
    (src/Fit.cpp:388-448).  Residual norms ride along as the structured
    convergence signal."""
    from flgp_tpu.ops.knn import knn as _knn
    from flgp_tpu.ops.lobpcg import lobpcg_standard
    from flgp_tpu.ops.sparse_graph import glgp_operator, symmetrize_knn

    n, d, r_graph, K = 100_000, 3, 8, 128
    X = jax.random.normal(jax.random.PRNGKey(11), (n, d), jnp.float32)
    Xw = jax.random.normal(jax.random.PRNGKey(12), (n, d), jnp.float32)
    out = {}

    @jax.jit
    def spectrum(Xv, key):
        res = _knn(Xv, Xv, r_graph, block=2048)
        dmean = jnp.mean(res.sqdists)
        vals = jnp.exp(-res.sqdists / dmean)
        W, _ = glgp_operator(symmetrize_knn(res.indices, vals, n))
        X0 = jax.random.normal(key, (n, K), jnp.float32)
        lr = lobpcg_standard(W.matvec, X0, iters=60)
        return lr.eigenvalues, lr.residual_norms

    _mark("lobpcg: n=1e5 sparse GLGP spectrum")
    jax.block_until_ready(spectrum(Xw, jax.random.PRNGKey(21))[0])
    with report.stage("gl_lobpcg_n1e5"):
        t0 = time.perf_counter()
        vals_, resid = spectrum(X, jax.random.PRNGKey(22))
        jax.block_until_ready(vals_)
        out["gl_lobpcg_n1e5_s"] = time.perf_counter() - t0
    out["gl_lobpcg_n1e5_max_resid"] = float(np.max(np.asarray(resid)))
    return out


def bench_lae_kernel(report: MetricsReport):
    """The Pallas-Triton LAE kernel against the XLA scan (lae_weights_xla),
    alone at n=1e6 and end to end in the n=1e6 GPC fit, plus the kNN it
    feeds on: at n=1e6 and inside the n=1e7 colmajor chunk map.

    The end-to-end pair runs in the order XLA, kernel, kernel, XLA on the
    same data; the XLA variant traces the fit with fit.spectral's
    ``lae_weights`` replaced by ``lae_weights_xla``."""
    import contextlib
    from unittest import mock

    from flgp_tpu.config import KernelType
    from flgp_tpu.ops.colmajor import build_graph_colmajor
    from flgp_tpu.ops.knn import knn
    from flgp_tpu.ops.lae import lae_weights, lae_weights_xla

    out = {}
    n, d, s, r = 1_000_000, 3, 1024, 3
    X = jax.random.normal(jax.random.PRNGKey(0), (n, d), jnp.float32)
    U = X[:: n // s][:s]

    def median_ms(fn, *args, reps=5):
        jax.block_until_ready(fn(*args))
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts)) * 1e3

    _mark("lae_kernel: kNN at n=1e6 and in the n=1e7 chunk map")
    knn_fn = jax.jit(lambda a, b: knn(a, b, r).indices)
    out["knn_n1e6_ms"] = median_ms(knn_fn, X, U)
    idx = knn_fn(X, U)
    Xt7 = jax.random.normal(jax.random.PRNGKey(8), (d, 10_000_000), jnp.float32)
    # the SE build is the chunk map's kNN plus one exp per entry
    knn7_fn = jax.jit(
        lambda Xt, U: build_graph_colmajor(Xt, U, r, KernelType.SE, jnp.float32(1.0))
    )
    out["knn_colmajor_n1e7_ms"] = median_ms(knn7_fn, Xt7, Xt7[:, :s].T, reps=3)
    del Xt7

    _mark("lae_kernel: kernel alone")
    out["lae_n1e6_xla_ms"] = median_ms(jax.jit(lae_weights_xla), X, U, idx)
    out["lae_n1e6_kernel_ms"] = median_ms(jax.jit(lae_weights), X, U, idx)

    _mark("lae_kernel: n=1e6 GPC fit, XLA / kernel / kernel / XLA")
    m = 1000
    ds, X_all, Y = torus_gpc_data(m=m)
    walls = {"xla": [], "kernel": []}
    for variant in ("xla", "kernel", "kernel", "xla"):
        patch = (
            mock.patch("flgp_tpu.fit.spectral.lae_weights", lae_weights_xla)
            if variant == "xla" else contextlib.nullcontext()
        )
        with patch:
            fit = gpc_fit_fn(m)
            labels, _ = jax.block_until_ready(fit(jax.random.PRNGKey(31), X_all, Y))
        with report.stage(f"gpc_fit_n1e6_{variant}"):
            t0 = time.perf_counter()
            labels, _ = jax.block_until_ready(fit(jax.random.PRNGKey(31), X_all, Y))
            walls[variant].append(time.perf_counter() - t0)
        out[f"gpc_fit_n1e6_{variant}_err"] = float(
            np.mean(np.asarray(labels[m:]) != np.asarray(ds.y_test))
        )
    for variant, ws in walls.items():
        out[f"gpc_fit_n1e6_{variant}_s"] = ws
    out["gpc_fit_n1e6_kernel_speedup"] = float(np.mean(walls["xla"]) / np.mean(walls["kernel"]))
    return out


def _device_info():
    dev = jax.devices()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return dict(platform=dev[0].platform, kind=dev[0].device_kind, count=len(dev), nvidia_smi=smi)


def main():
    """Every stage is independently guarded: a failure records an entry in
    ``errors``, the final JSON still carries everything that succeeded, and
    the exit code is non-zero."""
    enable_compile_cache()
    report = MetricsReport()
    results = {}
    errors = {}

    def guarded(name, fn, *args):
        try:
            out = fn(*args)
            results.update(out or {})
            return out
        except Exception as e:  # noqa: BLE001 — keep the other stages' numbers
            import traceback

            errors[name] = f"{type(e).__name__}: {e}"[:500]
            _mark(f"STAGE FAILED {name}: {errors[name]}")
            traceback.print_exc(file=sys.stderr)
            return None

    # FIRST, before this process initializes JAX's backend: the x64 golden
    # subprocess needs the card to itself (see bench_golden_f64_subprocess)
    guarded("golden_f64", bench_golden_f64_subprocess)
    if jax.devices()[0].platform != "gpu":
        _mark(f"needs a GPU, JAX found {jax.devices()[0].platform}")
        sys.exit(2)
    device = _device_info()

    torus_res = None

    def goldens():
        nonlocal torus_res
        out, torus_res = bench_goldens(report)
        return out

    guarded("goldens", goldens)
    if torus_res is not None:
        guarded("sampling", bench_sampling, report, torus_res.eigenpair)
        guarded("sampling_saturation", bench_sampling_saturation, report, torus_res.eigenpair)
        guarded("sampling_chees", bench_sampling_chees, report, torus_res.eigenpair)
        guarded("svi", bench_svi, report, torus_res.eigenpair)
    guarded("multiclass_smc", bench_multiclass_smc, report)
    guarded("ablation_nuts", bench_ablation_nuts, report)
    guarded("lobpcg_scale", bench_lobpcg_scale, report)
    guarded("lae_kernel", bench_lae_kernel, report)
    guarded("spectral_1e6", bench_spectral_1e6, report)
    guarded("scale_accuracy", bench_scale_accuracy, report)
    # the n=1e7 stage runs last: if it exhausts device memory it can only
    # lose its own number
    guarded("spectral_1e7", bench_spectral_1e7, report)

    payload = {
        "metric": "torus_gpc_lae_fit_wall_clock",
        "value": round(results.pop("torus_fit_s"), 4) if "torus_fit_s" in results else None,
        "unit": "s",
        "vs_baseline": None,
        "device": device,
        "torus_err_baseline": BASELINE_TORUS_ERR,
        "spiral_rmse_baseline": BASELINE_SPIRAL_RMSE,
        "spiral_se_rmse_baseline": BASELINE_SPIRAL_SE_RMSE,
    }
    if payload["value"]:
        payload["vs_baseline"] = round(BASELINE_TORUS_LKFLGP_S / payload["value"], 2)
    payload.update(results)
    if errors:
        payload["errors"] = errors
    payload["stage_timings"] = json.loads(report.to_json())
    print(json.dumps(payload))
    sys.exit(1 if errors else 0)


if __name__ == "__main__":
    main()
