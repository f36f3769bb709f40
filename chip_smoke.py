"""Smoke run of the FLGP main path on one NVIDIA GPU, or on four.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded path only

One card, one process, in order:

1. device     — the first JAX device must be a GPU; there is no CPU fallback.
2. kernel     — the Pallas-Triton LAE kernel against the f32 and f64 XLA
                scans at n=1e6 (s=1024, 150 iterations; standard-normal
                r=3, d=3 and r=5, d=64, and the torus of the GPC fit):
                max |Δw|, simplex feasibility, downstream eigenvalues,
                both times.
3. parity     — fit_lae/se_logit_gp on the torus and fit_lae/se_regression_gp
                on the spiral with the reference's exact anchors, against the
                CPU-f64 goldens.
4. real_size  — the n=1e6 binary GPC fit (minibatch k-means anchors, s=1024,
                K=128, low-rank predict tail at every point).
5. sampler    — ChEES at 1,024 chains on the torus GPC posterior, started
                at the empirical-Bayes t of the parity fit.

Four cards: the n-sharded spectral stage at n=4e6, the sharded GPC Laplace
tail and chain-sharded ChEES at 4×1,024 chains started at the
empirical-Bayes t, each compared with the same computation on one card.

Each phase prints one JSON line.  A failed phase makes the exit code
non-zero; the last line, printed only when every phase passed, is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
KEY_SEED = 0
N_REAL = 1_000_000        # points in the kernel check and the GPC fit
N_FOUR = 4_000_000        # points in the four-card spectral stage
CHAINS = 1024             # ChEES chains per card


def _import_repo():
    """The package next to this script, or exit: a lone copy of the script
    must fail rather than pick up some other installation."""
    sys.path.insert(0, HERE)
    try:
        import flgp_tpu
    except ImportError as e:
        sys.exit(f"chip_smoke: the flgp_tpu package is not next to this script ({e})")
    if not os.path.abspath(flgp_tpu.__file__).startswith(HERE + os.sep):
        sys.exit(f"chip_smoke: flgp_tpu was imported from {flgp_tpu.__file__}, not {HERE}")
    return flgp_tpu


def _gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def _wall(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def _median_wall(fn, *args, reps: int = 5) -> float:
    import numpy as np

    _wall(fn, *args)
    return float(np.median([_wall(fn, *args)[1] for _ in range(reps)]))


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------


def phase_kernel(ctx):
    """Triton LAE kernel vs the XLA scans at n=1e6, s=1024, 150 iterations,
    in f32: standard-normal points with anchors taken from them (r=3, d=3
    and r=5, d=64), and the six-ring torus of the real-size fit with its
    minibatch k-means anchors (r=3, d=2).  Gates:

    - against the f64 XLA trajectory: the kernel's max |Δw| is at most
      twice the f32 XLA scan's own, plus 1e-6 — it rounds no worse than
      the path it replaces, whatever order either sums in;
    - against the f32 XLA scan, on the standard-normal cases: max |Δw|
      ≤ 1e-4;
    - rows sum to 1 ± 1e-5, no entry below −1e-7, and spectrum_fused
      eigenvalues agree with the XLA path's within rtol 1e-4."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from flgp_tpu import GraphConfig
    from flgp_tpu.config import LaplacianType, Subsample
    from flgp_tpu.ops.kmeans import subsample
    from flgp_tpu.ops.knn import knn
    from flgp_tpu.ops.lae import lae_weights, lae_weights_xla
    from flgp_tpu.ops.spectrum import spectrum_fused

    out, ok = {}, True
    n, s = N_REAL, 1024
    cases = {}
    for r, d in ((3, 3), (5, 64)):
        X = jax.random.normal(jax.random.PRNGKey(d), (n, d), jnp.float32)
        cases[f"r{r}_d{d}"] = (r, X, X[:: n // s][:s])
    g = GraphConfig(s=s, r=3, K=128, subsample=Subsample.MINIBATCH_KMEANS)
    X = ctx["X1e6"]
    U = subsample(jax.random.PRNGKey(30), X, g.s, g.subsample, g.nstart, g.kmeans_iters).centers
    cases["torus_r3_d2"] = (3, X, U)
    f_kernel = jax.jit(lae_weights)
    f_xla = jax.jit(lae_weights_xla)
    spec = jax.jit(
        lambda w, i: spectrum_fused(w, i, s, 128, LaplacianType.NORMALIZED, True).values
    )
    for tag, (r, X, U) in cases.items():
        idx = jax.jit(lambda a, b, r=r: knn(a, b, r).indices)(X, U)
        wk = f_kernel(X, U, idx)
        wx = f_xla(X, U, idx)
        with jax.enable_x64(True):
            w64 = np.asarray(jax.jit(lae_weights_xla)(
                X.astype(jnp.float64), U.astype(jnp.float64), idx
            ))
        dw = float(jnp.max(jnp.abs(wk - wx)))
        dk64 = float(np.max(np.abs(np.asarray(wk, np.float64) - w64)))
        dx64 = float(np.max(np.abs(np.asarray(wx, np.float64) - w64)))
        rows = float(jnp.max(jnp.abs(jnp.sum(wk, axis=1) - 1.0)))
        wmin = float(jnp.min(wk))
        ev_k, ev_x = np.asarray(spec(wk, idx)), np.asarray(spec(wx, idx))
        ev_rel = float(np.max(np.abs(ev_k - ev_x) / np.maximum(np.abs(ev_x), 1e-30)))
        out[tag] = dict(
            max_abs_dw=dw, kernel_vs_f64=dk64, xla_vs_f64=dx64,
            max_rowsum_err=rows, min_w=wmin, eig_max_rel_diff=ev_rel,
            kernel_ms=_median_wall(f_kernel, X, U, idx) * 1e3,
            xla_ms=_median_wall(f_xla, X, U, idx) * 1e3,
        )
        ok &= dk64 <= 2.0 * dx64 + 1e-6
        ok &= tag.startswith("torus") or dw <= 1e-4
        ok &= rows <= 1e-5 and wmin >= -1e-7 and ev_rel <= 1e-4
    return ok, out


def phase_parity(ctx):
    """README-golden fits on the reference's exact data (bench.py configs):
    torus test error ≤ 0.03; spiral RMSE within 0.005 of the CPU-f64 values
    (SE 0.50322, LAE 0.4529, tests/test_golden.py) on the exact anchors."""
    import jax
    import numpy as np

    import flgp_tpu
    from flgp_tpu import FitConfig, GraphConfig
    from flgp_tpu.datasets import spiral_r, spiral_r_anchors, torus_rings_r

    key = jax.random.PRNGKey(KEY_SEED)
    tor, sp, anchors = torus_rings_r(), spiral_r(), spiral_r_anchors()
    cfg_t = FitConfig(graph=GraphConfig(s=600, r=3, K=100), sigma=1e-3)
    cfg_s = FitConfig(graph=GraphConfig(s=500, r=3, K=100), sigma=1e-5)
    out, ok = {}, True
    for name, fit in (("lae", flgp_tpu.fit_lae_logit_gp), ("se", flgp_tpu.fit_se_logit_gp)):
        t0 = time.perf_counter()
        res = fit(key, tor.x_train, tor.y_train, tor.x_test, cfg=cfg_t)
        err = float(np.mean(res.y_test != tor.y_test))
        out[f"torus_{name}_err"] = err
        out[f"torus_{name}_first_call_s"] = time.perf_counter() - t0
        ok &= err <= 0.03
        if name == "lae":
            ctx["torus_eig"], ctx["torus_t"] = res.eigenpair, float(res.pars["t"])
    golden = {"se": 0.50322, "lae": 0.4529}
    for name, fit in (("lae", flgp_tpu.fit_lae_regression_gp), ("se", flgp_tpu.fit_se_regression_gp)):
        res = fit(key, sp.x_train, sp.y_train, sp.x_test, cfg_s, anchors=anchors[name])
        rmse = float(np.sqrt(np.mean((res.y_test - sp.y_test) ** 2)))
        out[f"spiral_{name}_rmse"] = rmse
        ok &= abs(rmse - golden[name]) <= 0.005
    return ok, out


def phase_real_size(ctx):
    """n=1e6 GPC fit: test error ≤ 0.01; cold (compile included) and warm
    wall."""
    import jax
    import numpy as np

    from bench import gpc_fit_fn

    ds, m = ctx["torus1e6"], ctx["m1e6"]
    fit = gpc_fit_fn(m)
    (labels, t), cold = _wall(fit, jax.random.PRNGKey(30), ctx["X1e6"], ctx["Y1e6"])
    (labels, t), warm = _wall(fit, jax.random.PRNGKey(31), ctx["X1e6"], ctx["Y1e6"])
    err = float(np.mean(np.asarray(labels[m:]) != ds.y_test))
    return err <= 0.01, dict(err=err, t=float(t), cold_s=cold, warm_s=warm)


def _torus_logpost(eig, K: int = 100):
    import jax.numpy as jnp

    from flgp_tpu.datasets import torus_rings_r
    from flgp_tpu.models.latent import GpcLogPost, make_whitened

    tor = torus_rings_r()
    m = tor.x_train.shape[0]
    gp = make_whitened(eig, jnp.arange(m), K, 1e-3)
    return GpcLogPost(
        gp, jnp.asarray(tor.y_train, jnp.float32), jnp.ones((m,), jnp.float32),
        1e-2, 10.0, 2.0,
    )


def phase_sampler(ctx):
    """ChEES at 1,024 chains on the torus GPC posterior, started where a
    user who has fitted first would start: log t at the parity fit's
    empirical-Bayes t, every coordinate jittered by 0.1·N(0, 1).  From
    log t = 0 instead, 2–8 of 1,024 chains sit where the shared step is
    never accepted and R̂ is a draw of which ones.  Gates: finite draws,
    split-R̂ of log t ≤ 1.05."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from flgp_tpu.inference.chees import run_chees
    from flgp_tpu.inference.diagnostics import split_rhat

    logpost = _torus_logpost(ctx["torus_eig"])
    C = CHAINS
    x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (C, logpost.dim), jnp.float32)
    x0 = x0.at[:, -1].add(np.log(ctx["torus_t"]))
    run_fn = jax.jit(lambda k, x: run_chees(k, logpost, x, n_warmup=400, n_samples=200))
    run, wall = _wall(run_fn, jax.random.PRNGKey(2), x0)
    finite = bool(jnp.all(jnp.isfinite(run.samples)))
    rhat = np.asarray(split_rhat(run.samples))
    chain_accept = np.asarray(jnp.mean(run.accept_prob, axis=0))
    return finite and rhat[-1] <= 1.05, dict(
        chains=C, t_eb=ctx["torus_t"], finite=finite, rhat_log_t=float(rhat[-1]),
        rhat_max=float(rhat.max()), first_call_s=wall,
        accept_mean=float(chain_accept.mean()), accept_min_chain=float(chain_accept.min()),
    )


def _torus_1e6(ctx):
    """The n=1e6 six-ring torus GPC problem of bench.py, on the device."""
    from bench import torus_gpc_data

    ds, X, Y = torus_gpc_data(N_REAL)
    ctx.update(torus1e6=ds, m1e6=Y.shape[0], X1e6=X, Y1e6=Y)


# ---------------------------------------------------------------------------
# four-card phase
# ---------------------------------------------------------------------------


def phase_four_cards(ctx):
    """Sharded spectral stage (n=4e6, s=1024, K=128), sharded GPC Laplace
    tail and chain-sharded ChEES (4×1,024 chains) on four cards, each
    against the same computation on one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding

    from flgp_tpu import GraphConfig
    from flgp_tpu.config import LaplacianType, Subsample
    from flgp_tpu.datasets import torus_rings
    from flgp_tpu.ops.kmeans import subsample
    from flgp_tpu.parallel.gpc import sharded_gpc_laplace_fn
    from flgp_tpu.parallel.mesh import make_mesh, replicate, shard_rows
    from flgp_tpu.parallel.spectral import sharded_spectrum_fn

    n_dev = len(jax.devices())
    if n_dev != 4:
        return False, dict(error=f"needs 4 devices, found {n_dev}")
    out, ok = {}, True
    n, m, s, K, sigma = N_FOUR, 1000, 1024, 128, 1e-3
    g = GraphConfig(s=s, r=3, K=K, gl=LaplacianType.NORMALIZED)
    ds = torus_rings(n=n, m_train=m, seed=5)
    X = np.concatenate([ds.x_train, ds.x_test]).astype(np.float32)
    Y = np.zeros(n, np.float32)
    Y[:m] = ds.y_train
    mask = np.zeros(n, np.float32)
    mask[:m] = 1.0
    dev0 = jax.devices()[0]
    mesh4 = make_mesh(4, ("data",))
    mesh1 = make_mesh(1, ("data",))

    anchors = jax.jit(lambda k, x: subsample(k, x, s, Subsample.MINIBATCH_KMEANS, 1, 50))(
        jax.random.PRNGKey(7), jax.device_put(X[:: max(1, n // (1 << 18))], dev0)
    ).centers
    counts = jnp.ones((s,), jnp.float32)

    def sharding_ok(a, spec_axis):
        sh = a.sharding
        return (
            isinstance(sh, NamedSharding) and len(sh.device_set) == 4
            and sh.spec[spec_axis] is not None and not sh.is_fully_replicated
        )

    # --- spectrum -------------------------------------------------------
    spec = {}
    for name, mesh in (("four", mesh4), ("one", mesh1)):
        fn = jax.jit(sharded_spectrum_fn(mesh, g))
        args = (shard_rows(mesh, jnp.asarray(X)), replicate(mesh, anchors), replicate(mesh, counts))
        (values, vectors), cold = _wall(fn, *args)
        _, warm = _wall(fn, *args)
        spec[name] = (values, vectors)
        out[f"spectrum_{name}_cold_s"], out[f"spectrum_{name}_warm_s"] = cold, warm
    ev4, ev1 = np.asarray(spec["four"][0]), np.asarray(spec["one"][0])
    out["eig_max_rel_diff"] = float(np.max(np.abs(ev4 - ev1) / np.abs(ev1)))
    out["vectors_sharded"] = sharding_ok(spec["four"][1], 0)
    ok &= out["eig_max_rel_diff"] <= 1e-4 and out["vectors_sharded"]

    # --- GPC Laplace tail ----------------------------------------------
    t = jnp.float32(2.0)
    labels = {}
    for name, mesh in (("four", mesh4), ("one", mesh1)):
        values, vectors = spec[name]
        fn = jax.jit(sharded_gpc_laplace_fn(mesh, K, sigma))
        res = fn(
            replicate(mesh, values), vectors, shard_rows(mesh, jnp.asarray(Y)),
            shard_rows(mesh, jnp.asarray(mask)), shard_rows(mesh, jnp.asarray(mask)),
            replicate(mesh, t),
        )
        labels[name] = res[3]
        if name == "four":
            out["labels_sharded"] = sharding_ok(res[3], 0)
    l4, l1 = np.asarray(labels["four"]), np.asarray(labels["one"])
    out["label_agreement"] = float(np.mean(l4 == l1))
    out["test_err_four"] = float(np.mean(l4[m:] != ds.y_test))
    ok &= out["label_agreement"] >= 0.999 and out["labels_sharded"]

    ok_chees, info = _four_chees(spec["one"], Y[:m], K, sigma, sharding_ok)
    out.update(info)
    return ok and ok_chees, out


def _four_chees(spectrum, y_train, K, sigma, sharding_ok):
    """Chain-sharded ChEES on four cards vs run_chees on one, 4×CHAINS
    chains each, 1,000 warmup and 500 sampling iterations, on the GPC
    posterior of the n=4e6 spectrum.  The chains start at the
    empirical-Bayes t of that spectrum, as a user who has fitted first
    would: from log t = 0, 15 posterior standard deviations below the bulk,
    a few of 4,096 chains never leave the start on one card or four.
    Gates: both runs converged (max split-R̂ over every chain and
    coordinate ≤ 1.05), pooled means within 4 Monte-Carlo standard errors,
    finite draws, samples sharded."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from flgp_tpu import FitConfig
    from flgp_tpu.fit.drivers import _train_gpc
    from flgp_tpu.inference.chees import run_chees
    from flgp_tpu.inference.diagnostics import split_rhat
    from flgp_tpu.models.latent import GpcLogPost, make_whitened
    from flgp_tpu.parallel.mcmc import pooled_mean_variance, sharded_chees_fn
    from flgp_tpu.parallel.mesh import make_mesh, shard_rows
    from flgp_tpu.types import EigenPair

    m = y_train.shape[0]
    eig, y, ones = EigenPair(*spectrum), jnp.asarray(y_train), jnp.ones((m,), jnp.float32)
    gp = make_whitened(eig, jnp.arange(m), K, sigma)
    logpost = GpcLogPost(gp, y, ones, 1e-2, 10.0, 2.0)
    cfg = FitConfig(sigma=sigma)
    t_eb = float(jax.jit(lambda e: _train_gpc(e, y, ones, jnp.arange(m), K, cfg).x)(eig))
    C = 4 * CHAINS
    keys = jax.random.split(jax.random.PRNGKey(11), C)
    x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(12), (C, logpost.dim), jnp.float32)
    x0 = x0.at[:, -1].add(np.log(t_eb))
    out, runs = {"chees_t_eb": t_eb}, {}
    chain4 = make_mesh(4, ("chain",))
    dev0 = jax.devices()[0]
    fn4 = jax.jit(sharded_chees_fn(chain4, logpost, n_warmup=1000, n_samples=500))
    runs["four"], out["chees_four_first_call_s"] = _wall(
        fn4, shard_rows(chain4, keys, "chain"), shard_rows(chain4, x0, "chain")
    )
    out["chees_samples_sharded"] = sharding_ok(runs["four"].samples, 1)
    fn1 = jax.jit(lambda k, x: run_chees(k, logpost, x, n_warmup=1000, n_samples=500))
    runs["one"], out["chees_one_first_call_s"] = _wall(
        fn1, jax.device_put(keys[0], dev0), jax.device_put(x0, dev0)
    )
    mean4, _ = pooled_mean_variance(chain4, runs["four"].samples)
    draws = {k: np.asarray(r.samples, np.float64) for k, r in runs.items()}
    mean1 = draws["one"].reshape(-1, logpost.dim).mean(0)

    # Monte-Carlo standard error of a pooled mean from the spread of the
    # per-chain means: after warmup the chains are independent, so this
    # needs no autocorrelation model
    def mcse(d):
        chain_means = d.mean(0)
        return chain_means.std(0, ddof=1) / np.sqrt(chain_means.shape[0])

    z = np.abs(np.asarray(mean4, np.float64) - mean1) / np.sqrt(
        mcse(draws["four"]) ** 2 + mcse(draws["one"]) ** 2
    )
    out["chees_max_mean_diff_in_mcse"] = float(np.max(z))
    out["chees_worst_coordinate"] = int(np.argmax(z))
    out["chees_log_t_diff_in_mcse"] = float(z[-1])
    for k, r in runs.items():
        rhat = np.asarray(split_rhat(r.samples))
        out[f"chees_{k}_max_rhat"] = float(rhat.max())
        out[f"chees_{k}_rhat_log_t"] = float(rhat[-1])
        out[f"chees_{k}_step"], out[f"chees_{k}_traj_len"] = float(r.step), float(r.traj_len)
        out[f"chees_{k}_accept"] = float(jnp.mean(r.accept_prob))
    out["chees_finite"] = bool(all(np.isfinite(d).all() for d in draws.values()))
    ok = (
        out["chees_four_max_rhat"] <= 1.05 and out["chees_one_max_rhat"] <= 1.05
        and out["chees_max_mean_diff_in_mcse"] <= 4.0
        and out["chees_finite"] and out["chees_samples_sharded"]
    )
    return ok, out


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four GPUs, against one card")
    args = ap.parse_args(argv)

    _import_repo()
    import jax

    from flgp_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devices[0].platform}", file=sys.stderr)
        return 1
    device = dict(platform=devices[0].platform, kind=devices[0].device_kind, count=len(devices))
    print(_gpu_name_and_power_limit(), flush=True)

    if args.four_cards:
        phases = [("four_cards", phase_four_cards)]
    else:
        phases = [
            ("setup", _torus_1e6),
            ("kernel", phase_kernel),
            ("parity", phase_parity),
            ("real_size", phase_real_size),
            ("sampler", phase_sampler),
        ]
    ctx, all_ok = {}, True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            res = fn(ctx)
            ok, info = res if isinstance(res, tuple) else (True, {})
        except Exception as e:  # noqa: BLE001 — report the phase and go on
            traceback.print_exc()
            ok, info = False, dict(error=f"{type(e).__name__}: {e}"[:600])
        all_ok &= bool(ok)
        line = dict(phase=name, ok=bool(ok), device=device["kind"],
                    wall_s=time.perf_counter() - t0, **info)
        print(json.dumps(line), flush=True)
        if name == "setup" and not ok:
            break
    if not all_ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
