"""Empirical-Bayes hyperparameter optimization, jit/vmap-native.

The reference drives NLopt from C++ — derivative-free COBYLA for the 1-D GPC
diffusion time (src/train.cpp:38-71) and gradient-based MMA with hand-derived
gradients for GPR (t, noise) (src/train.cpp:557-671).  Sequential host-side
optimizers serialize device work, so instead:

- 1-D objectives: a log-spaced grid evaluated in one vmap (perfectly parallel
  on device) followed by golden-section refinement of the bracketing cell.
- Multi-D objectives: coarse vmapped grid seeding + Adam in log-transformed
  (bound-respecting) coordinates on autodiff gradients, tracking the best
  iterate.

Both are pure functions of arrays, so an outer vmap over an SE bandwidth grid
runs *every* grid point's full optimization concurrently (replacing the serial
loop at src/Fit.cpp:147-178).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

_GR = 0.6180339887498949  # golden ratio conjugate


class Scalar1DResult(NamedTuple):
    x: jnp.ndarray
    obj: jnp.ndarray               # objective value at x (minimized)
    bracket_logwidth: jnp.ndarray  # final refinement bracket width in log-x
    n_expansions: jnp.ndarray      # window shifts taken (== max_expand → top-pinned)


def minimize_1d_log(
    fn: Callable[[jnp.ndarray], jnp.ndarray],
    lo: float = 1e-2,
    hi: float = 1e3,
    n_grid: int = 32,
    refine_rounds: int = 4,
    refine_width: int = 32,
    dtype=jnp.float32,
    max_expand: int = 4,
    coarse_fn: Callable[[jnp.ndarray], jnp.ndarray] | None = None,
) -> Scalar1DResult:
    """Minimize fn over [lo, hi]: log-spaced grid + vectorized refinement,
    UNBOUNDED ABOVE like the reference's COBYLA (ub=∞,
    src/train.cpp:45-58): whenever the optimum pins to the top of the scan
    window, the whole window shifts up by its own log-span (≤ ``max_expand``
    times), so [hi] is an initial guess, not a clamp.

    Both stages are batched: the coarse grid is one vmap, and each refinement
    round re-grids the bracketing cell with ``refine_width`` points in one
    vmap (a batched Newton solve for the GPC objective), shrinking the
    bracket by 2/(refine_width−1) per round.  Sequential depth is
    ``refine_rounds`` device steps, and wall-clock is rounds-dominated (the
    width axis rides the existing vmap for free) — so the default schedule
    is few-and-wide: 4 rounds × 32 points reach (2/31)^4 ≈ 1.7e-5 of a grid
    cell, tighter than the reference's COBYLA xtol 1e-4 (src/train.cpp:52-58)
    AND tighter than the previous 8×8 schedule at half its sequential depth
    (measured on the torus SE grid: 3.97 s → ~2.6 s for the 10-bandwidth
    trainer with a bit-identical selected optimum).

    ``coarse_fn`` (default: ``fn``) evaluates the coarse scan and window
    expansions; pass a cheaper surrogate when the exact objective has inner
    solves whose batched while_loop runs to the WORST lane's trip count —
    e.g. the GPC Laplace-Newton objective, where extreme-t grid lanes hit
    the 100-iteration cap and serialize ~500 Newton steps just to rank
    cells that lose by whole orders of magnitude.  Refinement and the
    returned objective always use the exact ``fn``."""
    lo_l = jnp.log(jnp.asarray(lo, dtype))
    hi_l = jnp.log(jnp.asarray(hi, dtype))
    g = lambda u: fn(jnp.exp(u))
    g_coarse = g if coarse_fn is None else (lambda u: coarse_fn(jnp.exp(u)))

    def scan_window(a_l, b_l):
        us = jnp.linspace(a_l, b_l, n_grid)
        fs = jax.vmap(g_coarse)(us)
        fs = jnp.where(jnp.isfinite(fs), fs, jnp.inf)
        return us, fs, jnp.argmin(fs)

    us, fs, i = scan_window(lo_l, hi_l)
    span = hi_l - lo_l

    def exp_cond(c):
        _, _, i, rounds = c
        return jnp.logical_and(i == n_grid - 1, rounds < max_expand)

    def exp_body(c):
        us, _, _, rounds = c
        us2, fs2, i2 = scan_window(us[-1], us[-1] + span)
        return us2, fs2, i2, rounds + 1

    us, fs, i, n_exp = jax.lax.while_loop(exp_cond, exp_body, (us, fs, i, jnp.int32(0)))
    if coarse_fn is not None:
        # belt-and-braces: a surrogate misranking of ≥2 coarse
        # cells is unrecoverable once the refinement bracket clips to the
        # wrong neighborhood — re-evaluate the EXACT objective on the top-3
        # surrogate cells (3 extra evals, one vmap) and bracket the winner
        _, top3 = jax.lax.top_k(-fs, 3)
        f_ex = jax.vmap(g)(us[top3])
        f_ex = jnp.where(jnp.isfinite(f_ex), f_ex, jnp.inf)
        i = top3[jnp.argmin(f_ex)]
    wa, wb = us[0], us[-1]
    a = us[jnp.maximum(i - 1, 0)]
    b = us[jnp.minimum(i + 1, n_grid - 1)]
    w = refine_width

    def round_body(carry, _):
        a, b, best_u, best_f = carry
        uu = jnp.linspace(a, b, w)
        ff = jax.vmap(g)(uu)
        ff = jnp.where(jnp.isfinite(ff), ff, jnp.inf)
        j = jnp.argmin(ff)
        improved = ff[j] < best_f
        best_u = jnp.where(improved, uu[j], best_u)
        best_f = jnp.where(improved, ff[j], best_f)
        h = (b - a) / (w - 1)
        a2 = jnp.clip(uu[j] - h, wa, wb)
        b2 = jnp.clip(uu[j] + h, wa, wb)
        return (a2, b2, best_u, best_f), None

    # with a surrogate coarse objective, its values must not seed the
    # best-so-far tracker (a non-converged inner solve can err in either
    # direction); the first exact refine round repopulates it
    f_init = fs[i] if coarse_fn is None else jnp.asarray(jnp.inf, dtype)
    (a, b, best_u, best_f), _ = jax.lax.scan(
        round_body, (a, b, us[i], f_init), None, length=refine_rounds
    )
    return Scalar1DResult(jnp.exp(best_u), best_f, b - a, n_exp)


class AdamResult(NamedTuple):
    x: jnp.ndarray
    obj: jnp.ndarray
    grad_norm: jnp.ndarray  # ‖∇fn‖ at the returned iterate (convergence status)


def adam_minimize(
    fn: Callable[[jnp.ndarray], jnp.ndarray],
    x0: jnp.ndarray,
    steps: int = 200,
    lr: float = 0.05,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> AdamResult:
    """Adam on a flat parameter vector, returning the best iterate seen."""
    vg = jax.value_and_grad(fn)

    def step(carry, i):
        x, m, v, best_x, best_f = carry
        f, g = vg(x)
        g = jnp.where(jnp.isfinite(g), g, 0.0)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / (1 - b1 ** (i + 1.0))
        vhat = v / (1 - b2 ** (i + 1.0))
        x_new = x - lr * mhat / (jnp.sqrt(vhat) + eps)
        improved = jnp.logical_and(jnp.isfinite(f), f < best_f)
        best_x = jnp.where(improved, x, best_x)
        best_f = jnp.where(improved, f, best_f)
        return (x_new, m, v, best_x, best_f), None

    init = (
        x0,
        jnp.zeros_like(x0),
        jnp.zeros_like(x0),
        x0,
        jnp.asarray(jnp.inf, x0.dtype),
    )
    (x, _, _, best_x, best_f), _ = jax.lax.scan(
        step, init, jnp.arange(steps, dtype=x0.dtype)
    )
    f_final = fn(x)
    take_final = jnp.logical_and(jnp.isfinite(f_final), f_final < best_f)
    x_out = jnp.where(take_final, x, best_x)
    f_out = jnp.where(take_final, f_final, best_f)
    g_out = vg(x_out)[1]
    return AdamResult(x_out, f_out, jnp.linalg.norm(g_out))


class GprOptResult(NamedTuple):
    t: jnp.ndarray
    noise: jnp.ndarray
    obj: jnp.ndarray        # minimized objective value
    grad_norm: jnp.ndarray  # ‖∇obj‖ (log-coords) at the RETURNED point (status)


def minimize_t_noise(
    fn: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
    t_lb: float = 1e-3,
    noise_lb: float = 1e-4,
    t_range: Tuple[float, float] = (1e-2, 1e3),
    noise_range: Tuple[float, float] = (1e-3, 1e1),
    n_grid: int = 8,
    adam_steps: int = 200,
    adam_lr: float = 0.05,
    dtype=jnp.float32,
) -> GprOptResult:
    """Minimize fn(t, noise) with bounds t ≥ t_lb, noise ≥ noise_lb.

    Coarse log-grid seeding (vmapped) then Adam in (log t, log noise)."""
    ts = jnp.logspace(jnp.log10(jnp.asarray(t_range[0], dtype)), jnp.log10(jnp.asarray(t_range[1], dtype)), n_grid)
    ns = jnp.logspace(jnp.log10(jnp.asarray(noise_range[0], dtype)), jnp.log10(jnp.asarray(noise_range[1], dtype)), n_grid)
    T, Nz = jnp.meshgrid(ts, ns, indexing="ij")
    flatT, flatN = T.reshape(-1), Nz.reshape(-1)
    vals = jax.vmap(fn)(flatT, flatN)
    vals = jnp.where(jnp.isfinite(vals), vals, jnp.inf)
    i = jnp.argmin(vals)

    def obj_flat(x):
        t = t_lb + jnp.exp(x[0])
        noise = noise_lb + jnp.exp(x[1])
        return fn(t, noise)

    x0 = jnp.stack(
        [
            jnp.log(jnp.maximum(flatT[i] - t_lb, 1e-6)),
            jnp.log(jnp.maximum(flatN[i] - noise_lb, 1e-6)),
        ]
    ).astype(dtype)
    res = adam_minimize(obj_flat, x0, steps=adam_steps, lr=adam_lr)
    t = t_lb + jnp.exp(res.x[0])
    noise = noise_lb + jnp.exp(res.x[1])
    better = res.obj < vals[i]
    t_out = jnp.where(better, t, flatT[i])
    n_out = jnp.where(better, noise, flatN[i])
    # the convergence-status gradient must describe the RETURNED point:
    # when the coarse-grid point wins, Adam's grad_norm is a
    # different iterate's — recompute at (t_out, n_out) in log-coords
    x_out = jnp.stack(
        [
            jnp.log(jnp.maximum(t_out - t_lb, 1e-6)),
            jnp.log(jnp.maximum(n_out - noise_lb, 1e-6)),
        ]
    ).astype(dtype)
    g_out = jax.grad(obj_flat)(x_out)
    return GprOptResult(
        t_out, n_out, jnp.minimum(res.obj, vals[i]), jnp.linalg.norm(g_out)
    )


def minimize_t_noisevec(
    fn: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
    m: int,
    t_lb: float = 1e-3,
    noise_lb: float = 1e-4,
    t0: float = 10.0,
    noise0: float = 1.0,
    t_range: Tuple[float, float] = (1e-2, 1e3),
    noise_range: Tuple[float, float] = (1e-3, 1e1),
    n_grid: int = 8,
    adam_steps: int = 400,
    adam_lr: float = 0.05,
    dtype=jnp.float32,
) -> GprOptResult:
    """Per-point-noise variant: minimize fn(t, noise_vec) over m+1 parameters
    (reference MMA path at src/train.cpp:588-624).

    Seeding mirrors :func:`minimize_t_noise`: a vmapped coarse log-grid over
    (t, HOMOSCEDASTIC noise) picks the starting basin, then Adam runs over
    the full (t, noise-vector) space from the winner.  (Round ≤4 started
    Adam from the fixed (t0, noise0·1) — on multimodal heteroscedastic
    marginals that lands in whichever basin contains t0; the grid costs
    n_grid² batched evaluations and restores basin selection.  The (t0,
    noise0) point joins the grid so the previous behavior is in the
    candidate set.)"""
    ts = jnp.logspace(
        jnp.log10(jnp.asarray(t_range[0], dtype)),
        jnp.log10(jnp.asarray(t_range[1], dtype)), n_grid,
    )
    ns = jnp.logspace(
        jnp.log10(jnp.asarray(noise_range[0], dtype)),
        jnp.log10(jnp.asarray(noise_range[1], dtype)), n_grid,
    )
    T, Nz = jnp.meshgrid(ts, ns, indexing="ij")
    flatT = jnp.concatenate([T.reshape(-1), jnp.full((1,), t0, dtype)])
    flatN = jnp.concatenate([Nz.reshape(-1), jnp.full((1,), noise0, dtype)])
    vals = jax.vmap(lambda t, nz: fn(t, jnp.full((m,), nz, dtype)))(flatT, flatN)
    vals = jnp.where(jnp.isfinite(vals), vals, jnp.inf)
    i = jnp.argmin(vals)

    def obj_flat(x):
        t = t_lb + jnp.exp(x[0])
        noise = noise_lb + jnp.exp(x[1:])
        return fn(t, noise)

    x0 = jnp.concatenate(
        [
            jnp.log(jnp.maximum(flatT[i] - t_lb, 1e-6))[None],
            jnp.full((m,), jnp.log(jnp.maximum(flatN[i] - noise_lb, 1e-6)), dtype),
        ]
    ).astype(dtype)
    res = adam_minimize(obj_flat, x0, steps=adam_steps, lr=adam_lr)
    t = t_lb + jnp.exp(res.x[0])
    noise = noise_lb + jnp.exp(res.x[1:])
    # keep the better of (Adam iterate, grid seed) like the scalar variant
    better = res.obj < vals[i]
    t_out = jnp.where(better, t, flatT[i])
    n_out = jnp.where(better, noise, jnp.full((m,), flatN[i], dtype))
    x_out = jnp.concatenate(
        [
            jnp.log(jnp.maximum(t_out - t_lb, 1e-6))[None],
            jnp.log(jnp.maximum(n_out - noise_lb, 1e-6)),
        ]
    ).astype(dtype)
    g_out = jax.grad(obj_flat)(x_out)
    return GprOptResult(
        t_out, n_out, jnp.minimum(res.obj, vals[i]), jnp.linalg.norm(g_out)
    )
