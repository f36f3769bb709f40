"""ChEES-HMC: cross-chain adaptive trajectory lengths at fixed batch shape.

Why this exists: vmapped NUTS runs every chain of a batch to the slowest
chain's tree depth, so its throughput COLLAPSES at wide batch, while
fixed-trajectory HMC leaves quality on the table at narrow batch because
nothing tunes its trajectory length.  ChEES (Hoffman, Radul &
Sountsov, AISTATS 2021) closes the split: NUTS-quality *adaptive* trajectory
lengths with a batch-uniform step count per iteration, so the whole batch
stays one fused leapfrog program at any chain count.

Formulation:

- ONE jittered trajectory length per iteration, shared by every chain: the
  per-iteration leapfrog count ``n_t = ceil(h_t·τ / ε)`` (h_t a base-2
  Halton point) is a traced scalar driving a ``lax.while_loop`` whose body
  is the BATCHED leapfrog — all chains integrate in lockstep by
  construction, so there is no slowest-chain serialization to collapse
  under, and shapes stay static for XLA.
- Adaptation is cross-chain, not per-chain: step size by dual averaging on
  the harmonic-mean acceptance (target 0.651), trajectory length by Adam
  ascent on the ChEES criterion gradient, and the diagonal metric from
  bias-corrected EMA cross-chain moments.  Wide batches make these
  estimators *better*, the opposite of NUTS's scaling.
- The criterion: maximize  E[(‖x⁺−x̄‖² − ‖x−x̄‖²)²]  (change in squared
  distance to the estimated posterior mean).  Per-iteration gradient
  estimate w.r.t. the trajectory length, accept-weighted across chains:

      ĝ = h_t · Σ_c α_c·ΔD_c·⟨x⁺_c − x̄⁺, v⁺_c⟩ / Σ_c α_c

  with v⁺ = M⁻¹p⁺ the final velocity (dx⁺/d(traj len)) and ΔD_c the
  squared-distance change.  Adam on log τ self-normalizes the scale.

The reference has no sampler to compare: its only chain is the serial host
PG Gibbs loop (/root/reference/src/PGLogitModel.cpp:48-53).  Cross-chain
statistics reduce with ``jax.lax.pmean`` when ``axis_name`` is set, so the
same code runs chain-sharded under ``shard_map`` (parallel/mcmc.py).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .hmc import da_init, da_update

LogProbFn = Callable[[jnp.ndarray], jnp.ndarray]


def halton2(i: jnp.ndarray) -> jnp.ndarray:
    """Base-2 radical inverse (van der Corput / Halton) of int32 index ≥ 1 —
    the low-discrepancy trajectory jitter of the ChEES paper.  Bit reversal
    via the 5-stage butterfly; returns a float in (0, 1) for i ≥ 1."""
    u = i.astype(jnp.uint32)
    u = ((u & 0x55555555) << 1) | ((u >> 1) & 0x55555555)
    u = ((u & 0x33333333) << 2) | ((u >> 2) & 0x33333333)
    u = ((u & 0x0F0F0F0F) << 4) | ((u >> 4) & 0x0F0F0F0F)
    u = ((u & 0x00FF00FF) << 8) | ((u >> 8) & 0x00FF00FF)
    u = (u << 16) | (u >> 16)
    return u.astype(jnp.float64 if jax.config.jax_enable_x64 else jnp.float32) * (
        1.0 / 4294967296.0
    )


def _pmean(x, axis_name):
    return x if axis_name is None else jax.lax.pmean(x, axis_name)


class _BatchState(NamedTuple):
    x: jnp.ndarray      # (C, dim)
    logp: jnp.ndarray   # (C,)
    grad: jnp.ndarray   # (C, dim)


def _batched_leapfrog(vg, st: _BatchState, p, step, inv_mass, n_steps):
    """n_steps batched leapfrog steps; n_steps is a TRACED scalar (the
    while_loop trip count is dynamic but identical for every chain)."""

    def cond(c):
        return c[0] < n_steps

    def body(c):
        i, st, p = c
        p_half = p + 0.5 * step * st.grad
        x_new = st.x + step * inv_mass[None, :] * p_half
        logp, grad = vg(x_new)
        p_new = p_half + 0.5 * step * grad
        return i + 1, _BatchState(x_new, logp, grad), p_new

    _, st, p = jax.lax.while_loop(cond, body, (jnp.int32(0), st, p))
    return st, p


def _chees_transition(
    vg, key, st: _BatchState, p0_key, step, inv_mass, n_steps, axis_name
):
    """One batched jittered-HMC transition shared by warmup and sampling.

    Returns (new state, proposal state, final momentum, accept probs)."""
    dtype = st.x.dtype
    C, dim = st.x.shape
    p0 = jax.random.normal(p0_key, (C, dim), dtype) / jnp.sqrt(inv_mass)[None, :]
    prop, p1 = _batched_leapfrog(vg, st, p0, step, inv_mass, n_steps)
    ke0 = 0.5 * jnp.sum(inv_mass[None, :] * p0 * p0, axis=1)
    ke1 = 0.5 * jnp.sum(inv_mass[None, :] * p1 * p1, axis=1)
    log_accept = (prop.logp - ke1) - (st.logp - ke0)
    log_accept = jnp.where(jnp.isfinite(log_accept), log_accept, -jnp.inf)
    accept_prob = jnp.minimum(1.0, jnp.exp(log_accept))
    take = jax.random.uniform(key, (C,), dtype) < accept_prob
    new = jax.tree_util.tree_map(
        lambda a, b: jnp.where(
            take.reshape((C,) + (1,) * (a.ndim - 1)), a, b
        ),
        prop,
        st,
    )
    return new, prop, p1, accept_prob


def _chees_grad(st, prop, p1, accept_prob, inv_mass, h, axis_name):
    """Accept-weighted ChEES criterion gradient w.r.t. trajectory length.

    Divergent proposals (non-finite x⁺/p⁺ — a too-long f32 trajectory
    through a steep region) are excluded by zeroing their accept weight AND
    their field values: the MH accept path already rejects them, but the
    criterion reads proposals directly, and one NaN chain would otherwise
    poison the cross-chain means and pin τ at NaN for the rest of warmup."""
    dtype = st.x.dtype
    finite = jnp.logical_and(
        jnp.all(jnp.isfinite(prop.x), axis=1), jnp.all(jnp.isfinite(p1), axis=1)
    )
    a = jnp.where(finite, accept_prob.astype(dtype), 0.0)
    xp = jnp.where(finite[:, None], prop.x, 0.0)
    p1 = jnp.where(finite[:, None], p1, 0.0)
    a_sum = jnp.maximum(_pmean(jnp.mean(a), axis_name), 1e-6)
    # centered on cross-chain means: current states plainly, proposals
    # accept-weighted (rejected proposals can sit arbitrarily far out)
    xbar = _pmean(jnp.mean(st.x, axis=0), axis_name)
    xbar_p = _pmean(jnp.mean(a[:, None] * xp, axis=0), axis_name) / a_sum
    dx = st.x - xbar[None, :]
    dxp = xp - xbar_p[None, :]
    dD = jnp.sum(dxp * dxp, axis=1) - jnp.sum(dx * dx, axis=1)
    v1 = inv_mass[None, :] * p1
    per_chain = dD * jnp.sum(dxp * v1, axis=1)
    g = h * _pmean(jnp.mean(a * per_chain), axis_name) / a_sum
    return jnp.where(jnp.isfinite(g), g, 0.0)


class CheesRun(NamedTuple):
    samples: jnp.ndarray       # (n_samples, C, dim)
    accept_prob: jnp.ndarray   # (n_samples, C)
    step: jnp.ndarray          # () shared adapted step size
    traj_len: jnp.ndarray      # () shared adapted max trajectory length τ
    inv_mass: jnp.ndarray      # (dim,) shared adapted diagonal inverse mass
    n_leapfrog_total: jnp.ndarray  # () total leapfrog steps in sampling phase


def _n_steps_at(t, step, traj_len, max_steps):
    h = halton2(t + 1)
    n = jnp.ceil(h * traj_len / step).astype(jnp.int32)
    return jnp.clip(n, 1, max_steps), h


def run_chees(
    key: jax.Array,
    logprob: LogProbFn,
    x0: jnp.ndarray,
    n_warmup: int = 500,
    n_samples: int = 1000,
    target_accept: float = 0.651,
    init_step: float = 0.1,
    init_traj_len: float = 1.0,
    max_steps: int = 256,
    adam_lr: float = 0.025,
    axis_name: str | None = None,
    inv_mass0: jnp.ndarray | None = None,
) -> CheesRun:
    """Adaptive ChEES-HMC on a batch of chains (x0: (C, dim)).

    Warmup jointly adapts (ε, τ, M⁻¹) from cross-chain statistics; sampling
    runs at the frozen triple with Halton-jittered trajectory lengths.  Set
    ``axis_name`` when the chain axis is sharded under ``shard_map`` — every
    cross-chain reduction then rides one pmean and the adapted scalars stay
    replicated.  ``inv_mass0`` (dim,) seeds the metric — for posteriors with
    analytically-known anisotropy pass ``models.latent.whitened_inv_mass0``
    (same contract as ``hmc.run_hmc``)."""
    C, dim = x0.shape
    dtype = x0.dtype
    vg = jax.vmap(jax.value_and_grad(logprob))
    logp0, grad0 = vg(x0)
    st0 = _BatchState(x0, logp0, grad0)

    k_warm, k_main = jax.random.split(key)
    da0 = da_init(jnp.asarray(init_step, dtype))
    # metric EMA moments (bias-corrected): m1 ~ mean, m2 ~ second moment
    ema_decay = jnp.asarray(0.95, dtype)

    class Warm(NamedTuple):
        st: _BatchState
        da: object
        log_tau: jnp.ndarray
        adam_m: jnp.ndarray
        adam_v: jnp.ndarray
        ema_v: jnp.ndarray
        ema_w: jnp.ndarray
        inv_mass: jnp.ndarray

    inv_mass_init = (
        jnp.ones((dim,), dtype) if inv_mass0 is None else inv_mass0.astype(dtype)
    )
    warm0 = Warm(
        st=st0,
        da=da0,
        log_tau=jnp.log(jnp.asarray(init_traj_len, dtype)),
        adam_m=jnp.zeros((), dtype),
        adam_v=jnp.zeros((), dtype),
        ema_v=jnp.zeros((dim,), dtype),
        ema_w=jnp.zeros((), dtype),
        inv_mass=inv_mass_init,
    )
    # metric updates start after the init buffer: chains are still huddled
    # around x0 before that and the cross-chain variance would collapse the
    # metric toward zero
    init_buffer = max(int(0.15 * n_warmup), 1)

    def warm_body(w: Warm, tk):
        t, kk = tk
        k_mom, k_acc = jax.random.split(kk)
        step = jnp.exp(w.da.log_step)
        tau = jnp.exp(w.log_tau)
        n_steps, h = _n_steps_at(t, step, tau, max_steps)
        new, prop, p1, ap = _chees_transition(
            vg, k_acc, w.st, k_mom, step, w.inv_mass, n_steps, axis_name
        )
        # harmonic-mean acceptance (ChEES paper): punishes stragglers, which
        # is what keeps the shared step honest across thousands of chains.
        # The 0.05 floor bounds a single diverged chain's contribution to
        # 20× a typical one — with the 1e-4 floor one such chain per
        # iteration held the dual-averaged step an order of magnitude below
        # the target-accept step (observed on the torus GPC posterior)
        hmean = 1.0 / jnp.maximum(
            _pmean(jnp.mean(1.0 / jnp.maximum(ap, 0.05)), axis_name), 1e-6
        )
        da = da_update(w.da, hmean, target_accept)

        # ChEES gradient → Adam ascent on log τ
        g = _chees_grad(w.st, prop, p1, ap, w.inv_mass, h, axis_name) * tau
        b1, b2 = 0.9, 0.999
        adam_m = b1 * w.adam_m + (1 - b1) * g
        adam_v = b2 * w.adam_v + (1 - b2) * g * g
        tc = (t + 1).astype(dtype)
        mhat = adam_m / (1 - b1**tc)
        vhat = adam_v / (1 - b2**tc)
        log_tau = w.log_tau + adam_lr * mhat / (jnp.sqrt(vhat) + 1e-8)
        # τ ∈ [ε, max_steps·ε]: below ε the jittered count pins at 1; above
        # the cap the clip in _n_steps_at would silently bias the criterion
        log_tau = jnp.clip(
            log_tau,
            w.da.log_step,
            w.da.log_step + jnp.log(jnp.asarray(float(max_steps), dtype)),
        )

        # Metric from a ROBUST cross-chain dispersion: per-coordinate IQR →
        # variance ((q75−q25)/1.349)², EMA-smoothed and bias-corrected.
        # Plain cross-chain variance is catastrophically non-robust here: a
        # few chains stuck at extreme positions during the burn-in transit
        # inflate it 50× past the equilibrium value, the inflated metric
        # fires huge jumps along that coordinate, everyone starts rejecting,
        # and the warmup wedges at a tiny step (measured on the torus GPC
        # posterior: var estimate 150 vs true 3.2 for log t, final step
        # 0.002 vs healthy 0.5).  The IQR tracks the BULK of chains, so the
        # feedback loop never closes.  (Sharded: quartiles are per-shard,
        # pmean-averaged — exact quantiles need a gather; the shard-mean of
        # IQRs is an equally robust dispersion estimate.)
        upd = (t >= init_buffer).astype(dtype)
        q25, q75 = jnp.percentile(new.x, jnp.asarray([25.0, 75.0]), axis=0)
        v_rob = _pmean((((q75 - q25) / 1.349) ** 2).astype(dtype), axis_name)
        ema_v_new = ema_decay * w.ema_v + (1 - ema_decay) * v_rob
        ema_v = upd * ema_v_new + (1 - upd) * w.ema_v
        # bias-corrected weight: total EMA mass is 1 - decay^k after k updates
        k_upd = w.ema_w + upd
        corr = 1.0 - ema_decay**k_upd
        var = ema_v / jnp.maximum(corr, 1e-6)
        inv_mass = jnp.where(k_upd > 3.0, var + 1e-6, w.inv_mass)
        return (
            Warm(new, da, log_tau, adam_m, adam_v, ema_v, k_upd, inv_mass),
            None,
        )

    # Two warmup segments with a dual-averaging RESTART between them: the
    # averaged iterate exp(log_step_avg) otherwise still carries the early
    # find-the-scale transient at the end of warmup (measured on the torus
    # GPC posterior: avg 0.019 vs converged step ~0.5 — same failure the
    # windowed HMC warmup avoids by re-initializing DA per window,
    # hmc.windowed_warmup).  Segment 2 restarts DA from the CURRENT step, so
    # its average only sees post-transient iterations; τ/metric/Adam state
    # carry straight through.
    n1 = max(int(0.6 * n_warmup), 1)
    n2 = max(n_warmup - n1, 1)
    k_w1, k_w2 = jax.random.split(k_warm)
    warm, _ = jax.lax.scan(
        warm_body,
        warm0,
        (jnp.arange(n1, dtype=jnp.int32), jax.random.split(k_w1, n1)),
    )
    warm = warm._replace(da=da_init(jnp.exp(warm.da.log_step)))
    warm, _ = jax.lax.scan(
        warm_body,
        warm,
        (jnp.arange(n1, n1 + n2, dtype=jnp.int32), jax.random.split(k_w2, n2)),
    )
    step = jnp.exp(warm.da.log_step_avg)
    traj_len = jnp.exp(warm.log_tau)
    inv_mass = warm.inv_mass

    fixed = _run_fixed_from(
        k_main, vg, warm.st, step, traj_len, inv_mass, n_samples, max_steps, axis_name
    )
    return fixed


def _run_fixed_from(
    key, vg, st0: _BatchState, step, traj_len, inv_mass, n_samples, max_steps, axis_name
):
    def body(carry, tk):
        st, n_total = carry
        t, kk = tk
        k_mom, k_acc = jax.random.split(kk)
        n_steps, _ = _n_steps_at(t, step, traj_len, max_steps)
        new, _, _, ap = _chees_transition(
            vg, k_acc, st, k_mom, step, inv_mass, n_steps, axis_name
        )
        return (new, n_total + n_steps), (new.x, ap)

    (st, n_total), (draws, aps) = jax.lax.scan(
        body,
        (st0, jnp.int32(0)),
        (jnp.arange(n_samples, dtype=jnp.int32), jax.random.split(key, n_samples)),
    )
    return CheesRun(draws, aps, step, traj_len, inv_mass, n_total)


def run_chees_fixed(
    key: jax.Array,
    logprob: LogProbFn,
    x0: jnp.ndarray,
    step: jnp.ndarray,
    traj_len: jnp.ndarray,
    inv_mass: jnp.ndarray,
    n_samples: int = 1000,
    max_steps: int = 256,
    axis_name: str | None = None,
) -> CheesRun:
    """Steady-state ChEES sampling at FROZEN (ε, τ, M⁻¹) from a prior
    :func:`run_chees` — the wide-batch production phase: tile the adapted
    scalars across any chain count and every iteration stays one batched
    leapfrog program.  x0: (C, dim); step/traj_len scalars; inv_mass (dim,)."""
    vg = jax.vmap(jax.value_and_grad(logprob))
    logp0, grad0 = vg(x0)
    return _run_fixed_from(
        key,
        vg,
        _BatchState(x0, logp0, grad0),
        jnp.asarray(step, x0.dtype),
        jnp.asarray(traj_len, x0.dtype),
        jnp.asarray(inv_mass, x0.dtype),
        n_samples,
        max_steps,
        axis_name,
    )
