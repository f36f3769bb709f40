"""Adaptive tempered Sequential Monte Carlo with HMC mutations.

Particles live on the same flattened parameter space as the HMC/NUTS/SVI
stack.  The tempering schedule is chosen adaptively by bisecting on effective
sample size; resampling is systematic.  Particles shard over the ``chain``
mesh axis in ``parallel.mcmc``-style deployments — resampling is the one
collective (an all-gather of weights), matching the BASELINE.json design
("resampling … done via collectives").

Two drivers over ONE stage body:

- :func:`run_smc` — the whole tempering ladder in a single
  ``lax.while_loop`` (one dispatch; right when the per-stage work is small).
- :func:`run_smc_chunked` — the same ladder split into host-side dispatches
  of ≤ ``stages_per_dispatch`` stages each.  The SMC state is a tiny pytree,
  so checkpointing it across dispatches is free — this bounds the wall of
  each dispatch for long ladders (e.g. the multiclass Laplace-marginal
  target at its validated 64-particle/5-mutation budget).  Both drivers
  apply the identical
  stage body in the identical order, so their results agree bit-for-bit.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .hmc import HmcState, hmc_kernel, init_state

LogProbFn = Callable[[jnp.ndarray], jnp.ndarray]


class SmcResult(NamedTuple):
    particles: jnp.ndarray      # (n_particles, dim) final posterior particles
    log_evidence: jnp.ndarray   # log-normalizing-constant estimate
    n_stages: jnp.ndarray
    temperatures: jnp.ndarray   # (max_stages,) padded with 1.0


class SmcState(NamedTuple):
    """Full tempering state — checkpointable across dispatches."""

    key: jax.Array
    particles: jnp.ndarray
    beta: jnp.ndarray
    log_Z: jnp.ndarray
    stage: jnp.ndarray
    step: jnp.ndarray
    temps: jnp.ndarray


def _systematic_resample(key, log_w, n):
    w = jax.nn.softmax(log_w)
    positions = (jax.random.uniform(key, ()) + jnp.arange(n)) / n
    cum = jnp.cumsum(w)
    return jnp.searchsorted(cum, positions)


def _ess_from_logw(log_w):
    w = jax.nn.softmax(log_w)
    return 1.0 / jnp.sum(w * w)


def _make_stage_body(
    log_prior: LogProbFn,
    log_like: LogProbFn,
    n: int,
    dim: int,
    dtype,
    n_mutation_steps: int,
    n_leapfrog: int,
    target_ess_frac: float,
    mutation: str,
):
    """One tempering stage: pick β by ESS bisection, reweight, resample,
    mutate.  Shared verbatim by both drivers (bit-identical schedules)."""

    def tempered(beta):
        return lambda x: log_prior(x) + beta * log_like(x)

    def next_beta(particles, beta):
        """Bisect the increment so the incremental ESS hits the target."""
        ll = jax.vmap(log_like)(particles)

        def ess_at(b):
            return _ess_from_logw((b - beta) * ll)

        def cond(st):
            lo, hi, i = st
            return i < 30

        def body(st):
            lo, hi, i = st
            mid = 0.5 * (lo + hi)
            ok = ess_at(mid) >= target_ess_frac * n
            lo = jnp.where(ok, mid, lo)
            hi = jnp.where(ok, hi, mid)
            return lo, hi, i + 1

        full_ok = ess_at(jnp.asarray(1.0, dtype)) >= target_ess_frac * n
        lo, hi, _ = jax.lax.while_loop(
            cond, body, (beta, jnp.asarray(1.0, dtype), jnp.int32(0))
        )
        return jnp.where(full_ok, jnp.asarray(1.0, dtype), lo), ll

    def stage_body(st: SmcState):
        key, k_res, k_mut = jax.random.split(st.key, 3)
        beta_new, ll = next_beta(st.particles, st.beta)
        log_w = (beta_new - st.beta) * ll
        log_Z = st.log_Z + jax.nn.logsumexp(log_w) - jnp.log(jnp.asarray(n, dtype))

        idx = _systematic_resample(k_res, log_w, n)
        particles = st.particles[idx]

        target = tempered(beta_new)

        if mutation == "hmc":

            def mutate(k, x):
                state = init_state(target, x)

                def body(carry, kk):
                    s, _ = carry
                    s, ap = hmc_kernel(
                        target, kk, s, st.step, jnp.ones((dim,), dtype), n_leapfrog
                    )
                    return (s, ap), None

                (state, ap), _ = jax.lax.scan(
                    body, (state, jnp.asarray(1.0, dtype)), jax.random.split(k, n_mutation_steps)
                )
                return state.x, ap

            accept_target = 0.65
        else:  # rwm

            def mutate(k, x):
                lp = target(x)

                def body(carry, kk):
                    x, lp, _ = carry
                    k_prop, k_acc = jax.random.split(kk)
                    prop = x + st.step * jax.random.normal(k_prop, (dim,), dtype)
                    lp_prop = target(prop)
                    log_u = jnp.log(jax.random.uniform(k_acc, (), dtype))
                    ap = jnp.minimum(1.0, jnp.exp(lp_prop - lp))
                    take = log_u < lp_prop - lp
                    x = jnp.where(take, prop, x)
                    lp = jnp.where(take, lp_prop, lp)
                    return (x, lp, ap), None

                (x, _, ap), _ = jax.lax.scan(
                    body, (x, lp, jnp.asarray(1.0, dtype)),
                    jax.random.split(k, n_mutation_steps),
                )
                return x, ap

            accept_target = 0.3

        xs, aps = jax.vmap(mutate)(jax.random.split(k_mut, n), particles)
        mean_ap = jnp.mean(aps)
        # crude step-size controller toward the kernel's target acceptance
        step = st.step * jnp.exp(1.0 * (mean_ap - accept_target))
        temps = st.temps.at[st.stage].set(beta_new)
        return SmcState(key, xs, beta_new, log_Z, st.stage + 1, step, temps)

    return stage_body


def smc_init(
    key: jax.Array, x0: jnp.ndarray, step_size: float = 0.1, max_stages: int = 50
) -> SmcState:
    dtype = x0.dtype
    return SmcState(
        key,
        x0,
        jnp.asarray(0.0, dtype),
        jnp.asarray(0.0, dtype),
        jnp.int32(0),
        jnp.asarray(step_size, dtype),
        jnp.ones((max_stages,), dtype),
    )


def _check_mutation(mutation: str):
    if mutation not in ("hmc", "rwm"):
        raise ValueError(f"unknown mutation kernel {mutation!r}")


def run_smc(
    key: jax.Array,
    log_prior: LogProbFn,
    log_like: LogProbFn,
    x0: jnp.ndarray,
    n_mutation_steps: int = 5,
    n_leapfrog: int = 8,
    target_ess_frac: float = 0.5,
    max_stages: int = 50,
    step_size: float = 0.1,
    mutation: str = "hmc",
) -> SmcResult:
    """Temper from the prior to prior·likelihood.

    x0: (n_particles, dim) draws from the prior.  The per-stage mutation
    targets log_prior + β·log_like with a shared step size rescaled by the
    acceptance statistics of the previous stage.

    mutation: "hmc" (gradient-based; requires log_like to be reverse-mode
    differentiable) or "rwm" (Gaussian random-walk Metropolis — for targets
    whose likelihood runs through non-differentiable solvers, e.g. the
    Laplace-approximate GPC marginal's Newton ``while_loop``).
    """
    _check_mutation(mutation)
    n, dim = x0.shape
    stage_body = _make_stage_body(
        log_prior, log_like, n, dim, x0.dtype,
        n_mutation_steps, n_leapfrog, target_ess_frac, mutation,
    )

    def stage_cond(st: SmcState):
        return jnp.logical_and(st.beta < 1.0, st.stage < max_stages)

    out = jax.lax.while_loop(
        stage_cond, stage_body, smc_init(key, x0, step_size, max_stages)
    )
    return SmcResult(out.particles, out.log_Z, out.stage, out.temps)


def run_smc_chunked(
    key: jax.Array,
    log_prior: LogProbFn,
    log_like: LogProbFn,
    x0: jnp.ndarray,
    stages_per_dispatch: int = 4,
    n_mutation_steps: int = 5,
    n_leapfrog: int = 8,
    target_ess_frac: float = 0.5,
    max_stages: int = 50,
    step_size: float = 0.1,
    mutation: str = "hmc",
) -> SmcResult:
    """The :func:`run_smc` ladder split across host-side dispatches.

    Each jitted dispatch runs the shared stage body under a while_loop bound
    by ``stage < limit`` with ``limit = stage_at_entry + stages_per_dispatch``
    (and β < 1), then the host reads back β (a scalar — the state stays on
    device) and re-dispatches until the ladder finishes.  Because the bound
    only truncates the SAME while_loop the monolithic driver runs, the
    sequence of stage-body applications — and therefore the result — is
    bit-identical to :func:`run_smc`.  One compile: ``limit`` is a traced
    argument.

    This is NOT a jittable function (it owns a host loop); call it directly
    and jit only lives inside.
    """
    _check_mutation(mutation)
    n, dim = x0.shape
    stage_body = _make_stage_body(
        log_prior, log_like, n, dim, x0.dtype,
        n_mutation_steps, n_leapfrog, target_ess_frac, mutation,
    )

    @jax.jit
    def dispatch(st: SmcState, limit):
        def cond(s: SmcState):
            return jnp.logical_and(s.beta < 1.0, s.stage < limit)

        return jax.lax.while_loop(cond, stage_body, st)

    st = smc_init(key, x0, step_size, max_stages)
    stage = 0
    while stage < max_stages:
        limit = min(stage + stages_per_dispatch, max_stages)
        st = dispatch(st, jnp.int32(limit))
        # the two scalars the host loop needs; everything else stays on device
        stage = int(st.stage)
        if float(st.beta) >= 1.0:
            break
    return SmcResult(st.particles, st.log_Z, st.stage, st.temps)
