"""SMC posteriors over heat-kernel hyperparameters.

The reference point-optimizes the diffusion time t against the
Laplace-approximate marginal likelihood with COBYLA (src/train.cpp:38-71) —
one number, no uncertainty.  This module instead carries a full tempered-SMC
posterior over θ = log t: a scalar for binary GPC, a (J,)-vector for
one-vs-rest multiclass (the classes factorize, so one joint (J,)-dim SMC run
is exactly J independent posteriors resampled/mutated together, and every
marginal evaluation batches across classes under vmap).

Mutations are random-walk Metropolis: the Laplace marginal's Newton solve is
a ``lax.while_loop`` that reverse-mode autodiff cannot traverse, and the
hyperparameter space is low-dimensional, so gradient-free mutations are both
necessary and sufficient.

Prior note: the reference's "posterior" t-penalty p·log t + (t/τ)^(−q) with
p=1e-2 (src/train.h:139-140) corresponds to a density ∝ t^(−p)·e^(−(t/τ)^(−q))
that is IMPROPER on (0, ∞) — fine for point optimization, divergent as an
actual posterior.  The SMC posterior therefore uses a proper lognormal base
prior log t ~ N(μ0, s0²) and folds the reference's penalty into the tempered
term, so at β=1 the target is p(t | Y) ∝ p(Y | t)·penalty(t)·lognormal(t).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models.gpc import gpc_marginal_log_likelihood_lowrank
from ..models.latent import t_log_prior_density
from ..types import EigenPair
from .smc import SmcResult, run_smc, run_smc_chunked


class TPosterior(NamedTuple):
    t: jnp.ndarray              # (n_particles,) or (n_particles, J) samples of t
    t_mean: jnp.ndarray         # posterior mean of t (scalar or (J,))
    t_sd: jnp.ndarray           # posterior sd of t
    log_evidence: jnp.ndarray   # log ∫ p(Y|t)·penalty(t)·lognormal(t) dt estimate
    smc: SmcResult


def _q0_logpdf(theta: jnp.ndarray, mu0: float, s0: float) -> jnp.ndarray:
    z = (theta - mu0) / s0
    return jnp.sum(-0.5 * z * z - jnp.log(s0) - 0.5 * jnp.log(2.0 * jnp.pi))


def _penalty_tilt(t: jnp.ndarray, p: float, q: float, tau: float) -> jnp.ndarray:
    """The reference's t-penalty as a likelihood tilt (no Jacobian — the
    lognormal base prior is already a density in θ = log t)."""
    return jnp.sum(t_log_prior_density(t, p, q, tau))


def gpc_t_posterior(
    key: jax.Array,
    eigenpair: EigenPair,
    Y: jnp.ndarray,
    idx: jnp.ndarray,
    K: int,
    sigma: float,
    *,
    N: jnp.ndarray | None = None,
    n_particles: int = 64,
    n_mutation_steps: int = 5,
    p: float = 1e-2,
    q: float = 10.0,
    tau: float = 2.0,
    mu0: float = 2.3,
    s0: float = 1.5,
    newton_tol: float = 1e-5,
    newton_max_iter: int = 100,
) -> TPosterior:
    """Tempered-SMC posterior over log t for binary heat-kernel GPC.

    Y: (m,) 0/1 labels (or binomial counts with trials N) at rows ``idx`` of
    the eigenvector matrix.  Returns posterior samples/moments of t and the
    log evidence (the quantity the reference maximizes a point estimate of).
    """
    m = idx.shape[0]
    dtype = eigenpair.vectors.dtype
    Y = Y.astype(dtype)
    Nv = jnp.ones((m,), dtype) if N is None else N.astype(dtype)

    V_idx = eigenpair.vectors[idx, :K]
    lam = 1.0 - eigenpair.values[:K]

    def marginal(theta):
        t = jnp.exp(theta[0])
        Phi = V_idx * jnp.exp(-0.5 * t * lam)[None, :]
        return gpc_marginal_log_likelihood_lowrank(Phi, Y, Nv, sigma, newton_tol, newton_max_iter)

    def log_prior(theta):
        return _q0_logpdf(theta, mu0, s0)

    def log_like(theta):
        return marginal(theta) + _penalty_tilt(jnp.exp(theta), p, q, tau)

    k0, k1 = jax.random.split(key)
    x0 = mu0 + s0 * jax.random.normal(k0, (n_particles, 1), dtype)
    smc = run_smc(
        k1, log_prior, log_like, x0,
        n_mutation_steps=n_mutation_steps, mutation="rwm", step_size=0.5,
    )
    t = jnp.exp(smc.particles[:, 0])
    return TPosterior(t, jnp.mean(t), jnp.std(t), smc.log_evidence, smc)


class TQuadrature(NamedTuple):
    t_mean: jnp.ndarray         # exact posterior mean of t (scalar or (J,))
    t_sd: jnp.ndarray           # exact posterior sd of t
    log_evidence: jnp.ndarray   # log ∫ p(Y|t)·penalty(t)·lognormal(t) dt
    # resolution diagnostic: max normalized COARSE-grid weight over classes.
    # Near 1.0 would mean the coarse pass collapsed onto one cell and the
    # refined pass is doing all the work; gate it well below 1 before
    # treating the quadrature as ground truth.
    coarse_max_weight: jnp.ndarray = jnp.float32(0.0)


def mult_t_quadrature(
    eigenpair: EigenPair,
    aug_y: jnp.ndarray,
    idx: jnp.ndarray,
    K: int,
    sigma: float,
    *,
    n_grid: int = 256,
    half_width_sds: float = 5.0,
    p: float = 1e-2,
    q: float = 10.0,
    tau: float = 2.0,
    mu0: float = 2.3,
    s0: float = 1.5,
    newton_tol: float = 1e-5,
    newton_max_iter: int = 100,
) -> TQuadrature:
    """Exact per-class t-posterior moments by 1-D quadrature over θ = log t.

    The SMC target factorizes over classes and each factor is 1-D, so a
    grid Riemann sum over θ gives the posterior essentially exactly — the
    ground truth :func:`mult_t_posterior` is validated against (and the gold
    standard the reference's COBYLA point estimate has no analogue of,
    src/train.cpp:38-71).  All grid×class marginal evaluations batch on
    device: vmap over the grid, lax.map over classes (same memory reasoning
    as mult_t_posterior).  The prior/tilt terms are the same ``_q0_logpdf``
    / ``_penalty_tilt`` the SMC target uses — keep it that way, the whole
    point is that both describe ONE posterior.

    Two passes guard the resolution: the coarse pass spans
    ±``half_width_sds``·s0 around the prior mean (endpoint weighting is
    immaterial — the integrand is ~exp(−12.5) of its peak at ±5 sd); a
    refined pass then re-grids EACH class over its coarse posterior mean
    ± 8 coarse-sd (floored at one coarse cell), so a per-class posterior
    narrower than a coarse cell — the large-m failure mode where the "exact"
    t_sd denominator would silently degrade — is re-resolved with the full
    ``n_grid`` budget.  ``coarse_max_weight`` reports how much the coarse
    pass had collapsed.
    """
    m, J = aug_y.shape
    dtype = eigenpair.vectors.dtype
    aug_y = aug_y.astype(dtype)
    Nv = jnp.ones((m,), dtype)
    V_idx = eigenpair.vectors[idx, :K]
    lam = 1.0 - eigenpair.values[:K]

    def class_logw(yj, thetas_j):
        def at_theta(theta):
            t = jnp.exp(theta)
            Phi = V_idx * jnp.exp(-0.5 * t * lam)[None, :]
            mll = gpc_marginal_log_likelihood_lowrank(
                Phi, yj, Nv, sigma, newton_tol, newton_max_iter
            )
            prior = _q0_logpdf(theta[None], mu0, s0)
            return mll + _penalty_tilt(t, p, q, tau) + prior

        return jax.vmap(at_theta)(thetas_j)

    def moments(logw, thetas):
        """Per-class (log Z, t-mean, t-var, θ-mean, θ-sd) from (J, n_grid)
        log-weights over per-class grids (J, n_grid)."""
        dtheta = thetas[:, 1] - thetas[:, 0]
        lse = jax.scipy.special.logsumexp(logw, axis=1)
        log_z = lse + jnp.log(dtheta)
        w = jnp.exp(logw - lse[:, None])
        ts = jnp.exp(thetas)
        t_mean = jnp.sum(w * ts, axis=1)
        t_var = jnp.sum(w * (ts - t_mean[:, None]) ** 2, axis=1)
        th_mean = jnp.sum(w * thetas, axis=1)
        th_sd = jnp.sqrt(jnp.sum(w * (thetas - th_mean[:, None]) ** 2, axis=1))
        return log_z, t_mean, t_var, th_mean, th_sd, w

    coarse = jnp.linspace(
        mu0 - half_width_sds * s0, mu0 + half_width_sds * s0, n_grid, dtype=dtype
    )
    coarse_j = jnp.broadcast_to(coarse, (J, n_grid))
    logw0 = jax.lax.map(lambda a: class_logw(a[0], a[1]), (aug_y.T, coarse_j))
    _, _, _, th_mean, th_sd, w0 = moments(logw0, coarse_j)
    max_w = jnp.max(w0)

    cell = coarse[1] - coarse[0]
    half = jnp.maximum(8.0 * th_sd, cell)
    lo = th_mean - half
    steps = jnp.linspace(0.0, 1.0, n_grid, dtype=dtype)
    fine_j = lo[:, None] + (2.0 * half)[:, None] * steps[None, :]
    logw1 = jax.lax.map(lambda a: class_logw(a[0], a[1]), (aug_y.T, fine_j))
    log_z, t_mean, t_var, _, _, _ = moments(logw1, fine_j)
    return TQuadrature(t_mean, jnp.sqrt(t_var), jnp.sum(log_z), max_w)


def mult_t_posterior(
    key: jax.Array,
    eigenpair: EigenPair,
    aug_y: jnp.ndarray,
    idx: jnp.ndarray,
    K: int,
    sigma: float,
    *,
    n_particles: int = 64,
    n_mutation_steps: int = 5,
    p: float = 1e-2,
    q: float = 10.0,
    tau: float = 2.0,
    mu0: float = 2.3,
    s0: float = 1.5,
    newton_tol: float = 1e-5,
    newton_max_iter: int = 100,
    stages_per_dispatch: int | None = None,
) -> TPosterior:
    """Joint SMC posterior over per-class log t for one-vs-rest multiclass.

    aug_y: (m, J) one-hot labels (fit.multiclass.one_hot_labels output).  The
    J binary marginals batch under one vmap per particle — replacing the
    reference's serial per-class COBYLA loop
    (src/MultiClassification.cpp:40-50) with a fully batched posterior.

    ``stages_per_dispatch``: when set, the tempering ladder runs through
    :func:`run_smc_chunked` — ≤ that many stages per device dispatch with the
    tiny SMC state carried across dispatches (bit-identical result), which
    bounds the wall of each dispatch; the function is then no longer
    jittable as a whole (it owns a host loop).
    """
    m, J = aug_y.shape
    dtype = eigenpair.vectors.dtype
    aug_y = aug_y.astype(dtype)
    Nv = jnp.ones((m,), dtype)

    V_idx = eigenpair.vectors[idx, :K]
    lam = 1.0 - eigenpair.values[:K]

    def marginal(theta):
        ts = jnp.exp(theta)  # (J,)

        def one(args):
            t, yj = args
            Phi = V_idx * jnp.exp(-0.5 * t * lam)[None, :]
            return gpc_marginal_log_likelihood_lowrank(
                Phi, yj, Nv, sigma, newton_tol, newton_max_iter
            )

        # lax.map (not vmap) over classes: the SMC evaluates this under a
        # vmap over all particles, so a vmapped class axis multiplies peak
        # memory by J (device-memory blowups at m=500, J=10, 64 particles
        # with the dense marginal).  Classes run sequentially; particles
        # stay batched.
        return jnp.sum(jax.lax.map(one, (ts, aug_y.T)))

    def log_prior(theta):
        return _q0_logpdf(theta, mu0, s0)

    def log_like(theta):
        return marginal(theta) + _penalty_tilt(jnp.exp(theta), p, q, tau)

    k0, k1 = jax.random.split(key)
    x0 = mu0 + s0 * jax.random.normal(k0, (n_particles, J), dtype)
    if stages_per_dispatch is None:
        smc = run_smc(
            k1, log_prior, log_like, x0,
            n_mutation_steps=n_mutation_steps, mutation="rwm", step_size=0.5,
        )
    else:
        smc = run_smc_chunked(
            k1, log_prior, log_like, x0,
            stages_per_dispatch=stages_per_dispatch,
            n_mutation_steps=n_mutation_steps, mutation="rwm", step_size=0.5,
        )
    t = jnp.exp(smc.particles)
    return TPosterior(t, jnp.mean(t, 0), jnp.std(t, 0), smc.log_evidence, smc)
