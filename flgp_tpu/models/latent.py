"""Whitened low-rank latent parameterization of heat-kernel GPs.

The reference's inference works in the m-dimensional latent f with dense
(m, m) covariance solves per step (src/PGLogitModel.cpp:25-39).  This
formulation exploits the spectral structure directly:

    f = V_idx · diag(exp(−t·(1−λ)/2)) · u,   u ~ N(0, I_K)

so the latent is the K-dimensional whitened vector u, the prior is isotropic,
and a posterior-density evaluation is one (m, K) matvec — no Cholesky at all.
This is what makes HMC/NUTS/SVI/SMC cheap and fully batchable across chains.
Hyperparameters enter differentiably through t (and noise), enabling joint
sampling, which the reference cannot do.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import EPS
from ..ops.linalg import pdot
from ..types import EigenPair


class WhitenedGP(NamedTuple):
    """Static data of a whitened heat-kernel GP at a set of points."""

    V: jnp.ndarray        # (m, K) spectral features at the observed points
    lam: jnp.ndarray      # (K,) Laplacian eigenvalues 1 - λ(W)
    sigma: float          # ridge on the covariance diagonal


def make_whitened(eigenpair: EigenPair, idx: jnp.ndarray, K: int, sigma: float) -> WhitenedGP:
    return WhitenedGP(
        eigenpair.vectors[idx, :K], eigenpair.laplacian_eigenvalues(K), sigma
    )


def whitened_inv_mass0(
    gp: WhitenedGP, t0: float, obs_curvature: float, n_hyper: int
) -> jnp.ndarray:
    """Analytic warmup-metric seed for HMC/NUTS over a whitened GP posterior.

    Approximate per-coordinate posterior variances under a Gaussian/Laplace
    likelihood model: Var[u_k | Y] ≈ 1/(1 + c̄·‖Φ_k‖²) with
    Φ_k = V_k·exp(−t0·λ_k/2) the feature column at a representative diffusion
    time t0 and c̄ the average observation curvature (¼ for the logit link,
    1/noise_var for Gaussian).  Hyperparameter coordinates get unit mass.

    Why this exists: methods whose spectrum spans the full [0, 1] — the
    Nyström extension (fit/spectral.py:104-148, reference
    src/Fit.cpp:284-291) — produce whitened feature scales spanning ~175×
    at t≈10 (measured; LAE/SE span ~2×), i.e. a ~1e4-condition posterior
    that a ones-seeded diagonal adaptation cannot recover inside a short
    warmup.  Seeding with these variances restores Nyström NUTS mixing to
    LAE/SE levels."""
    colsq = jnp.sum(gp.V * gp.V, axis=0) * jnp.exp(-t0 * gp.lam)
    var = 1.0 / (1.0 + obs_curvature * colsq)
    return jnp.concatenate([var, jnp.ones((n_hyper,), var.dtype)])


def latent_f(gp: WhitenedGP, u: jnp.ndarray, t: jnp.ndarray, precision=None) -> jnp.ndarray:
    """f = V·diag(exp(−t·lam/2))·u (marginal variance matches the heat kernel
    up to the σ ridge, src/Spectrum.cpp:83-94).

    ``precision`` overrides the HIGHEST-pinned contraction — the sampler
    hot-loop knob (see :func:`logpost_with_precision`)."""
    scale = jnp.exp(-0.5 * t * gp.lam)
    su = (scale * u)[..., None]
    if precision is None:
        return pdot(gp.V, su)[..., 0]
    return jnp.matmul(gp.V, su, precision=precision)[..., 0]


def logpost_with_precision(base, precision):
    """Same posterior as ``base`` (GpcLogPost/GprLogPost) with the latent
    matmul at ``precision`` — e.g. ``jax.lax.Precision.DEFAULT``, which
    on the GPU runs an f32 matmul on the tensor cores in TF32.  Whether
    that is statistically indistinguishable and faster for sampling is
    what bench.py's ChEES stage gates and times.

    Returned as a closure (not a NamedTuple field) so Precision never
    becomes a pytree leaf."""

    def lp(x):
        if hasattr(base, "N"):  # GpcLogPost
            u, t = base.unpack(x)
            f = latent_f(base.gp, u, t, precision)
            out = log_prior_u(u) + bernoulli_logit_loglik(f, base.Y, base.N)
            return out + _theta_log_prior(
                x[-1], t, base.p, base.q, base.tau, base.mu0, base.s0
            )
        u, t, noise = base.unpack(x)
        f = latent_f(base.gp, u, t, precision)
        out = log_prior_u(u) + gaussian_loglik(f, base.Y, noise + base.gp.sigma)
        out = out + _theta_log_prior(x[-2], t, base.p, base.q, base.tau, base.mu0, base.s0)
        z = noise + base.gp.sigma
        return out - ((base.alpha + 1.0) * jnp.log(z) + base.beta / z) + jnp.log(noise)

    return lp


def log_prior_u(u: jnp.ndarray) -> jnp.ndarray:
    return -0.5 * jnp.sum(u * u)


def t_log_prior_density(t: jnp.ndarray, p: float, q: float, tau: float) -> jnp.ndarray:
    """log p(t) ∝ −p·log t − (t/τ)^(−q): the reference's penalty with sign
    flipped to a density (src/train.cpp:22)."""
    return -(p * jnp.log(t + EPS) + (t / tau) ** (-q))


def bernoulli_logit_loglik(f: jnp.ndarray, Y: jnp.ndarray, N: jnp.ndarray) -> jnp.ndarray:
    """Binomial-logit log likelihood (counts Y of N trials)."""
    return jnp.sum(Y * jax.nn.log_sigmoid(f) + (N - Y) * jax.nn.log_sigmoid(-f))


def gaussian_loglik(f: jnp.ndarray, Y: jnp.ndarray, noise_var: jnp.ndarray) -> jnp.ndarray:
    return -0.5 * jnp.sum((Y - f) ** 2 / noise_var + jnp.log(2.0 * jnp.pi * noise_var))


def _theta_log_prior(theta, t, p, q, tau, mu0, s0):
    """Proper prior density in θ = log t: lognormal base N(θ; μ0, s0²)
    tilted by the reference's penalty (src/train.h:139-140).

    The penalty alone, with the log-t Jacobian, is IMPROPER upward: its
    θ-density grows like e^{(1−p)θ}, and once t is large enough that the
    heat kernel washes out (f → 0, likelihood → chance) the posterior runs
    away to θ = ∞.  Narrow-trajectory samplers never found the runaway
    (chains sat in the likelihood mode); the wide-exploring ChEES warmup
    did, within 500 iterations.  The lognormal base makes the target proper
    and matches the SMC/quadrature hyperposterior EXACTLY
    (inference.hyperparam: log_prior=_q0_logpdf + tilt=_penalty_tilt), so
    every tier of the inference stack now describes one posterior."""
    z = (theta - mu0) / s0
    base = -0.5 * z * z - jnp.log(s0) - 0.5 * jnp.log(2.0 * jnp.pi)
    return base + t_log_prior_density(t, p, q, tau)


class GpcLogPost(NamedTuple):
    """Joint log posterior of (u, log t) for the heat-kernel GPC.

    Flattened parameter layout: x = [u (K,), log_t (1,)].  The t-prior is
    the proper lognormal-tilted density of :func:`_theta_log_prior` —
    identical to the SMC/quadrature hyperposterior target.
    """

    gp: WhitenedGP
    Y: jnp.ndarray
    N: jnp.ndarray
    p: float
    q: float
    tau: float
    mu0: float = 2.3
    s0: float = 1.5

    @property
    def dim(self) -> int:
        return self.gp.V.shape[1] + 1

    def unpack(self, x):
        return x[:-1], jnp.exp(x[-1])

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        u, t = self.unpack(x)
        f = latent_f(self.gp, u, t)
        lp = log_prior_u(u) + bernoulli_logit_loglik(f, self.Y, self.N)
        lp = lp + _theta_log_prior(x[-1], t, self.p, self.q, self.tau, self.mu0, self.s0)
        return lp


class GprLogPost(NamedTuple):
    """Joint log posterior of (u, log t, log noise) for heat-kernel GPR.

    Flattened layout: x = [u (K,), log_t, log_noise].  The t-prior is the
    proper lognormal-tilted density of :func:`_theta_log_prior` (the
    noise prior is already proper in log-noise: inverse-gamma × Jacobian
    decays at both ends for α > 0)."""

    gp: WhitenedGP
    Y: jnp.ndarray
    p: float
    q: float
    tau: float
    alpha: float
    beta: float
    mu0: float = 2.3
    s0: float = 1.5

    @property
    def dim(self) -> int:
        return self.gp.V.shape[1] + 2

    def unpack(self, x):
        return x[:-2], jnp.exp(x[-2]), jnp.exp(x[-1])

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        u, t, noise = self.unpack(x)
        f = latent_f(self.gp, u, t)
        lp = log_prior_u(u) + gaussian_loglik(f, self.Y, noise + self.gp.sigma)
        lp = lp + _theta_log_prior(x[-2], t, self.p, self.q, self.tau, self.mu0, self.s0)
        # inverse-gamma-style prior on noise+σ (src/train.cpp:342) + Jacobian
        z = noise + self.gp.sigma
        lp = lp - ((self.alpha + 1.0) * jnp.log(z) + self.beta / z) + jnp.log(noise)
        return lp
