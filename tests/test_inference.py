"""Inference-stack tests: HMC/NUTS posterior recovery on analytic targets,
SVI ELBO convergence, SMC evidence, diagnostics sanity (SURVEY §4(d))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flgp_tpu.inference.chees import halton2, run_chees, run_chees_fixed
from flgp_tpu.inference.diagnostics import ess, split_rhat
from flgp_tpu.inference.hmc import run_hmc
from flgp_tpu.inference.nuts import run_nuts
from flgp_tpu.inference.smc import run_smc
from flgp_tpu.inference.svi import fit_svi


DIM = 3
MEAN = np.array([1.0, -2.0, 0.5])
SCALES = np.array([1.0, 0.5, 2.0])


def gauss_logprob(x):
    return -0.5 * jnp.sum(((x - MEAN) / SCALES) ** 2)


class TestHmc:
    def test_gaussian_moments(self):
        x0 = jnp.zeros((4, DIM))
        run = run_hmc(
            jax.random.PRNGKey(0), gauss_logprob, x0,
            n_warmup=300, n_samples=600, n_leapfrog=8,
        )
        draws = np.asarray(run.samples).reshape(-1, DIM)
        np.testing.assert_allclose(draws.mean(0), MEAN, atol=0.2)
        np.testing.assert_allclose(draws.std(0), SCALES, rtol=0.25)
        assert float(np.mean(np.asarray(run.accept_prob))) > 0.5

    def test_rhat_near_one(self):
        run = run_hmc(
            jax.random.PRNGKey(1), gauss_logprob, jnp.zeros((4, DIM)),
            n_warmup=300, n_samples=600, n_leapfrog=8,
        )
        rhat = np.asarray(split_rhat(run.samples))
        assert np.all(rhat < 1.1), rhat


class TestNuts:
    def test_gaussian_moments(self):
        run = run_nuts(
            jax.random.PRNGKey(0), gauss_logprob, jnp.zeros((4, DIM)),
            n_warmup=200, n_samples=400, max_depth=6,
        )
        draws = np.asarray(run.samples).reshape(-1, DIM)
        np.testing.assert_allclose(draws.mean(0), MEAN, atol=0.25)
        np.testing.assert_allclose(draws.std(0), SCALES, rtol=0.3)

    def test_fixed_chunked_driver(self):
        """Watchdog-bounded multi-dispatch steady-state NUTS (the guard for
        the round-4 16384-chain worker crash): same kernel, bounded
        dispatches, healthy moments, and honest leapfrog counts."""
        from flgp_tpu.inference.nuts import run_nuts_fixed_chunked

        adapt = run_nuts(
            jax.random.PRNGKey(5), gauss_logprob, jnp.zeros((4, DIM)),
            n_warmup=200, n_samples=50, max_depth=6,
        )
        run = run_nuts_fixed_chunked(
            jax.random.PRNGKey(6), gauss_logprob, adapt.samples[-1],
            adapt.step, adapt.inv_mass, n_samples=400, max_depth=6,
            max_dispatch_seconds=0.5,
        )
        assert run.samples.shape == (400, 4, DIM)
        assert run.n_leapfrog.shape == (400, 4)
        assert int(jnp.min(run.n_leapfrog)) >= 1
        draws = np.asarray(run.samples).reshape(-1, DIM)
        np.testing.assert_allclose(draws.mean(0), MEAN, atol=0.3)
        np.testing.assert_allclose(draws.std(0), SCALES, rtol=0.3)

    def test_correlated_gaussian(self):
        rho = 0.9
        cov = np.array([[1.0, rho], [rho, 1.0]])
        prec = jnp.asarray(np.linalg.inv(cov))

        def logprob(x):
            return -0.5 * x @ prec @ x

        run = run_nuts(
            jax.random.PRNGKey(2), logprob, jnp.zeros((4, 2)),
            n_warmup=300, n_samples=500, max_depth=8,
        )
        draws = np.asarray(run.samples).reshape(-1, 2)
        got = np.corrcoef(draws.T)[0, 1]
        np.testing.assert_allclose(got, rho, atol=0.1)


class TestLogpostPrecision:
    def test_closure_matches_namedtuple_posterior(self):
        """logpost_with_precision must evaluate the SAME density as the base
        (on CPU all precisions are exact, so values match bit-for-bit)."""
        from flgp_tpu.models.latent import (
            GpcLogPost, GprLogPost, WhitenedGP, logpost_with_precision,
        )

        rng = np.random.default_rng(0)
        m, K = 20, 8
        gp = WhitenedGP(
            jnp.asarray(rng.normal(size=(m, K))),
            jnp.asarray(np.linspace(0, 1, K)),
            1e-3,
        )
        Y = jnp.asarray((rng.uniform(size=m) > 0.5).astype(float))
        gpc = GpcLogPost(gp, Y, jnp.ones((m,)), 1e-2, 10.0, 2.0)
        x = jnp.asarray(rng.normal(size=K + 1))
        fast = logpost_with_precision(gpc, jax.lax.Precision.DEFAULT)
        assert float(fast(x)) == float(gpc(x))

        gpr = GprLogPost(gp, jnp.asarray(rng.normal(size=m)), 1e-2, 10.0, 2.0, 0.1, 1e-3)
        xr = jnp.asarray(rng.normal(size=K + 2))
        fastr = logpost_with_precision(gpr, jax.lax.Precision.DEFAULT)
        assert float(fastr(xr)) == float(gpr(xr))


class TestChees:
    """Cross-chain-adaptive trajectory-length HMC (inference.chees): the
    wide-batch replacement for vmapped NUTS (whose lockstep tree-doubling
    collapses past ~1024 chains)."""

    def test_halton_low_discrepancy(self):
        h = np.asarray(jax.vmap(halton2)(jnp.arange(1, 257, dtype=jnp.int32)))
        assert np.all((h > 0) & (h < 1))
        # base-2 radical inverse of 1..256 is exactly {k/256 grid}-dense:
        # every length-1/16 subinterval contains 16 points
        counts, _ = np.histogram(h, bins=16, range=(0, 1))
        assert counts.min() == counts.max() == 16

    def test_ill_conditioned_gaussian_moments_and_metric(self):
        d = 16
        scales = np.geomspace(1.0, 30.0, d)
        mean = np.linspace(-2, 2, d)

        def logprob(x):
            return -0.5 * jnp.sum(((x - mean) / scales) ** 2)

        run = jax.jit(
            lambda k, x: run_chees(k, logprob, x, n_warmup=400, n_samples=600)
        )(jax.random.PRNGKey(0), jnp.zeros((32, d)))
        S = np.asarray(run.samples).reshape(-1, d)
        np.testing.assert_allclose(S.mean(0), mean, atol=0.3)
        np.testing.assert_allclose(S.std(0), scales, rtol=0.15)
        # the cross-chain EMA metric should recover the marginal variances
        np.testing.assert_allclose(np.asarray(run.inv_mass), scales**2, rtol=0.5)
        # and the shared step should land acceptance in a sane band around
        # the 0.651 target (harmonic-mean control is intentionally conservative)
        acc = float(np.mean(np.asarray(run.accept_prob)))
        assert 0.55 < acc < 0.95, acc

    def test_ess_per_gradient_beats_fixed_hmc_floor(self):
        """The adapted trajectory must actually buy mixing: min-ESS per
        gradient evaluation on the conditioned Gaussian well above the
        1-leapfrog random-walk floor (~1e-3 here) and within NUTS's class."""
        d = 16
        scales = np.geomspace(1.0, 30.0, d)

        def logprob(x):
            return -0.5 * jnp.sum((x / scales) ** 2)

        run = jax.jit(
            lambda k, x: run_chees(k, logprob, x, n_warmup=400, n_samples=600)
        )(jax.random.PRNGKey(1), jnp.zeros((32, d)))
        e = ess(np.asarray(run.samples))
        grads = int(run.n_leapfrog_total) * 32
        assert e.min() / grads > 0.02, (e.min(), grads)

    def test_inv_mass0_seed_survives_short_warmup(self):
        """With an analytic metric seed and a warmup too short to rediscover
        a 900x-condition scaling from ones, the seeded run must still sample
        the broad coordinates correctly (same contract as hmc.run_hmc)."""
        d = 12
        scales = np.geomspace(1.0, 30.0, d)

        def logprob(x):
            return -0.5 * jnp.sum((x / scales) ** 2)

        run = jax.jit(
            lambda k, x: run_chees(
                k, logprob, x, n_warmup=120, n_samples=400,
                inv_mass0=jnp.asarray(scales**2),
            )
        )(jax.random.PRNGKey(4), jnp.zeros((32, d)))
        S = np.asarray(run.samples).reshape(-1, d)
        np.testing.assert_allclose(S.std(0), scales, rtol=0.2)
        # the seed is in effect until enough robust-EMA updates accumulate,
        # then refined — either way the final metric must stay within ~2x
        np.testing.assert_allclose(np.asarray(run.inv_mass), scales**2, rtol=1.0)

    def test_fixed_continuation_matches_adaptive_moments(self):
        d = 8
        scales = np.geomspace(1.0, 10.0, d)

        def logprob(x):
            return -0.5 * jnp.sum((x / scales) ** 2)

        run = jax.jit(
            lambda k, x: run_chees(k, logprob, x, n_warmup=300, n_samples=200)
        )(jax.random.PRNGKey(2), jnp.zeros((16, d)))
        cont = jax.jit(
            lambda k, x: run_chees_fixed(
                k, logprob, x, run.step, run.traj_len, run.inv_mass, n_samples=600
            )
        )(jax.random.PRNGKey(3), run.samples[-1])
        S = np.asarray(cont.samples).reshape(-1, d)
        np.testing.assert_allclose(S.mean(0), 0.0, atol=0.4)
        np.testing.assert_allclose(S.std(0), scales, rtol=0.15)
        rhat = np.asarray(split_rhat(cont.samples))
        assert np.all(rhat < 1.05), rhat


class TestSvi:
    def test_gaussian_recovery(self):
        res = fit_svi(
            jax.random.PRNGKey(0), gauss_logprob, DIM,
            steps=1500, n_mc=8, lr=0.05, dtype=jnp.float64,
        )
        # per-dim MC error scales with the target scale (dim 3 has σ = 2)
        np.testing.assert_allclose(np.asarray(res.posterior.mu), MEAN, atol=0.35)
        np.testing.assert_allclose(
            np.exp(np.asarray(res.posterior.log_scale)), SCALES, rtol=0.3
        )
        # ELBO should improve
        elbo = np.asarray(res.elbo_trace)
        assert elbo[-50:].mean() > elbo[:50].mean()

    def test_lowrank_recovers_correlation(self):
        """Correlated Gaussian target: the rank-2 family must recover the
        off-diagonal structure the mean-field family zeroes (its documented
        limitation), and beat it on ELBO."""
        from flgp_tpu.inference.svi import fit_svi_lowrank

        rng = np.random.default_rng(3)
        d = 6
        F = rng.normal(size=(d, 2)) * 0.8
        cov = np.diag(np.full(d, 0.3)) + F @ F.T
        prec = jnp.asarray(np.linalg.inv(cov))
        mu = jnp.asarray(np.linspace(-1, 1, d))

        def logprob(x):
            dx = x - mu
            return -0.5 * dx @ prec @ dx

        lr_res = fit_svi_lowrank(
            jax.random.PRNGKey(0), logprob, d, rank=2,
            steps=4000, n_mc=16, lr=0.03, dtype=jnp.float64,
        )
        mf_res = fit_svi(
            jax.random.PRNGKey(0), logprob, d,
            steps=4000, n_mc=16, lr=0.03, dtype=jnp.float64,
        )
        np.testing.assert_allclose(np.asarray(lr_res.posterior.mu), np.asarray(mu), atol=0.15)
        cov_q = np.asarray(lr_res.posterior.covariance())
        # off-diagonal recovery where the target correlation is substantial
        corr = cov / np.sqrt(np.outer(np.diag(cov), np.diag(cov)))
        corr_q = cov_q / np.sqrt(np.outer(np.diag(cov_q), np.diag(cov_q)))
        big = np.abs(corr) > 0.4
        np.testing.assert_allclose(corr_q[big], corr[big], atol=0.25)
        assert float(np.mean(np.asarray(lr_res.elbo_trace)[-200:])) > float(
            np.mean(np.asarray(mf_res.elbo_trace)[-200:])
        )


class TestSmc:
    def test_gaussian_evidence(self):
        """Prior N(0, 1)ᵈ, likelihood N(x; μ, σ²)ᵈ: log Z analytic."""
        mu = np.array([0.5, -0.5])
        s2 = 0.5**2

        def log_prior(x):
            return -0.5 * jnp.sum(x * x) - 0.5 * 2 * jnp.log(2 * jnp.pi)

        def log_like(x):
            return -0.5 * jnp.sum((x - mu) ** 2) / s2 - 0.5 * 2 * jnp.log(2 * jnp.pi * s2)

        # analytic evidence of ∫ N(x;0,I) N(x;mu,s2 I) dx per-dim
        var = 1.0 + s2
        logZ = np.sum(-0.5 * np.log(2 * np.pi * var) - 0.5 * mu**2 / var)

        n_part = 512
        x0 = jax.random.normal(jax.random.PRNGKey(0), (n_part, 2))
        res = run_smc(
            jax.random.PRNGKey(1), log_prior, log_like, x0,
            n_mutation_steps=5, n_leapfrog=8,
        )
        np.testing.assert_allclose(float(res.log_evidence), logZ, atol=0.15)
        # posterior mean: (mu/s2)/(1+1/s2)
        post_mean = mu / s2 / (1 + 1 / s2)
        np.testing.assert_allclose(
            np.asarray(res.particles).mean(0), post_mean, atol=0.15
        )

    def test_rwm_mutation_gaussian_evidence(self):
        """Same analytic target, gradient-free RWM mutations."""
        mu = np.array([0.5, -0.5])
        s2 = 0.5**2

        def log_prior(x):
            return -0.5 * jnp.sum(x * x) - 0.5 * 2 * jnp.log(2 * jnp.pi)

        def log_like(x):
            return -0.5 * jnp.sum((x - mu) ** 2) / s2 - 0.5 * 2 * jnp.log(2 * jnp.pi * s2)

        var = 1.0 + s2
        logZ = np.sum(-0.5 * np.log(2 * np.pi * var) - 0.5 * mu**2 / var)
        x0 = jax.random.normal(jax.random.PRNGKey(2), (512, 2))
        res = run_smc(
            jax.random.PRNGKey(3), log_prior, log_like, x0,
            n_mutation_steps=10, mutation="rwm", step_size=0.5,
        )
        np.testing.assert_allclose(float(res.log_evidence), logZ, atol=0.2)
        post_mean = mu / s2 / (1 + 1 / s2)
        np.testing.assert_allclose(
            np.asarray(res.particles).mean(0), post_mean, atol=0.15
        )

    def test_chunked_driver_bit_identical(self):
        """run_smc_chunked applies the same stage body under a truncated
        while_loop bound — particles, evidence, and temperature ladder must
        match the monolithic driver exactly."""
        from flgp_tpu.inference.smc import run_smc_chunked

        mu = np.array([0.5, -0.5])
        s2 = 0.5**2

        def log_prior(x):
            return -0.5 * jnp.sum(x * x) - 0.5 * 2 * jnp.log(2 * jnp.pi)

        def log_like(x):
            return -0.5 * jnp.sum((x - mu) ** 2) / s2 - 0.5 * 2 * jnp.log(2 * jnp.pi * s2)

        x0 = jax.random.normal(jax.random.PRNGKey(0), (128, 2))
        mono = run_smc(
            jax.random.PRNGKey(1), log_prior, log_like, x0,
            n_mutation_steps=3, mutation="rwm", step_size=0.5,
        )
        for chunk in (1, 3):
            ck = run_smc_chunked(
                jax.random.PRNGKey(1), log_prior, log_like, x0,
                stages_per_dispatch=chunk,
                n_mutation_steps=3, mutation="rwm", step_size=0.5,
            )
            assert int(ck.n_stages) == int(mono.n_stages)
            np.testing.assert_array_equal(
                np.asarray(ck.particles), np.asarray(mono.particles)
            )
            np.testing.assert_array_equal(
                np.asarray(ck.temperatures), np.asarray(mono.temperatures)
            )
            assert float(ck.log_evidence) == float(mono.log_evidence)

    def test_rejects_unknown_mutation(self):
        with pytest.raises(ValueError):
            run_smc(
                jax.random.PRNGKey(0), lambda x: 0.0, lambda x: 0.0,
                jnp.zeros((4, 1)), mutation="nope",
            )


class TestHyperparamSmc:
    """SMC posterior over log t against the Laplace GPC marginal."""

    def _toy_eigenpair(self, rng, n=60, K=12):
        from flgp_tpu.types import EigenPair

        Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        vectors = jnp.asarray(Q[:, :K] * np.sqrt(n))
        # eigenvalues of W in (0, 1], descending — Laplacian evals 1-λ ascending
        values = jnp.asarray(np.sort(rng.uniform(0.2, 1.0, K))[::-1].copy())
        return EigenPair(values, vectors)

    def test_binary_concentrates_near_grid_optimum(self, rng, key):
        from flgp_tpu.inference.hyperparam import gpc_t_posterior
        from flgp_tpu.models.gpc import gpc_nlp_objective

        eig = self._toy_eigenpair(rng)
        m, K, sigma = 40, 12, 1e-3
        idx = jnp.arange(m)
        # labels generated from a draw at a known t so the posterior is informative
        from flgp_tpu.models.latent import WhitenedGP, latent_f, make_whitened

        gp = make_whitened(eig, idx, K, sigma)
        f = latent_f(gp, jnp.asarray(rng.normal(size=K)), 3.0)
        Y = (jax.nn.sigmoid(f) > 0.5).astype(eig.vectors.dtype)

        post = gpc_t_posterior(key, eig, Y, idx, K, sigma, n_particles=128)
        assert np.isfinite(float(post.log_evidence))
        t_mean = float(post.t_mean)
        assert 1e-2 < t_mean < 1e3

        # the posterior mass should sit near the 1-D grid optimum of the
        # reference "posterior" objective (same density up to normalization)
        ts = np.exp(np.linspace(-2, 5, 60))
        objs = [float(gpc_nlp_objective(eig, Y, jnp.ones((m,)), idx, K, t, sigma)) for t in ts]
        t_star = ts[int(np.argmin(objs))]
        assert abs(np.log(t_mean) - np.log(t_star)) < 1.5

    def test_multiclass_shapes_and_finite(self, rng, key):
        from flgp_tpu.fit.multiclass import one_hot_labels
        from flgp_tpu.inference.hyperparam import mult_t_posterior

        eig = self._toy_eigenpair(rng)
        m, K, J = 30, 12, 3
        labels = jnp.asarray(rng.integers(0, J, size=m))
        aug = one_hot_labels(labels, J)
        post = mult_t_posterior(
            key, eig, aug, jnp.arange(m), K, 1e-3, n_particles=32,
            n_mutation_steps=3,
        )
        assert post.t.shape == (32, J)
        assert post.t_mean.shape == (J,)
        assert np.isfinite(float(post.log_evidence))
        assert (np.asarray(post.t) > 0).all()


class TestDiagnostics:
    def test_ess_iid(self):
        draws = np.random.default_rng(0).normal(size=(500, 4, 2))
        e = ess(draws)
        assert np.all(e > 1000), e  # iid: ESS ≈ n·chains = 2000

    def test_rhat_diverged_chains(self):
        rng = np.random.default_rng(0)
        draws = rng.normal(size=(300, 4, 1))
        draws[:, 0, :] += 10.0  # one chain far away
        r = np.asarray(split_rhat(jnp.asarray(draws)))
        assert r[0] > 1.5


class TestMatheronConditionalDraw:
    """The single-Cholesky f | ω draw is EXACTLY N(μ, Σ): the map is linear
    in (ε₁, ε₂), so its Jacobian gives the covariance analytically — no
    Monte-Carlo tolerance needed."""

    def test_mean_and_covariance_exact(self, rng):
        from flgp_tpu.inference.pg_gibbs import _conditional_draw
        from flgp_tpu.ops import linalg

        m = 12
        A = rng.normal(size=(m, 5))
        C = jnp.asarray(A @ A.T / 5 + 0.1 * np.eye(m))
        omega = jnp.asarray(rng.gamma(2.0, 0.5, size=m))
        Y = (rng.uniform(size=m) > 0.5).astype(float)
        kappa = jnp.asarray(Y - 0.5)
        L_C = linalg.cholesky(C)

        # dense oracle: Σ = C − C√ωB⁻¹√ωC, μ = Σκ (GPML Eq 3.27)
        sq = np.sqrt(np.asarray(omega))
        Cn = np.asarray(C)
        B = sq[:, None] * Cn * sq[None, :] + np.eye(m)
        Sigma = Cn - Cn @ (sq[:, None] * np.linalg.solve(B, sq[:, None] * Cn))
        mu = Sigma @ np.asarray(kappa)

        zero = jnp.zeros((m,))
        f_mu = _conditional_draw(C, L_C, kappa, omega, zero, zero)
        np.testing.assert_allclose(np.asarray(f_mu), mu, atol=1e-9)

        J1 = jax.jacobian(lambda e: _conditional_draw(C, L_C, kappa, omega, e, zero))(zero)
        J2 = jax.jacobian(lambda e: _conditional_draw(C, L_C, kappa, omega, zero, e))(zero)
        cov = np.asarray(J1 @ J1.T + J2 @ J2.T)
        np.testing.assert_allclose(cov, Sigma, atol=1e-9)


class TestRaoBlackwellPredictor:
    def test_avg_zero_is_reference_semantics(self, rng, key):
        from flgp_tpu.inference import pg_gibbs

        m, n_new = 24, 10
        A = rng.normal(size=(m, 6))
        C = jnp.asarray(A @ A.T / 6 + 0.1 * np.eye(m))
        Y = jnp.asarray((rng.uniform(size=m) > 0.5).astype(float))
        Cnv = jnp.asarray(rng.normal(size=(n_new, m)) @ np.asarray(C) / m)
        C_all = jnp.concatenate([C, Cnv], axis=0)

        final, _ = pg_gibbs.pg_gibbs_chain(key, C, Y, 30)
        pi_ref = pg_gibbs.collapsed_predict(C, C_all, Y, final.omega)
        _, pi0 = pg_gibbs.test_pgbinary(key, C, Y, C_all, 30, avg_sweeps=0)
        np.testing.assert_allclose(np.asarray(pi0), np.asarray(pi_ref), atol=1e-12)

    def test_avg_matches_manual_mean(self, rng, key):
        from flgp_tpu.inference import pg_gibbs

        m = 16
        A = rng.normal(size=(m, 5))
        C = jnp.asarray(A @ A.T / 5 + 0.1 * np.eye(m))
        Y = jnp.asarray((rng.uniform(size=m) > 0.5).astype(float))
        C_all = jnp.concatenate([C, C[:4]], axis=0)

        S = 8
        _, _, om_trace = pg_gibbs.pg_gibbs_chain_trace(key, C, Y, 20)
        pis = np.stack([
            np.asarray(pg_gibbs.collapsed_predict(C, C_all, Y, om_trace[-S + i]))
            for i in range(S)
        ])
        _, pi = pg_gibbs.test_pgbinary(key, C, Y, C_all, 20, avg_sweeps=S)
        np.testing.assert_allclose(np.asarray(pi), pis.mean(0), atol=1e-10)
        assert ((np.asarray(pi) >= 0) & (np.asarray(pi) <= 1)).all()


class TestPosteriorMomentCrossValidation:
    """BASELINE: "match FLGP posterior moments within Monte-Carlo error".

    PG-Gibbs (the reference's sampler, src/PGLogitModel.cpp), whitened HMC,
    and whitened NUTS all target the SAME binary-GPC posterior — their f
    moments at the training points must agree within MC error; the Laplace
    approximation (src/Utils.cpp:252-299) agrees within its approximation
    error.  One shared problem, all four inference engines.
    """

    def _problem(self):
        rng = np.random.default_rng(7)
        m, K, t, sigma = 32, 8, 4.0, 1e-3
        Q, _ = np.linalg.qr(rng.normal(size=(m, m)))
        V = jnp.asarray(Q[:, :K] * np.sqrt(m))
        lam_W = jnp.asarray(np.linspace(0.95, 0.3, K))
        from flgp_tpu.types import EigenPair

        eig = EigenPair(lam_W, V)
        Y = jnp.asarray((rng.uniform(size=m) > 0.5).astype(float))
        return eig, Y, m, K, t, sigma

    def test_pg_hmc_nuts_laplace_agree(self, key):
        from flgp_tpu.inference.diagnostics import ess
        from flgp_tpu.inference.hmc import run_hmc
        from flgp_tpu.inference.nuts import run_nuts
        from flgp_tpu.inference.pg_gibbs import pg_gibbs_chain
        from flgp_tpu.models import gpc as gpc_mod
        from flgp_tpu.models.latent import bernoulli_logit_loglik, log_prior_u
        from flgp_tpu.ops import linalg
        from flgp_tpu.ops.heat_kernel import heat_kernel

        eig, Y, m, K, t, sigma = self._problem()
        N = jnp.ones((m,))
        idx = jnp.arange(m)
        C = heat_kernel(eig, t, K, idx, idx)
        C = linalg.add_diag(C, jnp.full((m,), sigma, C.dtype))

        # ---- PG-Gibbs (exact augmentation) -------------------------------
        _, f_trace = pg_gibbs_chain(jax.random.PRNGKey(10), C, Y, n_sweeps=4000)
        f_pg = f_trace[500:]
        pg_mean = np.asarray(jnp.mean(f_pg, 0))
        pg_var = np.asarray(jnp.var(f_pg, 0))
        pg_mc = np.sqrt(pg_var / np.maximum(ess(np.asarray(f_pg)[:, None, :]), 10.0))

        # ---- whitened HMC / NUTS on the identical model -------------------
        # f = V Λ_t^{1/2} u + √σ w  (the extra m whitened dims reproduce the
        # σ ridge exactly, so all samplers share one posterior)
        lam = 1.0 - eig.values[:K]
        scale = jnp.exp(-0.5 * t * lam)
        Phi = eig.vectors[:, :K] * scale[None, :]

        def logprob(x):
            u, w = x[:K], x[K:]
            f = Phi @ u + jnp.sqrt(sigma) * w
            return log_prior_u(x) + bernoulli_logit_loglik(f, Y, N)

        def f_draws(samples):
            S, Cn, _ = samples.shape
            flat = samples.reshape(S * Cn, -1)
            return flat[:, :K] @ Phi.T + jnp.sqrt(sigma) * flat[:, K:]

        x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(11), (8, K + m))
        hmc = run_hmc(jax.random.PRNGKey(12), logprob, x0, n_warmup=300,
                      n_samples=600, n_leapfrog=16)
        f_hmc = f_draws(hmc.samples)
        nuts = run_nuts(jax.random.PRNGKey(13), logprob, x0[:4], n_warmup=300,
                        n_samples=400, max_depth=7)
        f_nuts = f_draws(nuts.samples)

        # ---- Laplace moments at the train points --------------------------
        la_mean, _ = gpc_mod.gpc_posterior_moments(C, C, jnp.diagonal(C), Y)

        tol = 6.0 * pg_mc + 0.05  # MC error of both sides + slack
        for name, f_s in (("hmc", f_hmc), ("nuts", f_nuts)):
            mean_s = np.asarray(jnp.mean(f_s, 0))
            var_s = np.asarray(jnp.var(f_s, 0))
            assert np.all(np.abs(mean_s - pg_mean) < tol), (
                f"{name} mean disagrees with PG-Gibbs beyond MC error: "
                f"{np.max(np.abs(mean_s - pg_mean)):.4f}"
            )
            ratio = var_s / pg_var
            assert 0.6 < float(np.median(ratio)) < 1.6, f"{name} variance off: {ratio}"

        # Laplace is an approximation — generous but bounded agreement
        assert np.all(np.abs(la_mean - pg_mean) < 0.30 + 6.0 * pg_mc)
        corr = np.corrcoef(np.asarray(la_mean), pg_mean)[0, 1]
        assert corr > 0.98


class TestInvMassSeed:
    """inv_mass0 warmup-metric seeding (the Nyström-pathology mitigation
    layer under the rcond fix): a strongly anisotropic Gaussian must reach
    nominal moments from a correctly seeded metric, and the analytic
    whitened-GP preconditioner must order coordinates by feature scale."""

    def test_hmc_anisotropic_with_seed(self):
        scales = jnp.asarray([100.0, 10.0, 1.0, 0.1, 0.01])

        def logprob(x):
            return -0.5 * jnp.sum((x / scales) ** 2)

        run = run_hmc(
            jax.random.PRNGKey(3), logprob, jnp.zeros((4, 5)),
            n_warmup=400, n_samples=600, n_leapfrog=8,
            inv_mass0=scales**2,
        )
        draws = np.asarray(run.samples).reshape(-1, 5)
        np.testing.assert_allclose(draws.std(0), np.asarray(scales), rtol=0.35)

    def test_whitened_inv_mass0_ordering(self):
        from flgp_tpu.models.latent import WhitenedGP, whitened_inv_mass0

        rng = np.random.default_rng(0)
        V = jnp.asarray(rng.normal(size=(50, 8)), jnp.float32)
        # eigenvalue spread: lam 0 (strong feature) .. 1 (heat-damped away)
        lam = jnp.linspace(0.0, 1.0, 8, dtype=jnp.float32)
        gp = WhitenedGP(V, lam, 1e-3)
        im0 = np.asarray(whitened_inv_mass0(gp, t0=10.0, obs_curvature=0.25, n_hyper=2))
        assert im0.shape == (10,)
        assert np.all(im0[:8] <= 1.0) and np.all(im0 > 0.0)
        # heat-damped columns carry less likelihood curvature -> larger var
        assert im0[7] > im0[0]
        np.testing.assert_allclose(im0[8:], 1.0)
