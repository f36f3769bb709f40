"""Model-layer tests: GPR/GPC likelihoods vs NumPy oracles, PG sampler
moments, optimizer sanity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracles
from flgp_tpu.inference import pg_gibbs
from flgp_tpu.inference.optimize import adam_minimize, minimize_1d_log, minimize_t_noise
from flgp_tpu.models import gpc as gpc_mod
from flgp_tpu.models import gpr as gpr_mod
from flgp_tpu.ops.polya_gamma import polya_gamma
from flgp_tpu.types import EigenPair


def _rand_eigenpair(rng, n=60, K=20):
    """Synthetic spectral pair with values in (0, 1) like a real W spectrum."""
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    vectors = Q[:, :K] * np.sqrt(n)
    values = np.sort(rng.uniform(0.2, 1.0, size=K))[::-1]
    values[0] = 1.0
    return EigenPair(jnp.asarray(values), jnp.asarray(vectors)), values, vectors


class TestGprNmll:
    def test_direct_branch_matches_oracle(self, rng):
        eig, values, vectors = _rand_eigenpair(rng, n=50, K=30)
        m = 20  # m <= K
        idx = jnp.arange(m)
        Y = jnp.asarray(rng.normal(size=(m,)))
        got = gpr_mod.gpr_nmll(eig, Y, idx, 30, 2.0, 0.5, 1e-5)
        expect = oracles.gpr_nmll_direct_np(values, vectors, np.asarray(Y), np.arange(m), 30, 2.0, 0.5, 1e-5)
        np.testing.assert_allclose(float(got), expect, rtol=1e-8)

    def test_woodbury_branch_matches_oracle(self, rng):
        eig, values, vectors = _rand_eigenpair(rng, n=60, K=10)
        m = 40  # m > K
        idx = jnp.arange(m)
        Y = jnp.asarray(rng.normal(size=(m,)))
        got = gpr_mod.gpr_nmll(eig, Y, idx, 10, 1.5, 0.3, 1e-5)
        expect = oracles.gpr_nmll_woodbury_np(values, vectors, np.asarray(Y), np.arange(m), 10, 1.5, 0.3, 1e-5)
        np.testing.assert_allclose(float(got), expect, rtol=1e-8)

    def test_branches_agree(self, rng):
        """Direct and Woodbury compute the same NMLL when both applicable."""
        eig, values, vectors = _rand_eigenpair(rng, n=50, K=25)
        m = 20
        idx = np.arange(m)
        d = oracles.gpr_nmll_direct_np(values, vectors, rng.normal(size=(m,)), idx, 25, 2.0, 0.5, 1e-5)
        # compare through oracle for fixed Y
        Y = rng.normal(size=(m,))
        d = oracles.gpr_nmll_direct_np(values, vectors, Y, idx, 25, 2.0, 0.5, 1e-5)
        w = oracles.gpr_nmll_woodbury_np(values, vectors, Y, idx, 25, 2.0, 0.5, 1e-5)
        np.testing.assert_allclose(d, w, rtol=1e-6)

    def test_autodiff_grad_matches_fd(self, rng):
        eig, _, _ = _rand_eigenpair(rng, n=40, K=10)
        m = 30
        idx = jnp.arange(m)
        Y = jnp.asarray(rng.normal(size=(m,)))

        def f(t, noise):
            return gpr_mod.gpr_nmll(eig, Y, idx, 10, t, noise, 1e-5)

        g = jax.grad(f, argnums=(0, 1))(2.0, 0.5)
        eps = 1e-5
        fd_t = (f(2.0 + eps, 0.5) - f(2.0 - eps, 0.5)) / (2 * eps)
        fd_n = (f(2.0, 0.5 + eps) - f(2.0, 0.5 - eps)) / (2 * eps)
        np.testing.assert_allclose(float(g[0]), float(fd_t), rtol=1e-4)
        np.testing.assert_allclose(float(g[1]), float(fd_n), rtol=1e-4)

    def test_diff_noise_vector(self, rng):
        eig, values, vectors = _rand_eigenpair(rng, n=40, K=10)
        m = 30
        idx = jnp.arange(m)
        Y = jnp.asarray(rng.normal(size=(m,)))
        noise = jnp.asarray(rng.uniform(0.1, 1.0, size=(m,)))
        got = gpr_mod.gpr_nmll(eig, Y, idx, 10, 1.0, noise, 1e-5)
        # dense oracle: full covariance with per-point noise
        C = oracles.heat_kernel_np(values, vectors, 10, 1.0, np.arange(m), np.arange(m))
        C = C + np.diag(np.asarray(noise) + 1e-5)
        L = np.linalg.cholesky(C)
        alpha = np.linalg.solve(C, np.asarray(Y)[:, None])
        # direct m>K Woodbury identity: same quadratic form + logdet
        expect = 0.5 * np.sum(np.asarray(Y)[:, None] * alpha) + np.sum(np.log(np.diag(L)))
        np.testing.assert_allclose(float(got), expect, rtol=1e-5)


class TestGprDiffNoiseReferenceParity:
    """Per-point-noise training parity: the repo's autodiff objective against
    NumPy transcriptions of the reference's hand-derived NMLL *and* analytic
    gradients (src/train.cpp:459-555, pre-clipping — the reference's clip at
    |g|≥10 / |g|≥1 is an NLopt-MMA stabilizer, not part of the objective)."""

    def test_direct_branch_value_and_grads(self, rng):
        eig, values, vectors = _rand_eigenpair(rng, n=50, K=30)
        m = 20  # m <= K → direct branch (src/train.cpp:470-499)
        idx = jnp.arange(m)
        Y = jnp.asarray(rng.normal(size=(m,)))
        noise = rng.uniform(0.1, 1.0, size=m)
        t = 1.7

        def f(tt, nv):
            return gpr_mod.gpr_nmll(eig, Y, idx, 30, tt, nv, 1e-5)

        got = f(t, jnp.asarray(noise))
        g_t, g_n = jax.grad(f, argnums=(0, 1))(t, jnp.asarray(noise))
        nmll, ref_gt, ref_gn = oracles.gpr_nmll_diff_noise_direct_np(
            values, vectors, np.asarray(Y), np.arange(m), 30, t, noise, 1e-5
        )
        np.testing.assert_allclose(float(got), nmll, rtol=1e-8)
        np.testing.assert_allclose(float(g_t), ref_gt, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(g_n), ref_gn, rtol=1e-6)

    def test_woodbury_branch_value_and_grads(self, rng):
        eig, values, vectors = _rand_eigenpair(rng, n=60, K=10)
        m = 40  # m > K → Woodbury branch (src/train.cpp:500-551)
        idx = jnp.arange(m)
        Y = jnp.asarray(rng.normal(size=(m,)))
        noise = rng.uniform(0.1, 1.0, size=m)
        t = 1.2

        def f(tt, nv):
            return gpr_mod.gpr_nmll(eig, Y, idx, 10, tt, nv, 1e-5)

        got = f(t, jnp.asarray(noise))
        g_t, g_n = jax.grad(f, argnums=(0, 1))(t, jnp.asarray(noise))
        nmll, ref_gt, ref_gn = oracles.gpr_nmll_diff_noise_woodbury_np(
            values, vectors, np.asarray(Y), np.arange(m), 10, t, noise, 1e-5
        )
        np.testing.assert_allclose(float(got), nmll, rtol=1e-8)
        np.testing.assert_allclose(float(g_t), ref_gt, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(g_n), ref_gn, rtol=1e-6)

    def test_posterior_prior_terms_match_reference(self, rng):
        """The diff-noise "posterior" objective adds p·log t + (t/τ)^{−q} and
        the per-point inverse-gamma prior averaged over m
        (src/train.cpp:438-457)."""
        eig, values, vectors = _rand_eigenpair(rng, n=40, K=10)
        m = 30
        idx = jnp.arange(m)
        Y = jnp.asarray(rng.normal(size=(m,)))
        noise = rng.uniform(0.1, 1.0, size=m)
        t, sigma = 1.5, 1e-5
        p, q, tau, al, be = 1e-2, 10.0, 2.0, 1e-1, 1e-3
        got = gpr_mod.gpr_nmll_posterior(
            eig, Y, idx, 10, t, jnp.asarray(noise), sigma,
            p=p, q=q, tau=tau, alpha=al, beta=be,
        )
        nmll, _, _ = oracles.gpr_nmll_diff_noise_woodbury_np(
            values, vectors, np.asarray(Y), np.arange(m), 10, t, noise, sigma
        )
        pr0 = p * np.log(t + 1e-9) + (t / tau) ** (-q)
        z = noise + sigma
        pr1 = np.mean((al + 1) * np.log(z) + be / z)
        np.testing.assert_allclose(float(got), nmll + pr0 + pr1, rtol=1e-7)


class TestGprPredict:
    def test_prediction_consistent_across_branches(self, rng):
        eig, values, vectors = _rand_eigenpair(rng, n=60, K=25)
        m, n = 20, 60
        Y = jnp.asarray(rng.normal(size=(m,)))
        idx0, idx1 = jnp.arange(m), jnp.arange(m, n)
        direct = gpr_mod.gpr_predict(eig, Y, idx0, idx1, 25, 2.0, 0.5, 1e-5)
        # force Woodbury by shrinking K below m
        eigK = EigenPair(eig.values[:10], eig.vectors)
        wood = gpr_mod.gpr_predict(eigK, Y, idx0, idx1, 10, 2.0, 0.5, 1e-5)
        # exact dense answer for K=25
        C = oracles.heat_kernel_np(values, vectors, 25, 2.0, np.arange(m), np.arange(m))
        Cn = oracles.heat_kernel_np(values, vectors, 25, 2.0, np.arange(m, n), np.arange(m))
        expect = Cn @ np.linalg.solve(C + (0.5 + 1e-5) * np.eye(m), np.asarray(Y))
        np.testing.assert_allclose(np.asarray(direct), expect, rtol=1e-6, atol=1e-8)
        # Woodbury with truncated spectrum approximates; check exact dense K=10
        C10 = oracles.heat_kernel_np(values, vectors, 10, 2.0, np.arange(m), np.arange(m))
        Cn10 = oracles.heat_kernel_np(values, vectors, 10, 2.0, np.arange(m, n), np.arange(m))
        expect10 = Cn10 @ np.linalg.solve(C10 + (0.5 + 1e-5) * np.eye(m), np.asarray(Y))
        np.testing.assert_allclose(np.asarray(wood), expect10, rtol=1e-5, atol=1e-7)

    def test_posterior_cov_positive(self, rng):
        eig, _, _ = _rand_eigenpair(rng, n=60, K=25)
        m, n = 20, 60
        cov = gpr_mod.gpr_posterior_cov(eig, jnp.arange(m), jnp.arange(m, n), 25, 2.0, 0.5, 1e-5)
        assert np.all(np.asarray(cov) > 0)


class TestGpcLaplace:
    def test_marginal_matches_oracle(self, rng):
        m = 25
        A = rng.normal(size=(m, m))
        C = A @ A.T / m + np.eye(m) * 0.1
        Y = (rng.uniform(size=m) > 0.5).astype(float)
        N = np.ones(m)
        got = gpc_mod.gpc_marginal_log_likelihood(jnp.asarray(C), jnp.asarray(Y), jnp.asarray(N))
        expect = oracles.laplace_marginal_np(C, Y, N)
        np.testing.assert_allclose(float(got), expect, rtol=1e-6)

    def test_marginal_binomial_counts(self, rng):
        m = 15
        A = rng.normal(size=(m, m))
        C = A @ A.T / m + np.eye(m) * 0.1
        N = rng.integers(1, 5, size=m).astype(float)
        Y = np.minimum(rng.integers(0, 5, size=m).astype(float), N)
        got = gpc_mod.gpc_marginal_log_likelihood(jnp.asarray(C), jnp.asarray(Y), jnp.asarray(N))
        expect = oracles.laplace_marginal_np(C, Y, N)
        np.testing.assert_allclose(float(got), expect, rtol=1e-6)

    def test_posterior_moments_match_oracle(self, rng):
        m, mn = 20, 10
        A = rng.normal(size=(m + mn, m + mn))
        Cfull = A @ A.T / (m + mn) + np.eye(m + mn) * 0.1
        C11 = Cfull[:m, :m]
        C21 = Cfull[m:, :m]
        C22 = np.diag(Cfull)[m:]
        Y = (rng.uniform(size=m) > 0.5).astype(float)
        mean, cov = gpc_mod.gpc_posterior_moments(
            jnp.asarray(C11), jnp.asarray(C21), jnp.asarray(C22), jnp.asarray(Y)
        )
        e_mean, e_cov = oracles.posterior_classification_np(C11, C21, C22, Y)
        np.testing.assert_allclose(np.asarray(mean), e_mean, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(np.asarray(cov), e_cov, rtol=1e-5, atol=1e-8)


class TestPolyaGamma:
    def test_moments_and_positivity(self, key):
        """All z values in one batched draw (single compile of the nested
        rejection loops)."""
        zs = np.array([0.0, 0.5, 2.0, 6.0, -3.0])
        n = 20000
        c = jnp.repeat(jnp.asarray(zs), n)
        draws = np.asarray(polya_gamma(key, c)).reshape(len(zs), n)
        assert draws.min() > 0
        for z, row in zip(zs, draws):
            expect = oracles.pg_mean_np(z)
            se = row.std() / np.sqrt(n)
            assert abs(row.mean() - expect) < 5 * se + 1e-4, (z, row.mean(), expect)


class TestPgGibbs:
    # shared (m, n_sweeps) across both tests so the compiled Gibbs scan
    # (with its nested PG rejection loops) is built exactly once
    M, SWEEPS = 32, 40

    def test_chain_runs_and_predicts(self, key, rng):
        m = self.M
        A = rng.normal(size=(m, m))
        C = A @ A.T / m + np.eye(m) * 0.5
        Y = (rng.uniform(size=m) > 0.5).astype(float)
        labels, pi = pg_gibbs.test_pgbinary(
            key, jnp.asarray(C), jnp.asarray(Y), jnp.asarray(C), n_sweeps=self.SWEEPS
        )
        assert labels.shape == (m,)
        assert np.all((np.asarray(pi) >= 0) & (np.asarray(pi) <= 1))

    def test_separable_problem_fits(self, key, rng):
        """Strongly separable latent: Gibbs prediction should recover labels."""
        m = self.M
        x = np.sort(rng.uniform(-2, 2, size=m))
        C = np.exp(-((x[:, None] - x[None, :]) ** 2) / 0.5) * 9.0 + np.eye(m) * 1e-4
        Y = (x > 0).astype(float)
        labels, _ = pg_gibbs.test_pgbinary(
            key, jnp.asarray(C), jnp.asarray(Y), jnp.asarray(C), n_sweeps=self.SWEEPS
        )
        err = np.mean(np.asarray(labels) != Y)
        assert err <= 0.1


class TestOptimizers:
    def test_1d_quadratic(self):
        res = minimize_1d_log(lambda t: (jnp.log(t) - 1.0) ** 2, lo=1e-2, hi=1e3, dtype=jnp.float64)
        np.testing.assert_allclose(float(res.x), np.e, rtol=1e-4)

    def test_expands_above_initial_window(self):
        # optimum at t = 5e4, window top 1e3: the reference's COBYLA is
        # unbounded above (src/train.cpp:45-58) — the scan must follow
        res = minimize_1d_log(
            lambda t: (jnp.log(t) - jnp.log(5e4)) ** 2, lo=1e-2, hi=1e3, dtype=jnp.float64
        )
        np.testing.assert_allclose(float(res.x), 5e4, rtol=1e-3)

    def test_adam_quadratic(self):
        res = adam_minimize(lambda x: jnp.sum((x - 2.0) ** 2), jnp.zeros(3), steps=500, lr=0.1)
        np.testing.assert_allclose(np.asarray(res.x), 2.0, atol=1e-2)

    def test_t_noise_rosenbrock_like(self):
        fn = lambda t, nz: (jnp.log(t) - 0.5) ** 2 + 2.0 * (jnp.log(nz) + 1.0) ** 2
        res = minimize_t_noise(fn, dtype=jnp.float64)
        np.testing.assert_allclose(float(jnp.log(res.t)), 0.5, atol=0.05)
        np.testing.assert_allclose(float(jnp.log(res.noise)), -1.0, atol=0.05)
        # status gradient describes the RETURNED point
        assert float(res.grad_norm) < 0.2

    def test_t_noisevec_multimodal_grid_seeding(self):
        """Multimodal heteroscedastic objective: in u = log t there is a
        shallow local basin at u=1 (next to the old fixed start u≈2.3) and
        the global basin at u=6.  Adam from the fixed start provably lands in
        the wrong basin; the coarse (t, homoscedastic-noise) grid seeding
        must find the global one."""
        from flgp_tpu.inference.optimize import minimize_t_noisevec

        m = 5
        targ = jnp.asarray(np.linspace(-1.5, -0.5, m))

        def h(u):
            return -jnp.log(jnp.exp(-((u - 1.0) ** 2)) + 5.0 * jnp.exp(-2.0 * (u - 6.0) ** 2))

        def fnv(t, noise):
            return h(jnp.log(t)) + jnp.sum((jnp.log(noise) - targ) ** 2)

        res = minimize_t_noisevec(fnv, m, dtype=jnp.float64)
        # global basin: u* = 6 → t* = e^6 ≈ 403, value ≈ −log 5
        np.testing.assert_allclose(float(jnp.log(res.t)), 6.0, atol=0.1)
        assert float(res.obj) < -1.0
        np.testing.assert_allclose(np.asarray(jnp.log(res.noise)), np.asarray(targ), atol=0.1)
        # the old fixed-x0 behavior demonstrably lands worse: Adam from
        # (t0=10, noise0=1) with NO grid (simulated via a 1-point grid at the
        # fixed start) stays in the shallow basin
        from flgp_tpu.inference.optimize import adam_minimize

        def obj_flat(x):
            return fnv(1e-3 + jnp.exp(x[0]), 1e-4 + jnp.exp(x[1:]))

        x0 = jnp.concatenate(
            [jnp.full((1,), jnp.log(10.0 - 1e-3)), jnp.full((m,), jnp.log(1.0 - 1e-4))]
        )
        old = adam_minimize(obj_flat, x0, steps=400, lr=0.05)
        assert float(old.obj) > float(res.obj) + 1.0
        assert abs(float(old.x[0]) - 6.0) > 1.0  # stuck outside the global basin


class TestLowRankGpcMarginal:
    def test_matches_dense_marginal(self):
        import numpy as np

        from flgp_tpu.models.gpc import (
            gpc_marginal_log_likelihood,
            gpc_marginal_log_likelihood_lowrank,
        )
        from flgp_tpu.ops import linalg

        rng = np.random.default_rng(0)
        m, K, sigma = 40, 8, 1e-3
        Phi = jnp.asarray(rng.normal(size=(m, K)) / np.sqrt(K))
        Y = jnp.asarray((rng.uniform(size=m) > 0.5).astype(float))
        N = jnp.ones((m,))
        C = Phi @ Phi.T
        C = linalg.add_diag(C, jnp.full((m,), sigma, C.dtype))
        dense = gpc_marginal_log_likelihood(C, Y, N)
        lowrank = gpc_marginal_log_likelihood_lowrank(Phi, Y, N, sigma)
        np.testing.assert_allclose(float(lowrank), float(dense), rtol=1e-8)

    def test_objective_dispatch_continuous_across_mK_boundary(self, rng):
        """gpc_nmll_objective routes m>K through the low-rank dual; the value
        (and hence the trained t) must equal the dense path's."""
        from flgp_tpu.models.gpc import gpc_marginal_log_likelihood
        from flgp_tpu.ops import linalg
        from flgp_tpu.ops.heat_kernel import heat_kernel

        eig, _, _ = _rand_eigenpair(rng, n=60, K=12)
        Y_all = jnp.asarray((rng.uniform(size=60) > 0.5).astype(float))
        for m in (12, 13, 40):  # at, just above, and well above K
            idx = jnp.arange(m)
            Y = Y_all[:m]
            N = jnp.ones((m,))
            got = gpc_mod.gpc_nmll_objective(eig, Y, N, idx, 12, 2.5, 1e-3)
            C = heat_kernel(eig, 2.5, 12, idx, idx)
            C = linalg.add_diag(C, jnp.full((m,), 1e-3, C.dtype))
            dense = -gpc_marginal_log_likelihood(C, Y, N)
            np.testing.assert_allclose(float(got), float(dense), rtol=1e-8)
