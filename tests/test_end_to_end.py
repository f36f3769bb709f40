"""End-to-end fit-driver tests on scaled-down README datasets.

Small configurations of the reference's golden examples
(/root/reference/README.md:82-170): the full-size parity runs live in
bench.py; here the same pipelines must learn the structure at reduced n
within generous error budgets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import flgp_tpu
from flgp_tpu import FitConfig, GraphConfig, TrainConfig
from flgp_tpu.config import KernelType
from flgp_tpu.datasets import gaussian_blobs, spiral, torus_rings


CFG_GRAPH = GraphConfig(s=120, r=3, K=40)
# lighter optimizer schedules: the E2E suite is compile-bound on small hosts
CFG_TRAIN = TrainConfig(grid_size=16, adam_steps=80)
KEY = jax.random.PRNGKey(7)


@pytest.fixture(scope="module")
def torus():
    # full README config: the rings only separate in the anchor graph when
    # both n and s are at reference scale (anchor spacing along a ring must
    # be well under the inter-ring gap; see CLAUDE.md) — smaller configs are
    # chance-level by geometry, not by bug
    return torus_rings(n=4800, m_train=100, seed=1234)


TORUS_GRAPH = GraphConfig(s=600, r=3, K=100)


@pytest.fixture(scope="module")
def spiral_data():
    return spiral(n=800, m_train=150, seed=1234)


def _err(y_pred, y_true):
    return float(np.mean(np.asarray(y_pred) != np.asarray(y_true)))


def _rmse(y_pred, y_true):
    return float(np.sqrt(np.mean((np.asarray(y_pred) - np.asarray(y_true)) ** 2)))


class TestRegression:
    def test_lae_spiral(self, spiral_data):
        cfg = FitConfig(graph=CFG_GRAPH, train=CFG_TRAIN, sigma=1e-5, dtype=jnp.float64)
        res = flgp_tpu.fit_lae_regression_gp(
            KEY, spiral_data.x_train, spiral_data.y_train, spiral_data.x_test, cfg
        )
        rmse = _rmse(res.y_test, spiral_data.y_test)
        assert rmse < 1.5, rmse
        assert np.all(res.posterior_cov > 0)

    def test_se_spiral(self, spiral_data):
        cfg = FitConfig(graph=CFG_GRAPH, train=CFG_TRAIN, sigma=1e-5, dtype=jnp.float64)
        res = flgp_tpu.fit_se_regression_gp(
            KEY, spiral_data.x_train, spiral_data.y_train, spiral_data.x_test, cfg
        )
        assert _rmse(res.y_test, spiral_data.y_test) < 1.5
        assert "a2" in res.pars

    def test_nystrom_spiral(self, spiral_data):
        cfg = FitConfig(graph=CFG_GRAPH, train=CFG_TRAIN, sigma=1e-5, dtype=jnp.float64)
        res = flgp_tpu.fit_nystrom_regression_gp(
            KEY, spiral_data.x_train, spiral_data.y_train, spiral_data.x_test, cfg
        )
        assert _rmse(res.y_test, spiral_data.y_test) < 2.5

    def test_nystrom_rcond_spiral(self, spiral_data):
        """The pinv-style rcond clamp on the Nyström extension (the fix for
        the round-3 sampling pathology) must not hurt prediction: it only
        rescales columns whose anchor eigenvalue is below rcond*max|lambda|,
        where the raw 1/lambda was amplifying noise."""
        cfg = FitConfig(
            graph=GraphConfig(s=120, r=3, K=40, nystrom_rcond=1e-3),
            train=CFG_TRAIN, sigma=1e-5, dtype=jnp.float64,
        )
        res = flgp_tpu.fit_nystrom_regression_gp(
            KEY, spiral_data.x_train, spiral_data.y_train, spiral_data.x_test, cfg
        )
        assert _rmse(res.y_test, spiral_data.y_test) < 2.5

    def test_nystrom_rcond_preserves_strong_columns(self):
        """rcond only touches near-null columns: for |lambda_k| >=
        rcond*max the extension is bit-identical to the reference formula
        (src/Fit.cpp:284-291)."""
        from flgp_tpu.fit.spectral import (
            nystrom_anchor_eigs, nystrom_extend, nystrom_setup,
        )

        data = spiral(n=400, m_train=100, seed=3)
        X_all = jnp.concatenate(
            [jnp.asarray(data.x_train, jnp.float64), jnp.asarray(data.x_test, jnp.float64)]
        )
        g = GraphConfig(s=80, r=3, K=60)
        basis = nystrom_setup(KEY, X_all, g)
        anchor, Z_UU = nystrom_anchor_eigs(basis, jnp.float64(1.0), 60)
        raw = nystrom_extend(anchor, Z_UU, basis.dist_allU, jnp.float64(1.0), basis.dist_mean, True)
        clamped = nystrom_extend(
            anchor, Z_UU, basis.dist_allU, jnp.float64(1.0), basis.dist_mean, True, rcond=1e-3
        )
        absv = np.abs(np.asarray(anchor.values))
        strong = absv >= 1e-3 * absv.max()
        assert strong.any() and not strong.all()  # the clamp must actually engage
        np.testing.assert_array_equal(
            np.asarray(raw.vectors)[:, strong], np.asarray(clamped.vectors)[:, strong]
        )
        weak = ~strong
        cn_raw = np.linalg.norm(np.asarray(raw.vectors)[:, weak], axis=0)
        cn_cl = np.linalg.norm(np.asarray(clamped.vectors)[:, weak], axis=0)
        assert (cn_cl <= cn_raw + 1e-12).all()

    def test_gl_spiral_small(self):
        data = spiral(n=300, m_train=100, seed=1234)
        cfg = FitConfig(graph=GraphConfig(K=40), train=CFG_TRAIN, sigma=1e-5, dtype=jnp.float64)
        res = flgp_tpu.fit_gl_regression_gp(KEY, data.x_train, data.y_train, data.x_test, cfg)
        assert _rmse(res.y_test, data.y_test) < 2.5


class TestBinaryClassification:
    def test_lae_torus(self, torus):
        """README golden: reference LKFLGP error is 0.0270 (BASELINE.md)."""
        cfg = FitConfig(graph=TORUS_GRAPH, train=CFG_TRAIN, sigma=1e-3, dtype=jnp.float64)
        res = flgp_tpu.fit_lae_logit_gp(KEY, torus.x_train, torus.y_train, torus.x_test, cfg=cfg)
        assert _err(res.y_test, torus.y_test) < 0.08

    def test_se_torus(self, torus):
        """README golden: reference SKFLGP error is 0.0 (BASELINE.md)."""
        cfg = FitConfig(graph=TORUS_GRAPH, train=CFG_TRAIN, sigma=1e-3, dtype=jnp.float64)
        res = flgp_tpu.fit_se_logit_gp(KEY, torus.x_train, torus.y_train, torus.x_test, cfg=cfg)
        assert _err(res.y_test, torus.y_test) < 0.08

    def test_nystrom_blobs(self):
        data = gaussian_blobs(n_per_class=40, n_classes=2, sep=6.0)
        cfg = FitConfig(graph=GraphConfig(s=30, r=3, K=15), train=CFG_TRAIN, dtype=jnp.float64)
        res = flgp_tpu.fit_nystrom_logit_gp(KEY, data.x_train, data.y_train, data.x_test, cfg=cfg)
        assert _err(res.y_test, data.y_test) < 0.15

    def test_gl_blobs(self):
        data = gaussian_blobs(n_per_class=40, n_classes=2, sep=6.0)
        cfg = FitConfig(graph=GraphConfig(K=20), train=CFG_TRAIN, dtype=jnp.float64)
        res = flgp_tpu.fit_gl_logit_gp(KEY, data.x_train, data.y_train, data.x_test, cfg=cfg)
        assert _err(res.y_test, data.y_test) < 0.15


class TestMulticlass:
    def test_lae_blobs(self):
        data = gaussian_blobs(n_per_class=40, n_classes=3, sep=6.0)
        cfg = FitConfig(graph=GraphConfig(s=30, r=3, K=15), train=CFG_TRAIN, dtype=jnp.float64)
        res = flgp_tpu.fit_lae_logit_mult_gp(KEY, data.x_train, data.y_train, data.x_test, cfg)
        assert _err(res.y_test, data.y_test) < 0.15
        assert res.posterior_mean.shape[1] == 3

    def test_se_blobs(self):
        data = gaussian_blobs(n_per_class=40, n_classes=3, sep=6.0)
        cfg = FitConfig(graph=GraphConfig(s=30, r=3, K=15), train=CFG_TRAIN, dtype=jnp.float64)
        res = flgp_tpu.fit_se_logit_mult_gp(KEY, data.x_train, data.y_train, data.x_test, cfg)
        assert _err(res.y_test, data.y_test) < 0.15


class TestDigits:
    """Real-image-manifold multiclass: the sklearn 8×8 digits set (bundled,
    offline) standing in for the BASELINE MNIST-subset config."""

    def test_lae_mult_digits(self):
        from flgp_tpu.datasets import digits

        dg = digits(m_train=250, seed=0)
        cfg = FitConfig(
            graph=GraphConfig(s=250, r=3, K=60), train=CFG_TRAIN,
            sigma=1e-3, dtype=jnp.float64,
        )
        res = flgp_tpu.fit_lae_logit_mult_gp(
            KEY, dg.x_train, dg.y_train, dg.x_test, cfg=cfg
        )
        assert _err(res.y_test, dg.y_test) < 0.12

    def test_smc_t_posterior_on_digits_spectrum(self):
        """SMC over per-class log t on the digits spectral basis (BASELINE
        config 3 at test scale)."""
        from flgp_tpu.datasets import digits
        from flgp_tpu.fit.multiclass import one_hot_labels
        from flgp_tpu.fit.spectral import build_spectrum
        from flgp_tpu.inference.hyperparam import mult_t_posterior

        dg = digits(m_train=200, seed=0)
        cfg = FitConfig(
            graph=GraphConfig(s=200, r=3, K=50), sigma=1e-3, dtype=jnp.float64
        )
        X_all = jnp.concatenate(
            [jnp.asarray(dg.x_train, jnp.float64), jnp.asarray(dg.x_test, jnp.float64)]
        )
        eig, _ = build_spectrum(KEY, X_all, cfg.graph)
        aug = one_hot_labels(jnp.asarray(dg.y_train), 10)
        post = mult_t_posterior(
            jax.random.PRNGKey(3), eig, aug, jnp.arange(200), 50, 1e-3,
            n_particles=24, n_mutation_steps=3,
        )
        assert post.t_mean.shape == (10,)
        assert np.isfinite(float(post.log_evidence))
        assert (np.asarray(post.t) > 0).all()

    def test_smc_t_posterior_matches_quadrature(self):
        """Statistical validation of the SMC hyperposterior: the target is
        1-D per class, so trapezoid quadrature of the low-rank Laplace
        marginal over log t is exact ground truth.  At the bench's particle
        budget (64/5) the SMC posterior mean must land within one posterior
        sd on every class (measured 0.52-0.55 max over seeds; 0.28 at double
        budget — consistent convergence)."""
        from flgp_tpu.datasets import digits
        from flgp_tpu.fit.multiclass import one_hot_labels
        from flgp_tpu.fit.spectral import build_spectrum
        from flgp_tpu.inference.hyperparam import mult_t_posterior, mult_t_quadrature

        dg = digits(m_train=200, seed=0)
        cfg = FitConfig(
            graph=GraphConfig(s=200, r=3, K=50), sigma=1e-3, dtype=jnp.float64
        )
        X_all = jnp.concatenate(
            [jnp.asarray(dg.x_train, jnp.float64), jnp.asarray(dg.x_test, jnp.float64)]
        )
        eig, _ = build_spectrum(KEY, X_all, cfg.graph)
        aug = one_hot_labels(jnp.asarray(dg.y_train), 10)
        idx = jnp.arange(200)
        quad = mult_t_quadrature(eig, aug, idx, 50, 1e-3)
        assert (np.asarray(quad.t_sd) > 0).all()
        # resolution guard: the coarse pass must not have
        # collapsed onto one grid cell, and the refined two-pass moments must
        # be grid-converged — a 3x-coarser budget lands on the same answer
        assert float(quad.coarse_max_weight) < 0.5
        quad_lo = mult_t_quadrature(eig, aug, idx, 50, 1e-3, n_grid=96)
        np.testing.assert_allclose(
            np.asarray(quad_lo.t_mean), np.asarray(quad.t_mean),
            atol=0.02 * float(np.min(np.asarray(quad.t_sd))),
        )
        post = mult_t_posterior(
            jax.random.PRNGKey(3), eig, aug, idx, 50, 1e-3,
            n_particles=64, n_mutation_steps=5,
        )
        err = np.abs(np.asarray(post.t_mean) - np.asarray(quad.t_mean)) / np.asarray(quad.t_sd)
        assert err.max() < 1.0, err
        assert err.mean() < 0.5, err


class TestDigitsLarge:
    def test_zero_shift_replicas_are_source_images(self):
        """With shift_max=0 and noise_sd=0 every replica must be bit-equal to
        a real source digit — the augmentation only *moves along* the image
        manifold, never off it."""
        from sklearn.datasets import load_digits

        from flgp_tpu.datasets import digits_large

        ds = digits_large(n=300, m_train=20, seed=1, shift_max=0.0, noise_sd=0.0)
        src = load_digits().data / 16.0
        X = np.concatenate([ds.x_train, ds.x_test])
        d2 = ((X[:, None, :] - src[None, :, :]) ** 2).sum(-1).min(1)
        assert float(d2.max()) == 0.0

    def test_structure(self):
        from flgp_tpu.datasets import digits_large

        ds = digits_large(n=4000, m_train=100, seed=0)
        assert ds.x_train.shape == (100, 64)
        assert ds.x_test.shape == (3900, 64)
        labels = np.concatenate([ds.y_train, ds.y_test])
        assert set(np.unique(labels)) == set(range(10))
        # shifted-and-noised pixels stay near [0, 1]
        assert ds.x_test.min() > -0.2 and ds.x_test.max() < 1.2


class TestMnistLike:
    def test_generator_structure(self):
        from flgp_tpu.datasets import mnist_like

        data = mnist_like(n=2000, m_train=100, seed=0)
        assert data.x_train.shape == (100, 16)
        assert data.x_test.shape == (1900, 16)
        labels = np.concatenate([data.y_train, data.y_test])
        assert set(np.unique(labels)) == set(range(10))
        # standardized ambient coordinates
        X = np.concatenate([data.x_train, data.x_test])
        np.testing.assert_allclose(X.mean(0), 0.0, atol=1e-8)


class TestExtras:
    def test_heat_kernel_covariance_psd(self):
        rng = np.random.default_rng(0)
        X = rng.normal(size=(40, 2))
        X_new = rng.normal(size=(20, 2))
        H = flgp_tpu.heat_kernel_covariance(
            KEY, jnp.asarray(X), jnp.asarray(X_new), 1.0,
            GraphConfig(s=20, r=3, K=10)
        )
        assert H.shape == (60, 40)
        # H[:40,:40] is a heat-kernel gram block: symmetric PSD
        Hs = np.asarray(H)[:40]
        np.testing.assert_allclose(Hs, Hs.T, atol=1e-8)
        assert np.linalg.eigvalsh(Hs).min() > -1e-8

    def test_lae_eigenmap_shapes(self):
        rng = np.random.default_rng(0)
        X = jnp.asarray(rng.normal(size=(100, 3)))
        vals, vecs = flgp_tpu.lae_eigenmap(KEY, X, s=20, r=3, ndim=5)
        assert vals.shape == (5,)
        assert vecs.shape == (100, 5)
        # Laplacian eigenvalues nonnegative-ish, first ~0
        assert float(vals[0]) < 1e-6


class TestPerPointNoiseDriver:
    """NoiseModel.DIFFERENT exercised through a full driver (the reference's
    m+1-parameter MMA path, src/train.cpp:459-555)."""

    def test_fit_lae_regression_different_noise(self):
        import numpy as np

        from flgp_tpu import FitConfig, GraphConfig, TrainConfig, fit_lae_regression_gp

        rng = np.random.default_rng(4)
        n, m = 500, 100
        theta = rng.uniform(0, 4 * np.pi, n)
        X = np.stack([np.cos(theta) * (1 + theta / 6), np.sin(theta) * (1 + theta / 6)], 1)
        f = np.sin(theta)
        idx = rng.permutation(n)
        # heteroscedastic observations: second half of train rows is 10x noisier
        noise_sd = np.where(np.arange(m) < m // 2, 0.05, 0.5)
        Ytr = f[idx[:m]] + noise_sd * rng.normal(size=m)

        cfg = FitConfig(
            graph=GraphConfig(s=40, r=3, K=20), sigma=1e-5,
            train=TrainConfig(noise="different"),
        )
        res = fit_lae_regression_gp(
            jax.random.PRNGKey(0), X[idx[:m]], Ytr, X[idx[m:]], cfg
        )
        noise_vec = np.asarray(res.pars["noise"])
        assert noise_vec.shape == (m,), "per-point noise vector expected"
        assert np.isfinite(res.y_test).all()
        rmse = float(np.sqrt(np.mean((res.y_test - f[idx[m:]]) ** 2)))
        assert rmse < 0.6
        # the learned noise should be larger (on average) for the noisy half
        assert noise_vec[m // 2:].mean() > noise_vec[: m // 2].mean()


class TestSolverStatus:
    """SURVEY §5 failure detection: instrumented fits surface structured
    solver-convergence status (Newton iterations/delta, 1-D refiner bracket,
    Adam gradient norm) in FitResult.metrics — the reference's only signal is
    a printed "nlopt failed!" (src/train.cpp:63-65)."""

    def test_gpc_instrumented_metrics(self, spiral_data):
        from flgp_tpu.utils.metrics import MetricsReport

        x = np.asarray(spiral_data.x_train)
        y = (np.asarray(spiral_data.y_train) > 0).astype(np.float64)
        cfg = FitConfig(graph=CFG_GRAPH, train=CFG_TRAIN, sigma=1e-3, dtype=jnp.float64)
        report = MetricsReport()
        res = flgp_tpu.fit_lae_logit_gp(
            KEY, x, y, np.asarray(spiral_data.x_test), cfg=cfg, report=report
        )
        m = res.metrics
        assert m is not None
        # Newton mode-finding converged within budget at the selected t
        assert 1 <= m["newton_iters"] <= cfg.train.newton_max_iter
        assert (
            m["newton_final_delta"] < cfg.train.newton_tol
            or m["newton_iters"] == cfg.train.newton_max_iter
        )
        # refinement bracket collapsed far below the coarse grid cell
        assert 0.0 <= m["opt_bracket_logwidth"] < 0.1
        assert m["opt_window_expansions"] >= 0.0

    def test_gpr_instrumented_metrics(self, spiral_data):
        from flgp_tpu.utils.metrics import MetricsReport

        cfg = FitConfig(graph=CFG_GRAPH, train=CFG_TRAIN, sigma=1e-5, dtype=jnp.float64)
        report = MetricsReport()
        res = flgp_tpu.fit_lae_regression_gp(
            KEY, spiral_data.x_train, spiral_data.y_train, spiral_data.x_test,
            cfg, report=report,
        )
        m = res.metrics
        assert m is not None
        assert np.isfinite(m["adam_grad_norm"])
        assert np.isfinite(m["train_obj"])
