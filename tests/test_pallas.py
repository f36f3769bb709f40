"""The Pallas-Triton LAE FISTA kernel, checked on the CPU through the Pallas
interpreter against the XLA scan (ops.lae.lae_weights_xla) and a scipy
simplex-QP oracle; the per-lowering choice of kernel; and the spectral tail
that the kernels it replaced used to run.  The compiled kernel is compared
with the XLA path on the card by the ``gpu``-marked test below and by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize

from flgp_tpu.ops import pallas_kernels as pk
from flgp_tpu.ops.knn import knn
from flgp_tpu.ops.lae import (
    _fista_t_xla,
    assemble_lae_gram_t,
    lae_weights,
    lae_weights_t,
    lae_weights_xla,
)


def _problem(rng, n, d, s, r, dtype):
    X = jnp.asarray(rng.normal(size=(n, d)), dtype)
    U = jnp.asarray(rng.normal(size=(s, d)), dtype)
    return X, U, knn(X, U, r).indices


def _kernel_weights(X, U, idx, iters):
    """(n, r) weights from the Triton kernel, run by the Pallas interpreter."""
    return pk.lae_fista_t(*assemble_lae_gram_t(X, U, idx), iters, interpret=True).T


def _qp_objective_gap(X, U, idx, w):
    """Largest amount by which w's objective exceeds scipy's SLSQP optimum
    of min ‖x − zᵀU_i‖² over the simplex (tests/test_ops_core.py oracle)."""
    X, U, idx, w = map(np.asarray, (X, U, idx, w))
    r = idx.shape[1]
    gap = -np.inf
    for i in range(X.shape[0]):
        Ui = U[idx[i]].astype(np.float64)
        xi = X[i].astype(np.float64)

        def obj(z):
            return 0.5 * ((xi - z @ Ui) ** 2).sum()

        res = scipy.optimize.minimize(
            obj, np.ones(r) / r,
            constraints=[{"type": "eq", "fun": lambda z: z.sum() - 1}],
            bounds=[(0, None)] * r, method="SLSQP",
        )
        gap = max(gap, obj(w[i].astype(np.float64)) - obj(res.x))
    return gap


class TestFusedLae:
    def test_matches_xla_fista(self, rng):
        n, d, s, r = 700, 3, 64, 3
        X, U, idx = _problem(rng, n, d, s, r, jnp.float32)
        got = np.asarray(_kernel_weights(X, U, idx, 150))
        ref = np.asarray(lae_weights_xla(X, U, idx, iters=150))
        np.testing.assert_allclose(got, ref, atol=1e-4)
        np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)
        assert got.min() >= -1e-7

    def test_r4_and_padding(self, rng):
        # 300 points over 256-point blocks: the second block is mostly tail
        n, d, s, r = 300, 4, 32, 4
        X, U, idx = _problem(rng, n, d, s, r, jnp.float32)
        got = _kernel_weights(X, U, idx, 100)
        ref = lae_weights_xla(X, U, idx, iters=100)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-4)


class TestTritonLaeKernel:
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
    @pytest.mark.parametrize("r", [1, 2, 3, 5])
    def test_against_xla_and_qp_oracle(self, rng, r, dtype):
        n, d, s = 203, 3, 40          # 203 points: not a multiple of the block
        X, U, idx = _problem(rng, n, d, s, r, dtype)
        got = _kernel_weights(X, U, idx, 150)
        ref = lae_weights_xla(X, U, idx, iters=150)
        assert got.dtype == dtype and got.shape == (n, r)
        tol = 1e-4 if dtype == jnp.float32 else 1e-10
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=tol)
        np.testing.assert_allclose(np.asarray(got).sum(1), 1.0, atol=1e-5)
        assert float(got.min()) >= -1e-7
        # 150 iterations land on the QP optimum (first 25 points: SLSQP is slow)
        assert _qp_objective_gap(X[:25], U, idx[:25], got[:25]) <= 1e-5

    @pytest.mark.parametrize("iters", [1, 7, 40])
    def test_iteration_count(self, rng, iters):
        """Every prefix of the iteration schedule matches, not just the
        converged end point: the momentum recursion is the same."""
        r, n = 3, 130
        X, U, idx = _problem(rng, n, 3, 24, r, jnp.float64)
        Gt, bt = assemble_lae_gram_t(X, U, idx)
        got = pk.lae_fista_t(Gt, bt, iters, block=64, interpret=True)
        ref = _fista_t_xla(Gt, bt, iters)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-12)

    @pytest.mark.parametrize("n", [1, 64, 65])
    def test_tail_masking(self, rng, n):
        """n below, at and just past one 64-point block."""
        X, U, idx = _problem(rng, n, 2, 12, 3, jnp.float64)
        Gt, bt = assemble_lae_gram_t(X, U, idx)
        got = pk.lae_fista_t(Gt, bt, 50, block=64, interpret=True)
        assert got.shape == (3, n)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(_fista_t_xla(Gt, bt, 50)), atol=1e-12
        )

    def test_gram_assembly_layout(self, rng):
        """Gt row i·r + j is U_i·U_j and bt row k is U_k·x, point axis minor."""
        n, d, s, r = 17, 4, 9, 3
        X, U, idx = _problem(rng, n, d, s, r, jnp.float64)
        Gt, bt = assemble_lae_gram_t(X, U, idx)
        Ui = np.asarray(U)[np.asarray(idx)]
        G = np.einsum("nrd,nsd->nrs", Ui, Ui)
        np.testing.assert_allclose(np.asarray(Gt), G.reshape(n, r * r).T, atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(bt), np.einsum("nd,nrd->rn", np.asarray(X), Ui), atol=1e-12
        )


class TestKernelChoice:
    """The kernel is picked per lowering: XLA on the CPU, Triton for CUDA."""

    def _lowered(self, fn, args, platform):
        return jax.jit(fn).trace(*args).lower(lowering_platforms=(platform,)).as_text()

    def test_cpu_lowering_runs_xla_scan(self, rng):
        X, U, idx = _problem(rng, 50, 3, 16, 3, jnp.float32)
        txt = self._lowered(lae_weights, (X, U, idx), "cpu")
        assert "triton" not in txt
        got = np.asarray(lae_weights(X, U, idx))
        np.testing.assert_array_equal(
            got, np.asarray(_fista_t_xla(*assemble_lae_gram_t(X, U, idx), 150).T)
        )
        # the feature-major scan and the point-major reference round apart
        np.testing.assert_allclose(got, np.asarray(lae_weights_xla(X, U, idx)), atol=1e-5)

    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
    def test_cuda_lowering_runs_triton_kernel(self, rng, dtype):
        X, U, idx = _problem(rng, 50, 3, 16, 3, dtype)
        txt = self._lowered(lae_weights, (X, U, idx), "cuda")
        assert "triton" in txt and "lae_fista" in txt

    def test_colmajor_chunk_choice(self, rng):
        X, U, idx = _problem(rng, 40, 3, 16, 3, jnp.float32)
        Gt, bt = assemble_lae_gram_t(X, U, idx)
        assert "triton" in self._lowered(lambda g, b: lae_weights_t(g, b, 20), (Gt, bt), "cuda")
        assert "triton" not in self._lowered(lambda g, b: lae_weights_t(g, b, 20), (Gt, bt), "cpu")


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_card(gpu_device):
    """The compiled kernel vs the XLA scan at the flagship width."""
    n, s, r, d = 100_000, 1024, 3, 3
    with jax.default_device(gpu_device):
        X = jax.random.normal(jax.random.PRNGKey(0), (n, d), jnp.float32)
        U = X[:: n // s][:s]
        idx = knn(X, U, r).indices
        got = jax.jit(lae_weights)(X, U, idx)
        ref = jax.jit(lae_weights_xla)(X, U, idx)
    assert float(jnp.max(jnp.abs(got - ref))) <= 1e-4


class TestFusedNormalizeSpectrumTail:
    @pytest.mark.parametrize("gl", ["rw", "normalized", "cluster-normalized"])
    def test_spectrum_fused_fallback_equals_composition(self, rng, gl):
        """spectrum_fused must BE the composition normalize_graph_laplacian +
        spectrum_from_Z — bit-for-bit (the f64 golden gates run through it)."""
        from flgp_tpu.config import LaplacianType
        from flgp_tpu.ops.laplacian import normalize_graph_laplacian
        from flgp_tpu.ops.spectrum import spectrum_from_Z, spectrum_fused
        from flgp_tpu.types import EllMatrix

        n, d, s, r, K = 300, 3, 32, 3, 8
        X = jnp.asarray(rng.normal(size=(n, d)))
        U = jnp.asarray(rng.normal(size=(s, d)))
        res = knn(X, U, r)
        w = jnp.asarray(rng.uniform(0.1, 1.0, size=(n, r)))
        counts = jnp.asarray(rng.integers(1, 20, size=(s,)).astype(np.float64))
        glt = LaplacianType(gl)
        got = spectrum_fused(w, res.indices, s, K, glt, True, counts)
        Z = normalize_graph_laplacian(EllMatrix(w, res.indices, s), glt, counts)
        ref = spectrum_from_Z(Z, K, True)
        np.testing.assert_array_equal(np.asarray(got.values), np.asarray(ref.values))
        np.testing.assert_array_equal(np.asarray(got.vectors), np.asarray(ref.vectors))
