"""Feature-major huge-n pipeline (ops.colmajor) vs the point-major oracle.

The colmajor pipeline must be numerically equivalent to the production
cross_similarity_* + normalize + spectrum_from_Z path on identical anchors —
same graph, same normalization, same spectrum — with chunking and padding
exercised (n deliberately not a multiple of the chunk size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flgp_tpu.config import KernelType, LaplacianType
from flgp_tpu.ops.colmajor import (
    build_graph_colmajor,
    heat_kernel_spectrum_colmajor,
    normalize_colmajor,
)
from flgp_tpu.ops.knn import knn
from flgp_tpu.ops.lae import _fista_t_xla, lae_weights_xla
from flgp_tpu.ops.laplacian import normalize_graph_laplacian
from flgp_tpu.ops.spectrum import cross_similarity_lae, cross_similarity_se, spectrum_from_Z
from flgp_tpu.types import EllMatrix


def _data(n=517, d=3, s=32, seed=0):
    rng = np.random.default_rng(seed)
    X = jnp.asarray(rng.normal(size=(n, d)))
    U = jnp.asarray(rng.normal(size=(s, d)))
    return X, U


class TestFistaTransposed:
    def test_matches_point_major_fista(self):
        X, U = _data()
        idx = knn(X, U, 3).indices
        ref = lae_weights_xla(X, U, idx, iters=150)

        Ui = U[idx]
        Gt = jnp.einsum("nrd,nsd->nrs", Ui, Ui).reshape(X.shape[0], 9).T
        bt = jnp.einsum("nd,nrd->nr", X, Ui).T
        got = _fista_t_xla(Gt, bt, iters=150)
        np.testing.assert_allclose(np.asarray(got.T), np.asarray(ref), atol=1e-12)


def _flatten_chunked(arr_c, n):
    """(nch, r, c) chunked layout → point-major (n, r) numpy view."""
    a = np.asarray(arr_c)
    nch, r, c = a.shape
    return np.moveaxis(a, 1, 2).reshape(nch * c, r)[:n]


class TestBuildGraphColmajor:
    def test_lae_graph_matches(self):
        X, U = _data()
        idx = knn(X, U, 3).indices
        w = lae_weights_xla(X, U, idx, iters=150)
        n = X.shape[0]
        idx_c, w_c = build_graph_colmajor(X.T, U, 3, KernelType.LAE, chunk=128)
        np.testing.assert_array_equal(_flatten_chunked(idx_c, n), np.asarray(idx))
        np.testing.assert_allclose(_flatten_chunked(w_c, n), np.asarray(w), atol=1e-10)

    def test_se_graph_matches(self):
        X, U = _data(seed=3)
        res = knn(X, U, 3)
        eps4 = jnp.asarray(4.0 * 0.7**2)
        vals = jnp.exp(-res.sqdists / eps4)
        n = X.shape[0]
        idx_c, w_c = build_graph_colmajor(
            X.T, U, 3, KernelType.SE, epsilon_sq4=eps4, chunk=128
        )
        np.testing.assert_array_equal(_flatten_chunked(idx_c, n), np.asarray(res.indices))
        np.testing.assert_allclose(_flatten_chunked(w_c, n), np.asarray(vals), atol=1e-12)

    def test_pad_rows_zero_weight(self):
        X, U = _data(n=100)
        idx_c, w_c = build_graph_colmajor(X.T, U, 3, KernelType.LAE, chunk=64)
        flat = _flatten_chunked(w_c, w_c.shape[0] * w_c.shape[2])
        assert flat.shape[0] == 128
        np.testing.assert_allclose(flat[100:], 0.0)


class TestNormalizeColmajor:
    @pytest.mark.parametrize(
        "gl", [LaplacianType.RW, LaplacianType.NORMALIZED, LaplacianType.CLUSTER_NORMALIZED]
    )
    def test_matches_ell_normalization(self, gl):
        X, U = _data(seed=1)
        s = U.shape[0]
        res = knn(X, U, 3)
        vals = jnp.exp(-res.sqdists / 2.0)
        counts = jnp.asarray(np.random.default_rng(2).integers(1, 30, size=(s,)).astype(np.float64))
        Z = normalize_graph_laplacian(EllMatrix(vals, res.indices, s), gl, counts)
        w_t = normalize_colmajor(res.indices.T, vals.T, s, gl, counts)
        np.testing.assert_allclose(np.asarray(w_t.T), np.asarray(Z.values), atol=1e-12)


class TestFullPipeline:
    @pytest.mark.parametrize("kernel", [KernelType.LAE, KernelType.SE])
    def test_spectrum_matches_point_major(self, kernel):
        X, U = _data(n=413, s=24, seed=5)
        s, K = U.shape[0], 10
        eps4 = jnp.asarray(4.0 * 0.8**2)
        if kernel == KernelType.LAE:
            Z = cross_similarity_lae(X, U, 3, LaplacianType.NORMALIZED)
        else:
            Z = cross_similarity_se(X, U, 3, LaplacianType.NORMALIZED, 0.8)
        ref = spectrum_from_Z(Z, K, root=True)
        got = heat_kernel_spectrum_colmajor(
            X.T, U, 3, K, LaplacianType.NORMALIZED, True,
            kernel=kernel, epsilon_sq4=eps4, chunk=128,
        )
        np.testing.assert_allclose(np.asarray(got.values), np.asarray(ref.values), atol=1e-10)
        # eigenvectors agree up to per-column sign
        Vr, Vg = np.asarray(ref.vectors), np.asarray(got.vectors)
        signs = np.sign(np.sum(Vr * Vg, axis=0))
        np.testing.assert_allclose(Vg * signs, Vr, atol=1e-7)

    def test_cluster_normalized_jit(self):
        X, U = _data(n=300, s=16, seed=7)
        counts = jnp.asarray(
            np.random.default_rng(8).integers(1, 40, size=(16,)).astype(np.float64)
        )
        Z = cross_similarity_lae(X, U, 3, LaplacianType.CLUSTER_NORMALIZED, counts)
        ref = spectrum_from_Z(Z, 8, root=False)
        fn = jax.jit(
            lambda Xt, Uv, c: heat_kernel_spectrum_colmajor(
                Xt, Uv, 3, 8, LaplacianType.CLUSTER_NORMALIZED, False,
                cluster_sizes=c, chunk=128,
            )
        )
        got = fn(X.T, U, counts)
        np.testing.assert_allclose(np.asarray(got.values), np.asarray(ref.values), atol=1e-10)


class TestColmajorAnchors:
    """k-means anchors + cluster sizes on the feature-major path (the n=1e7
    bench previously drew random rows)."""

    def test_kmeans_anchors_find_blobs(self):
        from flgp_tpu.ops.colmajor import kmeans_anchors_colmajor

        rng = np.random.default_rng(0)
        blobs = np.array([[4.0, 0, 0], [-4, 0, 0], [0, 4, 0], [0, -4, 0]])
        X = np.concatenate(
            [b + 0.2 * rng.normal(size=(500, 3)) for b in blobs]
        ).astype(np.float64)
        rng.shuffle(X)
        centers = jax.jit(
            lambda k, Xt: kmeans_anchors_colmajor(k, Xt, 4, n_sample=1024)
        )(jax.random.PRNGKey(0), jnp.asarray(X.T))
        got = np.sort(np.asarray(centers), axis=0)
        np.testing.assert_allclose(got, np.sort(blobs, axis=0), atol=0.15)

    def test_cluster_sizes_match_pointmajor_oracle(self):
        from flgp_tpu.ops.colmajor import cluster_sizes_colmajor

        X, U = _data(n=517, s=32, seed=3)
        lab = np.asarray(knn(X, U, 1).indices[:, 0])
        ref = np.bincount(lab, minlength=32).astype(np.float64)
        got = jax.jit(
            lambda Xt, c: cluster_sizes_colmajor(Xt, c, chunk=128)
        )(X.T, U)
        np.testing.assert_allclose(np.asarray(got), ref)
