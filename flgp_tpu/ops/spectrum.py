"""Spectral decomposition of the two-step similarity W = Z·D⁻¹·Zᵀ.

The reference forms A = Z·diag(colsum)^(-1/2) and truncated-SVDs A via a
host round-trip into RSpectra's implicitly-restarted Lanczos
(src/Spectrum.cpp:146-161, src/TruncatedSVD.cpp:9-34).  Sequential Lanczos is
a poor fit for an accelerator; instead we compute the exact (s, s) Gram AᵀA
with blocked matmuls and take a single eigh: eig(W) = σ²(A) = eig(AᵀA), and the
left singular vectors follow as U = A·V·Σ⁻¹.  Exact, batched (vmappable over
bandwidth grids), and differentiable.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import EPS, LaplacianType
from ..types import EigenPair, EllMatrix
from .knn import knn
from .lae import lae_weights
from .laplacian import normalize_graph_laplacian


def cross_similarity_lae(
    X: jnp.ndarray,
    anchors: jnp.ndarray,
    r: int,
    gl: LaplacianType,
    cluster_sizes: jnp.ndarray | None = None,
    lae_iters: int = 150,
) -> EllMatrix:
    """LAE-flavored sparse stochastic matrix Z (src/Spectrum.cpp:101-117)."""
    idx = knn(X, anchors, r).indices
    w = lae_weights(X, anchors, idx, iters=lae_iters)
    Z = EllMatrix(w, idx, anchors.shape[0])
    return normalize_graph_laplacian(Z, gl, cluster_sizes)


def cross_similarity_se(
    X: jnp.ndarray,
    anchors: jnp.ndarray,
    r: int,
    gl: LaplacianType,
    epsilon: float,
    cluster_sizes: jnp.ndarray | None = None,
) -> EllMatrix:
    """SE-flavored Z with exp(-d²/(4ε²)) weights on kNN squared distances
    (src/Spectrum.cpp:120-142)."""
    res = knn(X, anchors, r)
    vals = jnp.exp(-res.sqdists / (4.0 * epsilon * epsilon))
    Z = EllMatrix(vals, res.indices, anchors.shape[0])
    return normalize_graph_laplacian(Z, gl, cluster_sizes)


def spectrum_fused(
    values: jnp.ndarray,
    indices: jnp.ndarray,
    s: int,
    K: int,
    gl: LaplacianType,
    root: bool,
    cluster_sizes: jnp.ndarray | None = None,
) -> EigenPair:
    """normalize_graph_laplacian + spectrum_from_Z from the RAW ELL graph:
    the whole spectral tail (column scale, row normalization, Gram, eigh,
    eigenvector extension) from the kNN indices and kernel weights."""
    gl = LaplacianType(gl)
    Z = normalize_graph_laplacian(EllMatrix(values, indices, s), gl, cluster_sizes)
    return spectrum_from_Z(Z, K, root)


def spectrum_from_Z(Z: EllMatrix, K: int, root: bool) -> EigenPair:
    """Top-K spectrum of W from the ELL matrix Z (src/Spectrum.cpp:146-161).

    values: eigenvalues of W = σ²(A), or σ(A) when ``root`` ("square-rooted
    eigenvalues", src/Spectrum.cpp:153-155).  vectors: √n-scaled left singular
    vectors of A restricted to the top K.
    """
    n, s = Z.shape
    colsum = Z.colsum()
    A = Z.scale_cols(1.0 / jnp.sqrt(jnp.abs(colsum) + EPS))
    G = A.gram()                                   # (s, s), PSD
    w, V = jnp.linalg.eigh(G)                      # ascending
    w = w[::-1][:K]                                # σ² descending
    V = V[:, ::-1][:, :K]
    sigma2 = jnp.maximum(w, 0.0)
    sigma = jnp.sqrt(sigma2)
    U = A.matmat(V) / (sigma[None, :] + EPS)       # left singular vectors (n, K)
    values = sigma if root else sigma2
    vectors = U * jnp.sqrt(jnp.asarray(n, dtype=U.dtype))
    return EigenPair(values, vectors)


