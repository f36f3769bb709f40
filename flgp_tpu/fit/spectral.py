"""Spectral-basis construction for the fit drivers.

Equivalent of ``heat_kernel_spectrum_cpp`` (src/Spectrum.cpp:48-76) plus the
per-bandwidth basis builders the SE/Nyström/GLGP drivers inline
(src/Fit.cpp:102-219, 221-358, 361-512).  The bandwidth grid dimension is
vmapped — all grid points' spectra and hyperparameter optimizations run
batched on device instead of the reference's serial host loop.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import EPS, PRECISION, GraphConfig, KernelType, LaplacianType
from ..ops.distance import sqdist
from ..ops.kmeans import SubsampleResult, subsample
from ..ops.knn import KnnResult, knn
from ..ops.laplacian import normalize_graph_laplacian
from ..ops.lae import lae_weights
from ..ops.spectrum import (
    cross_similarity_lae,
    cross_similarity_se,
    spectrum_from_Z,
    spectrum_fused,
)
from ..types import EigenPair, EllMatrix


def build_spectrum(
    key: jax.Array,
    X_all: jnp.ndarray,
    g: GraphConfig,
    anchors: SubsampleResult | None = None,
) -> Tuple[EigenPair, SubsampleResult]:
    """Subsample → cross-similarity → spectrum (src/Spectrum.cpp:48-76).

    ``anchors`` overrides the subsampler with a precomputed (centers, counts)
    pair — e.g. the exact R-session Hartigan–Wong draw for parity runs
    (datasets.spiral_r_anchors)."""
    sub = anchors if anchors is not None else subsample(
        key, X_all, g.s, g.subsample, g.nstart, g.kmeans_iters
    )
    K = g.resolved_K()
    # raw ELL graph, then the normalize+spectrum tail
    # (ops.spectrum.spectrum_fused)
    if g.kernel == KernelType.LAE:
        idx = knn(X_all, sub.centers, g.r).indices
        w = lae_weights(X_all, sub.centers, idx)
    elif g.kernel == KernelType.SE:
        res = knn(X_all, sub.centers, g.r)
        idx = res.indices
        w = jnp.exp(-res.sqdists / (4.0 * g.epsilon * g.epsilon))
    else:
        raise ValueError(f"unsupported kernel: {g.kernel}")
    return spectrum_fused(w, idx, g.s, K, g.gl, g.root, sub.counts), sub


class SeGridBasis(NamedTuple):
    knn_res: KnnResult
    dist_mean: jnp.ndarray
    sub: SubsampleResult


def se_grid_setup(
    key: jax.Array,
    X_all: jnp.ndarray,
    g: GraphConfig,
    anchors: SubsampleResult | None = None,
) -> SeGridBasis:
    """One-time kNN for the SE bandwidth grid (src/Fit.cpp:126-131).

    ``anchors`` as in build_spectrum."""
    sub = anchors if anchors is not None else subsample(
        key, X_all, g.s, g.subsample, g.nstart, g.kmeans_iters
    )
    res = knn(X_all, sub.centers, g.r)
    n, r = res.indices.shape
    dist_mean = jnp.sum(res.sqdists) / (n * r)
    return SeGridBasis(res, dist_mean, sub)


def se_spectrum_at(basis: SeGridBasis, a2: jnp.ndarray, g: GraphConfig) -> EigenPair:
    """Spectrum for one bandwidth grid point: Z = exp(−d²/(a2·d̄))
    (src/Fit.cpp:150-158).  vmap over a2 for the whole grid."""
    vals = jnp.exp(-basis.knn_res.sqdists / (a2 * basis.dist_mean))
    Z = EllMatrix(vals, basis.knn_res.indices, g.s)
    Z = normalize_graph_laplacian(Z, g.gl, basis.sub.counts)
    return spectrum_from_Z(Z, g.resolved_K(), g.root)


# ---------------------------------------------------------------------------
# Nyström basis (src/Fit.cpp:221-358)
# ---------------------------------------------------------------------------


class NystromBasis(NamedTuple):
    dist_UU: jnp.ndarray     # (s, s)
    dist_allU: jnp.ndarray   # (n, s)
    dist_mean: jnp.ndarray
    centers: jnp.ndarray


def nystrom_setup(key: jax.Array, X_all: jnp.ndarray, g: GraphConfig) -> NystromBasis:
    sub = subsample(key, X_all, g.s, g.subsample, g.nstart, g.kmeans_iters)
    U = sub.centers
    dist_UU = sqdist(U, U)
    dist_allU = sqdist(X_all, U)
    dist_mean = jnp.mean(dist_UU)
    return NystromBasis(dist_UU, dist_allU, dist_mean, U)


def nystrom_anchor_eigs(basis: NystromBasis, a2: jnp.ndarray, K: int) -> Tuple[EigenPair, jnp.ndarray]:
    """Diffusion-map-normalized anchor eigensystem (src/Fit.cpp:265-282).

    Returns the anchor eigenpair (column-norm-√s vectors) and Z_UU (needed for
    the extension's column scaling at test time, src/Fit.cpp:321-325)."""
    s = basis.dist_UU.shape[0]
    Z_UU = jnp.exp(-basis.dist_UU / (a2 * basis.dist_mean))
    rowsums = jnp.sum(Z_UU, axis=1) + EPS
    A_UU = Z_UU / rowsums[:, None] / rowsums[None, :]
    sqrt_D_inv = 1.0 / jnp.sqrt(jnp.sum(A_UU, axis=1) + EPS)
    W_UU = sqrt_D_inv[:, None] * A_UU * sqrt_D_inv[None, :]
    w, V = jnp.linalg.eigh(W_UU)
    w = w[::-1][:K]
    V = V[:, ::-1][:, :K]
    V = sqrt_D_inv[:, None] * V
    colnorms = jnp.linalg.norm(V, axis=0)
    V = jnp.sqrt(jnp.asarray(s, V.dtype)) * V / (colnorms[None, :] + EPS)
    return EigenPair(w, V), Z_UU


def nystrom_extend(
    anchor: EigenPair,
    Z_UU: jnp.ndarray,
    dist_rows: jnp.ndarray,
    a2: jnp.ndarray,
    dist_mean: jnp.ndarray,
    col_scale_from_Z_UU_colsums: bool,
    rcond: float = 0.0,
) -> EigenPair:
    """Nyström extension V_ext = W_XU·V·Λ⁻¹ (src/Fit.cpp:284-291, 321-325).

    Training extension scales columns by Z_UU row sums; the test-time
    extension uses Z_UU column sums (identical for symmetric Z_UU; both kept
    for strict parity).

    ``rcond`` is a pinv-style relative cutoff on the inverse eigenvalues:
    columns with |λ_k| < rcond·max|λ| divide by the cutoff instead of λ_k.
    The anchor operator's spectrum decays to ~0 within a few dozen
    eigenvalues, so beyond that the raw 1/λ is pure noise amplification —
    measured on the n=1e5 spiral: the un-clamped extension produces a
    posterior whose adapted-metric Hessian condition is ~3e16 (vs ~1e3 for
    LAE) concentrated on exactly those near-null columns, collapsing NUTS
    step sizes 60× and ESS/sec ~40×.  rcond=1e-3 restores LAE-level mixing.
    Default 0.0 preserves the reference's exact formula
    (|λ|+1e-9 denominator, src/Fit.cpp:289)."""
    Z_XU = jnp.exp(-dist_rows / (a2 * dist_mean))
    rowsums = jnp.sum(Z_XU, axis=1) + EPS
    if col_scale_from_Z_UU_colsums:
        cols = jnp.sum(Z_UU, axis=0) + EPS
    else:
        cols = jnp.sum(Z_UU, axis=1) + EPS
    A_XU = Z_XU / rowsums[:, None] / cols[None, :]
    W_XU = A_XU / (jnp.sum(A_XU, axis=1) + EPS)[:, None]
    absvals = jnp.abs(anchor.values)
    denom = jnp.maximum(absvals, rcond * jnp.max(absvals))
    V_ext = jnp.matmul(W_XU, anchor.vectors, precision=PRECISION) / (
        denom[None, :] + EPS
    )
    return EigenPair(anchor.values, V_ext)


# ---------------------------------------------------------------------------
# GLGP basis — exact graph Laplacian on all n points (src/Fit.cpp:361-512)
# ---------------------------------------------------------------------------


class GlBasis(NamedTuple):
    sq_dists: jnp.ndarray      # dense (n, n) squared distances, or kNN (n, r)
    knn_idx: jnp.ndarray | None
    dist_mean: jnp.ndarray


def gl_setup(X_all: jnp.ndarray, sparse: bool, threshold: float) -> GlBasis:
    n = X_all.shape[0]
    if sparse:
        r = max(int(round(threshold * n)), 3)
        res = knn(X_all, X_all, r)
        return GlBasis(res.sqdists, res.indices, jnp.mean(res.sqdists))
    d = sqdist(X_all, X_all)
    return GlBasis(d, None, jnp.mean(d))


def gl_spectrum_at(basis: GlBasis, a2: jnp.ndarray, K: int) -> EigenPair:
    """Symmetrized, doubly-normalized GLGP spectrum for one bandwidth
    (src/Fit.cpp:413-448).  The kNN-sparse variant densifies the symmetrized
    graph — the truly-sparse large-n path is the distributed LOBPCG milestone."""
    if basis.knn_idx is not None:
        n, r = basis.knn_idx.shape
        Zd = jnp.zeros((n, n), dtype=basis.sq_dists.dtype)
        rows = jnp.broadcast_to(jnp.arange(n)[:, None], basis.knn_idx.shape)
        vals = jnp.exp(-basis.sq_dists / (a2 * basis.dist_mean))
        # .max combines duplicate (i, j) like sparse insert; kNN pairs are unique
        Zd = Zd.at[rows, basis.knn_idx].add(vals)
        Z = (Zd + Zd.T) / 2.0
    else:
        n = basis.sq_dists.shape[0]
        Z = jnp.exp(-basis.sq_dists / (a2 * basis.dist_mean))

    rowsum = jnp.sum(Z, axis=1) + EPS
    A = Z / rowsum[:, None] / rowsum[None, :]
    sqrt_D_inv = 1.0 / jnp.sqrt(jnp.sum(A, axis=1) + EPS)
    W = sqrt_D_inv[:, None] * A * sqrt_D_inv[None, :]
    w, V = jnp.linalg.eigh(W)
    w = w[::-1][:K]
    V = V[:, ::-1][:, :K]
    V = sqrt_D_inv[:, None] * V
    colnorms = jnp.linalg.norm(V, axis=0)
    V = jnp.sqrt(jnp.asarray(n, V.dtype)) * V / (colnorms[None, :] + EPS)
    return EigenPair(w, V)


def gl_spectrum_lobpcg(
    key: jax.Array, basis: GlBasis, a2: jnp.ndarray, K: int, iters: int = 80
) -> EigenPair:
    """Large-n GLGP spectrum without densifying: LOBPCG on the implicit
    symmetrized, doubly-normalized operator.

    The reference's sparse branch builds an Eigen CSR graph and hands it to
    RSpectra::eigs_sym (src/Fit.cpp:388-448).  Here the kNN self-graph stays
    as a static-shape COO edge list (ops.sparse_graph) and the operator

        W = D_A^{-1/2} · A · D_A^{-1/2},   A = D^{-1} · (Z+Zᵀ)/2 · D⁻¹

    is applied as gather + segment-sum matvecs — O(n·r·K) per LOBPCG
    iteration, no (n, n) materialization.  Same eigensystem as
    ``gl_spectrum_at`` (validated in tests/test_scale.py).
    """
    eig, _resid = gl_spectrum_lobpcg_status(key, basis, a2, K, iters)
    return eig


def gl_spectrum_lobpcg_status(
    key: jax.Array, basis: GlBasis, a2: jnp.ndarray, K: int, iters: int = 80
):
    """As gl_spectrum_lobpcg, additionally returning the per-eigenpair
    residual norms ‖A·x − θx‖ from the final iteration — the structured
    convergence status the GL drivers surface into ``FitResult.metrics``
    (the reference's only failure signal is NLopt's printed "nlopt failed!",
    src/train.cpp:63-65; RSpectra convergence is never checked,
    src/Fit.cpp:410-411)."""
    if basis.knn_idx is None:
        raise ValueError("gl_spectrum_lobpcg requires the sparse kNN basis")
    from ..ops.lobpcg import lobpcg_standard
    from ..ops.sparse_graph import glgp_operator, symmetrize_knn

    n = basis.knn_idx.shape[0]
    vals = jnp.exp(-basis.sq_dists / (a2 * basis.dist_mean))
    W, sqrt_da_inv = glgp_operator(symmetrize_knn(basis.knn_idx, vals, n))

    X0 = jax.random.normal(key, (n, K), vals.dtype)
    res = lobpcg_standard(W.matvec, X0, iters=iters)
    V = sqrt_da_inv[:, None] * res.eigenvectors
    colnorms = jnp.linalg.norm(V, axis=0)
    V = jnp.sqrt(jnp.asarray(n, V.dtype)) * V / (colnorms[None, :] + EPS)
    return EigenPair(res.eigenvalues, V), res.residual_norms
