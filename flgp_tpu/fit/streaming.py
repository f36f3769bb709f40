"""Out-of-core fits: X streams from disk, the graph stays on device.

The reference holds X (and dense distance matrices) fully in RAM
(src/Fit.cpp:123-129); FLGP exists to scale n (DESCRIPTION:7-12), so here X
may exceed host memory.  The key observation: only X is large — the ELL graph
(values + indices, n×2r numbers) and the (n, K) eigenvector store are tiny by
comparison and device-resident.  So the streamed pipeline makes exactly ONE
pass over the on-disk matrix (``native.MatrixFile`` + double-buffered
``StreamLoader``), builds each chunk's kNN + kernel weights on device while
the next chunk loads, and scatters them into preallocated device buffers with
donated updates.  Everything downstream (Laplacian normalization, Gram+eigh
spectrum, GPR/GPC tails) is the standard in-memory path — bit-identical to a
non-streamed fit (tested in tests/test_streaming.py).

Anchors for out-of-core data come from reservoir-sampled rows + on-device
k-means (``streamed_subsample``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FitConfig, GraphConfig, KernelType
from ..native import MatrixFile, StreamLoader
from ..ops.kmeans import SubsampleResult, kmeans
from ..ops.knn import knn
from ..ops.lae import lae_weights
from ..ops.laplacian import normalize_graph_laplacian
from ..ops.spectrum import spectrum_from_Z, spectrum_fused
from ..types import EigenPair, EllMatrix


def reservoir_sample(mat: MatrixFile, size: int, chunk_rows: int = 1 << 16,
                     seed: int = 0) -> np.ndarray:
    """Uniform sample of ``size`` rows in one streamed pass (Vitter's
    Algorithm R, vectorized per chunk)."""
    if size > mat.shape[0]:
        raise ValueError("matrix smaller than the requested sample")
    rng = np.random.default_rng(seed)
    sample = np.empty((size, mat.shape[1]), mat.dtype)
    seen = 0
    for lo, chunk in StreamLoader(mat, chunk_rows):
        if seen < size:  # fill the reservoir first
            take = min(size - seen, len(chunk))
            sample[seen : seen + take] = chunk[:take]
            seen += take
            chunk = chunk[take:]
        if len(chunk):
            idx = seen + np.arange(len(chunk))
            j = rng.integers(0, idx + 1)
            take = j < size
            sample[j[take]] = chunk[take]
            seen += len(chunk)
    return sample


def streamed_subsample(
    key: jax.Array,
    mat: MatrixFile,
    g: GraphConfig,
    sample_factor: int = 50,
    chunk_rows: int = 1 << 16,
) -> SubsampleResult:
    """Anchors for out-of-core X: k-means++ on a uniform row sample of
    ``sample_factor``·s rows (one streamed pass), then a streamed 1-NN count
    pass so cluster-normalized Laplacians see true cluster sizes."""
    sample = reservoir_sample(mat, min(sample_factor * g.s, mat.shape[0]), chunk_rows)
    sub = kmeans(key, jnp.asarray(sample), g.s, nstart=g.nstart, iters=g.kmeans_iters)
    counts = np.zeros((g.s,), np.float64)
    assign = jax.jit(lambda X, U: knn(X, U, 1).indices[:, 0])
    for lo, chunk in StreamLoader(mat, chunk_rows):
        lab = np.asarray(assign(jnp.asarray(chunk, sub.centers.dtype), sub.centers))
        counts += np.bincount(lab, minlength=g.s)
    return SubsampleResult(sub.centers, jnp.asarray(counts, sub.centers.dtype))


@functools.partial(jax.jit, static_argnames=("g",), donate_argnums=(0, 1))
def _scatter_chunk(vals, idx, chunk, anchors, lo, g: GraphConfig):
    res = knn(chunk, anchors, g.r)
    if g.kernel == KernelType.LAE:
        w = lae_weights(chunk, anchors, res.indices)
    else:
        w = jnp.exp(-res.sqdists / (4.0 * g.epsilon * g.epsilon))
    vals = jax.lax.dynamic_update_slice(vals, w, (lo, 0))
    idx = jax.lax.dynamic_update_slice(idx, res.indices, (lo, 0))
    return vals, idx


def streamed_ell_graph(
    mat: MatrixFile,
    anchors: jnp.ndarray,
    g: GraphConfig,
    chunk_rows: int = 1 << 16,
) -> EllMatrix:
    """One streamed pass X → device-resident ELL graph (n, r).

    Host IO (prefetch thread) overlaps device compute; the fixed chunk shape
    compiles once (the tail chunk is padded then truncated by the scatter)."""
    n, d = mat.shape
    dtype = anchors.dtype
    chunk_rows = min(chunk_rows, n)
    vals = jnp.zeros((n, g.r), dtype)
    idx = jnp.zeros((n, g.r), jnp.int32)
    for lo, chunk in StreamLoader(mat, chunk_rows):
        if chunk.shape[0] < chunk_rows:
            # tail: shift the window back to [n - chunk_rows, n) so the
            # compiled chunk shape is reused; the overlap rows recompute to
            # identical values
            lo = n - chunk_rows
            chunk = mat.read(lo, chunk_rows)
        vals, idx = _scatter_chunk(
            vals, idx, jnp.asarray(chunk, dtype), anchors, lo, g
        )
    return EllMatrix(vals, idx, anchors.shape[0])


def streamed_build_spectrum(
    key: jax.Array,
    mat: MatrixFile,
    g: GraphConfig,
    chunk_rows: int = 1 << 16,
    anchors: Optional[SubsampleResult] = None,
) -> Tuple[EigenPair, SubsampleResult]:
    """Out-of-core equivalent of fit.spectral.build_spectrum: X on disk, the
    spectrum on device.  Matches the in-memory result bit-for-bit given the
    same anchors."""
    sub = anchors if anchors is not None else streamed_subsample(key, mat, g, chunk_rows=chunk_rows)
    Z = streamed_ell_graph(mat, sub.centers, g, chunk_rows)
    # the same tail as the in-memory fit.spectral.build_spectrum path
    return spectrum_fused(
        Z.values, Z.indices, g.s, g.resolved_K(), g.gl, g.root, sub.counts
    ), sub


class StreamedGpcResult(NamedTuple):
    """GPC outputs with every per-row array covering ALL n rows (train and
    test alike — the transductive layout of src/Fit.cpp:123-126)."""

    labels: jnp.ndarray      # (n,) PG-Gibbs argmax / threshold labels
    probs: jnp.ndarray       # (n,) binary — or (J, n) multiclass — PG probabilities
    post_mean: jnp.ndarray   # (n,) or (n, J) Laplace posterior mean
    post_var: jnp.ndarray    # (n,) or (n, J) Laplace posterior variance
    pars: dict


def _phi_train(eig: EigenPair, t, K: int, idx):
    """Whitened train-row features Φ_m = V_m·diag(exp(−t·λ/2)) — the K-dim
    factor of the heat kernel (C = ΦΦᵀ + σI)."""
    from ..ops.heat_kernel import heat_kernel_weights

    w = jnp.sqrt(heat_kernel_weights(eig, t, K))
    return eig.vectors[idx, :K] * w[None, :], w


def _pg_adjoints(key, Cvv, Y, N, n_gibbs: int, max_count: int, avg_sweeps: int):
    """PG-Gibbs dual weights: the chain runs on the small (m, m) train kernel
    exactly as the in-memory tail (inference/pg_gibbs.py), but instead of the
    dense (n, m) collapsed prediction we return the per-sweep adjoint vectors
    adj_s = κ − √ω B⁻¹√ω (C κ), so prediction anywhere is C[·, train]·adj —
    computable from the K-dim factor in O(K) per row."""
    from ..inference.pg_gibbs import pg_gibbs_chain, pg_gibbs_chain_trace

    m = Y.shape[0]
    kappa = Y - N / 2.0
    if avg_sweeps <= 0:
        final, _ = pg_gibbs_chain(key, Cvv, Y, n_gibbs, N, max_count)
        omegas = final.omega[None]
    else:
        _, _, om_trace = pg_gibbs_chain_trace(key, Cvv, Y, n_gibbs, N, max_count)
        omegas = om_trace[-min(avg_sweeps, n_gibbs):]

    from ..ops import linalg as _lin

    def adj_of(om):
        sqrt_om = jnp.sqrt(om)
        B = _lin.add_diag(sqrt_om[:, None] * Cvv * sqrt_om[None, :], jnp.ones((), Cvv.dtype))
        L_B = _lin.cholesky(B)
        a = _lin.pdot(Cvv, kappa[:, None])[:, 0]
        return kappa - sqrt_om * _lin.chol_solve(L_B, (sqrt_om * a)[:, None])[:, 0]

    return jax.vmap(adj_of)(omegas)  # (S, m)


def _chunked_rows(fn, V: jnp.ndarray, chunk: int):
    """Apply ``fn: (chunk, K) -> pytree of (chunk, ...)`` over row blocks of V
    with ``lax.map`` — peak extra memory O(chunk·K), never O(n·K) temporaries
    beyond V itself (the round-2 OOM lesson: (n, ·) intermediates are the
    enemy at n=1e7)."""
    n, K = V.shape
    chunk = min(chunk, n)
    n_blocks = -(-n // chunk)
    Vp = jnp.pad(V, ((0, n_blocks * chunk - n), (0, 0)))
    out = jax.lax.map(fn, Vp.reshape(n_blocks, chunk, K))
    return jax.tree_util.tree_map(
        lambda x: x.reshape((n_blocks * chunk,) + x.shape[2:])[:n], out
    )


def _gpc_lowrank_tail(
    key,
    eig: EigenPair,
    Y,
    N,
    train_idx,
    K: int,
    cfg: FitConfig,
    t,
    max_count: int,
    chunk: int = 1 << 16,
):
    """Binary-GPC predict tail in O(n·K) memory: PG-Gibbs labels +
    Rao-Blackwellized probabilities + Laplace posterior moments at EVERY row.

    The (m, m) train kernel is assembled with the same einsum as the
    in-memory tail (bit-identical Gibbs chain); everything n-sized streams
    through ``lax.map`` row blocks of the eigenvector store — the dense
    (n, m) cross-covariance of src/Predict.cpp:11-26 never exists."""
    from ..models.gpc import _newton_mode, sigmoid
    from ..ops import linalg as _lin
    from ..ops.heat_kernel import heat_kernel

    m = train_idx.shape[0]
    dtype = eig.vectors.dtype
    sigma = jnp.asarray(cfg.sigma, dtype)
    Cvv = heat_kernel(eig, t, K, train_idx, train_idx)
    Cvv = _lin.add_diag(Cvv, jnp.full((m,), cfg.sigma, dtype))
    Phi_m, w_half = _phi_train(eig, t, K, train_idx)

    # --- PG-Gibbs prediction ------------------------------------------------
    adjs = _pg_adjoints(key, Cvv, Y, N, cfg.n_gibbs, max_count, cfg.gibbs_avg_sweeps)
    P = _lin.pdot(adjs, Phi_m)  # (S, K): projected duals

    # --- Laplace posterior moments (GPML Alg 3.2, K-dim) ---------------------
    st = _newton_mode(Cvv, Y, jnp.ones((m,), dtype), cfg.train.newton_tol, cfg.train.newton_max_iter)
    pi_m = sigmoid(st.f)
    W = pi_m * (1.0 - pi_m)
    sqrt_W = jnp.sqrt(W)
    B = _lin.add_diag(sqrt_W[:, None] * Cvv * sqrt_W[None, :], jnp.ones((), dtype))
    Binv = _lin.chol_solve(_lin.cholesky(B), jnp.eye(m, dtype=dtype))
    beta = sqrt_W[:, None] * Binv * sqrt_W[None, :]
    M = _lin.pdot(Phi_m.T, _lin.pdot(beta, Phi_m))        # (K, K)
    resid = _lin.pdot(Phi_m.T, (Y - pi_m)[:, None])[:, 0]  # (K,)

    def per_block(Vc):
        Phi_c = Vc[:, :K] * w_half[None, :]
        mu = _lin.pdot(Phi_c, P.T)                        # (chunk, S)
        pi = jnp.mean(jax.nn.sigmoid(mu), axis=1)
        mean = _lin.pdot(Phi_c, resid[:, None])[:, 0]
        c22 = jnp.sum(Phi_c * Phi_c, axis=1) + sigma
        var = c22 - jnp.sum(_lin.pdot(Phi_c, M) * Phi_c, axis=1)
        return pi, mean, var

    pi_all, mean_all, var_all = _chunked_rows(per_block, eig.vectors, chunk)
    # train rows carry the σ-ridge cross term (their prediction row is Cvv,
    # which includes σ — src/Fit.cpp:565-575 concatenates [Cvv; Cnv])
    mu_train = _lin.pdot(Phi_m, P.T) + sigma * adjs.T     # (m, S)
    pi_all = pi_all.at[train_idx].set(jnp.mean(jax.nn.sigmoid(mu_train), axis=1))
    labels = (pi_all > 0.5).astype(dtype)
    return labels, pi_all, mean_all, var_all


def fit_lae_logit_gp_streamed(
    key: jax.Array,
    mat: MatrixFile,
    Y_train: np.ndarray,
    train_idx: np.ndarray,
    N: Optional[np.ndarray] = None,
    cfg: FitConfig = FitConfig(),
    chunk_rows: int = 1 << 16,
) -> StreamedGpcResult:
    """Out-of-core binary GPC: X streams from disk, the trained t is
    bit-identical to the in-memory driver (same _train_gpc on the same
    spectrum), and prediction/posterior run in O(n·K) memory
    (flagship path src/Fit.cpp:521-605 at out-of-core n)."""
    import dataclasses

    from .drivers import _train_gpc

    g = dataclasses.replace(cfg.graph, kernel=KernelType.LAE)
    eig, _ = streamed_build_spectrum(key, mat, g, chunk_rows)
    n = mat.shape[0]
    K = min(g.resolved_K(), g.s, n)
    Y = jnp.asarray(Y_train, cfg.dtype)
    idx = jnp.asarray(train_idx, jnp.int32)
    if N is None:
        N_arr = jnp.ones((idx.shape[0],), cfg.dtype)
        max_count = 1
    else:
        N_arr = jnp.asarray(N, cfg.dtype)
        max_count = int(np.max(np.asarray(N)))
    _, k_pg = jax.random.split(key)
    res = _train_gpc(eig, Y, N_arr, idx, K, cfg)
    labels, probs, mean, var = _gpc_lowrank_tail(
        k_pg, eig, Y, N_arr, idx, K, cfg, res.x, max_count, chunk_rows
    )
    return StreamedGpcResult(labels, probs, mean, var, dict(t=res.x, obj=res.obj))


def fit_lae_logit_mult_gp_streamed(
    key: jax.Array,
    mat: MatrixFile,
    Y_train: np.ndarray,
    train_idx: np.ndarray,
    cfg: FitConfig = FitConfig(),
    chunk_rows: int = 1 << 16,
) -> StreamedGpcResult:
    """Out-of-core multinomial (one-vs-rest) GPC: J binary t-optimizations
    vmapped over the shared streamed spectrum, per-class low-rank PG
    prediction, argmax labels (src/MultiClassification.cpp semantics at
    out-of-core n)."""
    import dataclasses

    from .drivers import _train_gpc
    from .multiclass import one_hot_labels

    g = dataclasses.replace(cfg.graph, kernel=KernelType.LAE)
    eig, _ = streamed_build_spectrum(key, mat, g, chunk_rows)
    n = mat.shape[0]
    K = min(g.resolved_K(), g.s, n)
    Y = jnp.asarray(Y_train, cfg.dtype)
    idx = jnp.asarray(train_idx, jnp.int32)
    m = idx.shape[0]
    J = int(np.max(np.asarray(Y_train))) + 1
    aug_y = one_hot_labels(Y, J)
    N_arr = jnp.ones((m,), cfg.dtype)
    res = jax.vmap(lambda yj: _train_gpc(eig, yj, N_arr, idx, K, cfg))(aug_y.T)
    _, k_pg = jax.random.split(key)
    keys = jax.random.split(k_pg, J)
    labels_j, probs, mean, var = jax.vmap(
        lambda k, yj, t: _gpc_lowrank_tail(
            k, eig, yj, N_arr, idx, K, cfg, t, 1, chunk_rows
        )
    )(keys, aug_y.T, res.x)
    labels = jnp.argmax(probs, axis=0).astype(cfg.dtype)
    return StreamedGpcResult(
        labels, probs, mean.T, var.T, dict(t=res.x, obj=res.obj)
    )


def fit_lae_regression_gp_streamed(
    key: jax.Array,
    mat: MatrixFile,
    Y_train: np.ndarray,
    train_idx: np.ndarray,
    cfg: FitConfig = FitConfig(sigma=1e-5),
    chunk_rows: int = 1 << 16,
):
    """Transductive GPR where the design matrix never fits in host memory:
    rows of ``mat`` are all points (train + test); ``train_idx`` marks the
    observed rows.  Returns (posterior mean at every row, trained params)."""
    import dataclasses

    from ..inference.optimize import GprOptResult  # noqa: F401 (re-export typing)
    from ..models import gpr as gpr_mod
    from .drivers import _train_gpr

    g = dataclasses.replace(cfg.graph, kernel=KernelType.LAE)
    eig, _ = streamed_build_spectrum(key, mat, g, chunk_rows)
    n = mat.shape[0]
    K = min(g.resolved_K(), g.s, n)
    Y = jnp.asarray(Y_train, cfg.dtype)
    idx = jnp.asarray(train_idx, jnp.int32)
    res = _train_gpr(eig, Y, idx, K, cfg)
    pred = gpr_mod.gpr_predict(eig, Y, idx, jnp.arange(n), K, res.t, res.noise, cfg.sigma)
    return pred, dict(t=res.t, noise=res.noise, obj=res.obj)
