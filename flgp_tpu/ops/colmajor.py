"""Chunked feature-major spectral stage for huge point clouds (n ≳ 1e6).

Input arrives as a (d, n) cloud and the graph is built chunk by chunk under
``lax.map``, so the per-chunk intermediates (the (c, s) distance tile, the
(c, r, d) anchor gather, the FISTA state) stay O(chunk) whatever n is.  The
graph itself is kept in a CHUNKED 3-D layout with the point axis minor:

    idx, w : (nch, r, c)   — chunks stacked on a leading axis by lax.map
    grams  : (nch, r², c)

exactly the order the one-pass builder emits.  Rules the module keeps
(oracle-tested equal to ops.spectrum/ops.laplacian, src/Spectrum.cpp:101-161
semantics, in tests/test_colmajor.py):

- every gather/scatter runs on flat 1-D views, so pairing is preserved by
  reshape and no (r, n) index array is ever transposed;
- reductions over r use axis=-2 — no reshapes that move the point axis;
- the LAE FISTA loop runs per chunk inside the map (``ops.lae.lae_weights_t``:
  the Pallas-Triton kernel on CUDA lowerings, the XLA scan elsewhere);
- Gram AᵀA and the eigenvector extension scatter each chunk into a dense
  (c, s) block and use matmuls; the only O(n·K) arrays are the extension
  output and its tail-trim slice.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import EPS, PRECISION, KernelType, LaplacianType
from ..types import EigenPair
from .lae import lae_weights_t


def kmeans_anchors_colmajor(
    key: jax.Array,
    Xt: jnp.ndarray,
    s: int,
    n_sample: int = 1 << 17,
    nstart: int = 1,
    iters: int = 100,
) -> jnp.ndarray:
    """k-means anchors for a feature-major (d, n) cloud: k-means‖-seeded
    Lloyd on a uniform column sample of ``n_sample`` points (with
    replacement — immaterial at n ≫ n_sample).  This restores the
    reference's anchor semantics (src/Utils.cpp:37-56: k-means everywhere)
    on the huge-n path, where random-row anchors let the GPC error swing
    with the draw.

    The gather uses a 1-D column-index array; the (n_sample, d) transpose is
    a ~1.5 MB copy, nothing like a full-n transpose.  Jittable;
    returns (s, d) centers — full-n cluster sizes, when the
    CLUSTER_NORMALIZED Laplacian needs them, come from
    :func:`cluster_sizes_colmajor`."""
    from .kmeans import kmeans

    n = Xt.shape[1]
    k_idx, k_km = jax.random.split(key)
    cols = jax.random.randint(k_idx, (min(n_sample, n),), 0, n)
    Xs = Xt[:, cols].T
    return kmeans(k_km, Xs, s, nstart=nstart, iters=iters).centers


def cluster_sizes_colmajor(
    Xt: jnp.ndarray, centers: jnp.ndarray, chunk: int = 1 << 16
) -> jnp.ndarray:
    """Full-n 1-NN cluster counts for (d, n) input against (s, d) centers —
    the column the cluster-normalized Laplacian consumes
    (src/Utils.cpp:59-62), computed in the same chunked layout as
    :func:`build_graph_colmajor` (one fused-kNN r=1 pass, O(s) output)."""
    from .knn import knn

    d, n = Xt.shape
    s = centers.shape[0]
    chunk = min(chunk, ((n + 127) // 128) * 128)
    pad = (-n) % chunk
    Xp = jnp.pad(Xt, ((0, 0), (0, pad))) if pad else Xt
    nch = Xp.shape[1] // chunk

    def one(i):
        Xc = jax.lax.dynamic_slice(Xp, (0, i * chunk), (d, chunk))
        lab = knn(Xc.T, centers, 1).indices[:, 0]
        valid = (i * chunk + jnp.arange(chunk)) < n
        return jnp.zeros((s,), Xt.dtype).at[lab].add(valid.astype(Xt.dtype))

    return jnp.sum(jax.lax.map(one, jnp.arange(nch)), axis=0)


def build_graph_colmajor(
    Xt: jnp.ndarray,
    U: jnp.ndarray,
    r: int,
    kernel: KernelType = KernelType.LAE,
    epsilon_sq4: jnp.ndarray | None = None,
    lae_iters: int = 150,
    chunk: int = 1 << 16,
) -> tuple:
    """kNN + kernel weights for Xt (d, n) against anchors U (s, d).

    Returns (idx (nch, r, c) int32, w (nch, r, c)) — the RAW (un-normalized)
    ELL graph in the chunked layout; pad points (beyond n) carry zero
    weights so every downstream sum ignores them.  ``epsilon_sq4`` is the SE
    denominator (4ε² or a2·d̄, src/Spectrum.cpp:132 / src/Fit.cpp:150)."""
    d, n = Xt.shape
    s = U.shape[0]
    kernel = KernelType(kernel)
    dtype = Xt.dtype
    chunk = min(chunk, ((n + 127) // 128) * 128)

    pad = (-n) % chunk
    Xp = jnp.pad(Xt, ((0, 0), (0, pad))) if pad else Xt
    npad = Xp.shape[1]
    nch = npad // chunk

    # Chunks are dynamic-sliced from the (d, npad) array inside the map, and
    # every per-chunk array is CONSTRUCTED feature-major — no `.T` anywhere
    # after the kNN, so layout assignment has no transpose to propagate onto
    # the stacked (nch, ·, c) map outputs.  Gathers are safe anchors: a
    # gather's output shape IS its index shape.
    from .knn import knn

    def one(i):
        Xc = jax.lax.dynamic_slice(Xp, (0, i * chunk), (d, chunk))
        xc = Xc.T                                        # (c, d) — chunk-local
        res = knn(xc, U, r)
        idx = res.indices                                # (c, r)
        # feature-major arrays via r column-slices stacked on a NEW leading
        # axis (not a transpose of the (c, r) array)
        idx_t = jnp.stack([idx[:, k].astype(jnp.int32) for k in range(r)])
        if pad:
            # point j of chunk i is real iff i*c + j < n
            vc = (i * chunk + jnp.arange(chunk)) < n
        else:
            vc = None

        if kernel == KernelType.SE:
            d_t = jnp.stack([res.sqdists[:, k] for k in range(r)])
            wt = jnp.exp(jnp.minimum(-d_t, 0.0) / epsilon_sq4).astype(dtype)
            if vc is not None:
                wt = wt * vc[None, :].astype(dtype)
            return idx_t, wt
        # LAE terms from the gathered anchor rows — the small (s, d) table
        # gather fuses with the einsums; nothing (c, s)-sized is stored
        Ui = U[idx]                                      # (c, r, d)
        b_t = jnp.stack(
            [jnp.einsum("cd,cd->c", xc, Ui[:, k], precision=PRECISION) for k in range(r)]
        ).astype(dtype)
        G = jnp.einsum("crd,csd->crs", Ui, Ui, precision=PRECISION)
        G_t = jnp.stack(
            [G[:, a, b] for a in range(r) for b in range(r)]
        ).astype(dtype)
        w_t = lae_weights_t(G_t, b_t, lae_iters).astype(dtype)
        if vc is not None:
            w_t = w_t * vc[None, :].astype(dtype)
        return idx_t, w_t

    return jax.lax.map(one, jnp.arange(nch))


def normalize_colmajor(
    idx: jnp.ndarray,
    w: jnp.ndarray,
    s: int,
    gl: LaplacianType,
    cluster_sizes: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Graph-Laplacian normalization — identical semantics to
    ops.laplacian.normalize_graph_laplacian (src/Utils.cpp:195-212).

    Accepts any layout with r on axis −2 and points on axis −1: the chunked
    (nch, r, c) form or a flat (r, n).  All gathers/scatters run on flat
    1-D views, so no (r, ·) index array is ever transposed."""
    gl = LaplacianType(gl)
    shape = w.shape
    if gl != LaplacianType.RW:
        flat_idx = idx.reshape(-1)
        flat_w = w.reshape(-1)
        colsum = jnp.zeros((s,), w.dtype).at[flat_idx].add(flat_w)
        scale = 1.0 / (colsum + EPS)
        if gl == LaplacianType.CLUSTER_NORMALIZED:
            if cluster_sizes is None:
                raise ValueError("cluster-normalized Laplacian requires cluster sizes")
            scale = scale * cluster_sizes.astype(w.dtype)
        w = (flat_w * scale[flat_idx]).reshape(shape)
    rowsum = jnp.sum(w, axis=-2, keepdims=True)
    return w / (rowsum + EPS)


def spectrum_colmajor(
    idx: jnp.ndarray,
    w: jnp.ndarray,
    s: int,
    K: int,
    root: bool,
    n: int,
    gram_block: int = 1 << 15,
) -> EigenPair:
    """Top-K spectrum of W = Z·D⁻¹·Zᵀ from the chunked ELL graph — the exact
    Gram+eigh re-design of spectrum_from_Z (src/Spectrum.cpp:146-161).

    ``idx``/``w`` are (nch, r, c) (a flat (r, n) is accepted as one chunk);
    ``n`` is the REAL point count (pad points must carry zero weights).
    Each chunk scatters into dense (≤gram_block, s) blocks for the matmul
    Gram accumulation and eigenvector extension."""
    if idx.ndim == 2:
        idx, w = idx[None], w[None]
    nch, r, c = idx.shape
    dtype = w.dtype

    flat_idx = idx.reshape(-1)
    flat_w = w.reshape(-1)
    colsum = jnp.zeros((s,), dtype).at[flat_idx].add(flat_w)
    cinv = 1.0 / jnp.sqrt(jnp.abs(colsum) + EPS)
    a = (flat_w * cinv[flat_idx]).reshape(nch, r, c)  # A = Z·diag(colsum)^(-1/2)
    # barrier: `a` is read by BOTH the Gram scan and the extension map —
    # keep XLA from rematerializing the full-n gather inside each scan step
    a = jax.lax.optimization_barrier(a)

    # sub-block the chunk columns so the dense scatter block stays
    # O(gram_block·s) regardless of the build chunk size
    n_sub = max(1, -(-c // gram_block))
    sub = -(-c // n_sub)
    col_slices = [slice(j * sub, min((j + 1) * sub, c)) for j in range(n_sub)]

    def dense_of(ic, ac, sl):
        cols = sl.stop - sl.start
        rows = jnp.broadcast_to(jnp.arange(cols)[None, :], (r, cols))
        return jnp.zeros((cols, s), dtype).at[rows, ic[:, sl]].add(ac[:, sl])

    def gram_body(acc, blk):
        ic, ac = blk
        for sl in col_slices:
            dense = dense_of(ic, ac, sl)
            acc = acc + jnp.matmul(dense.T, dense, precision=PRECISION)
        return acc, None

    G, _ = jax.lax.scan(gram_body, jnp.zeros((s, s), dtype), (idx, a))
    wv, V = jnp.linalg.eigh(G)
    wv = wv[::-1][:K]
    V = V[:, ::-1][:, :K]
    sigma2 = jnp.maximum(wv, 0.0)
    sigma = jnp.sqrt(sigma2)

    # Eigenvector extension — vectors = A·(V·σ⁻¹·√n); the σ⁻¹/√n rescale is
    # folded into V so the only O(n·K) arrays are the map output and its
    # tail-trim slice.  Same dense-scatter matmul pattern as the Gram.
    V_ext = V * (jnp.sqrt(jnp.asarray(n, dtype)) / (sigma + EPS))[None, :]

    def ext_body(blk):
        ic, ac = blk
        outs = [
            jnp.matmul(dense_of(ic, ac, sl), V_ext, precision=PRECISION)
            for sl in col_slices
        ]
        return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)

    vectors = jax.lax.map(ext_body, (idx, a)).reshape(nch * c, K)[:n]
    values = sigma if root else sigma2
    return EigenPair(values, vectors)


def heat_kernel_spectrum_colmajor(
    Xt: jnp.ndarray,
    U: jnp.ndarray,
    r: int,
    K: int,
    gl: LaplacianType = LaplacianType.NORMALIZED,
    root: bool = True,
    kernel: KernelType = KernelType.LAE,
    epsilon_sq4: jnp.ndarray | None = None,
    cluster_sizes: jnp.ndarray | None = None,
    lae_iters: int = 150,
    chunk: int = 1 << 16,
) -> EigenPair:
    """Full graph → normalize → spectrum pipeline on (d, n) input: the
    huge-n equivalent of ops.spectrum.cross_similarity_* + spectrum_from_Z
    with peak device memory O(n·r) + the (n, K) output plus O(chunk)
    intermediates."""
    n = Xt.shape[1]
    s = U.shape[0]
    gl = LaplacianType(gl)
    idx_c, w_c = build_graph_colmajor(Xt, U, r, kernel, epsilon_sq4, lae_iters, chunk)
    # stage barriers: without them XLA rematerializes the expensive build
    # (kNN + 150-iteration FISTA) inside the downstream Gram/extension scans
    idx_c, w_c = jax.lax.optimization_barrier((idx_c, w_c))
    sizes = cluster_sizes if gl == LaplacianType.CLUSTER_NORMALIZED else None
    wn = normalize_colmajor(idx_c, w_c, s, gl, sizes)
    idx_c, wn = jax.lax.optimization_barrier((idx_c, wn))
    return spectrum_colmajor(idx_c, wn, s, K, root, n)
