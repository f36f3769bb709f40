"""Core pytree containers: ELL sparse matrices and eigen-pairs.

The reference stores the cross-similarity matrix Z as an Eigen row-major CSR
sparse matrix with exactly ``r`` nonzeros per row (src/lae.cpp:60-67,
src/Utils.cpp:146-189).  Dynamic sparsity is hostile to XLA; a fixed
fan-in ELL layout — dense ``(n, r)`` values plus ``(n, r)`` column indices —
keeps every downstream op (column sums, normalizations, mat-vecs, Gram
matrices) a gather / segment-sum / blocked matmul with static shapes.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .config import EPS, PRECISION


@jax.tree_util.register_pytree_node_class
class EllMatrix:
    """Row-sparse (n, s) matrix with fixed fan-in r.

    ``values[i, k]`` is the entry at ``(i, indices[i, k])``.  Duplicate column
    indices within a row are allowed (they act additively in every op).
    """

    def __init__(self, values: jnp.ndarray, indices: jnp.ndarray, num_cols: int):
        self.values = values
        self.indices = indices
        self.num_cols = int(num_cols)

    # -- pytree protocol ---------------------------------------------------
    def tree_flatten(self):
        return (self.values, self.indices), self.num_cols

    @classmethod
    def tree_unflatten(cls, aux, children):
        values, indices = children
        return cls(values, indices, aux)

    # -- basic properties --------------------------------------------------
    @property
    def shape(self) -> Tuple[int, int]:
        return (self.values.shape[0], self.num_cols)

    @property
    def fan_in(self) -> int:
        return self.values.shape[1]

    @property
    def dtype(self):
        return self.values.dtype

    # -- ops ---------------------------------------------------------------
    def rowsum(self) -> jnp.ndarray:
        return jnp.sum(self.values, axis=1)

    def colsum(self) -> jnp.ndarray:
        """Column sums via segment-sum (the reference computes 1ᵀZ,
        src/Spectrum.cpp:149)."""
        out = jnp.zeros((self.num_cols,), dtype=self.values.dtype)
        return out.at[self.indices.reshape(-1)].add(self.values.reshape(-1))

    def scale_rows(self, scale: jnp.ndarray) -> "EllMatrix":
        return EllMatrix(self.values * scale[:, None], self.indices, self.num_cols)

    def scale_cols(self, scale: jnp.ndarray) -> "EllMatrix":
        return EllMatrix(self.values * scale[self.indices], self.indices, self.num_cols)

    def matvec(self, v: jnp.ndarray) -> jnp.ndarray:
        """Z @ v for v of shape (s,)."""
        return jnp.sum(self.values * v[self.indices], axis=1)

    def rmatvec(self, u: jnp.ndarray) -> jnp.ndarray:
        """Zᵀ @ u for u of shape (n,)."""
        out = jnp.zeros((self.num_cols,), dtype=self.values.dtype)
        return out.at[self.indices.reshape(-1)].add(
            (self.values * u[:, None]).reshape(-1)
        )

    def to_dense(self) -> jnp.ndarray:
        n, s = self.shape
        out = jnp.zeros((n, s), dtype=self.values.dtype)
        rows = jnp.broadcast_to(jnp.arange(n)[:, None], self.indices.shape)
        return out.at[rows, self.indices].add(self.values)

    def matmat(self, W: jnp.ndarray, block: int = 4096) -> jnp.ndarray:
        """Z @ W for dense W of shape (s, K).

        Gathers W rows per nonzero: (n, r, K) contraction over r.  For modest
        r this is bandwidth-bound and well-shaped for the VPU; blocked over
        rows so the gather buffer stays small.
        """
        n = self.shape[0]
        if n <= block:
            return jnp.einsum("nr,nrk->nk", self.values, W[self.indices], precision=PRECISION)

        pad = (-n) % block
        vals = jnp.pad(self.values, ((0, pad), (0, 0)))
        idx = jnp.pad(self.indices, ((0, pad), (0, 0)))
        vals = vals.reshape(-1, block, self.fan_in)
        idx = idx.reshape(-1, block, self.fan_in)

        def body(carry, blk):
            v, i = blk
            return carry, jnp.einsum("nr,nrk->nk", v, W[i], precision=PRECISION)

        _, out = jax.lax.scan(body, None, (vals, idx))
        return out.reshape(-1, out.shape[-1])[:n]

    def rmatmat(self, M: jnp.ndarray) -> jnp.ndarray:
        """Zᵀ @ M for dense M of shape (n, K): scatter-add of weighted rows.

        The transpose matvec of the large-n GLGP operator (the reference's
        sparse self-graph is symmetrized as (Z+Zᵀ)/2, src/Fit.cpp:417)."""
        out = jnp.zeros((self.num_cols, M.shape[1]), dtype=self.values.dtype)
        return out.at[self.indices.reshape(-1)].add(
            (self.values[..., None] * M[:, None, :]).reshape(-1, M.shape[1])
        )

    def gram(self, block: int = 2048) -> jnp.ndarray:
        """ZᵀZ as a dense (s, s) matrix.

        Densify row blocks into (block, s) tiles and accumulate
        blockᵀ @ block with matmuls.  This replaces the sequential
        Lanczos the reference delegates to RSpectra (src/TruncatedSVD.cpp:23-28)
        with one exact Gram + eigh.
        """
        n, s = self.shape
        pad = (-n) % block
        vals = jnp.pad(self.values, ((0, pad), (0, 0)))
        idx = jnp.pad(self.indices, ((0, pad), (0, 0)))
        vals = vals.reshape(-1, block, self.fan_in)
        idx = idx.reshape(-1, block, self.fan_in)
        rows = jnp.arange(block)[:, None]

        def body(acc, blk):
            v, i = blk
            dense = jnp.zeros((block, s), dtype=v.dtype).at[
                jnp.broadcast_to(rows, i.shape), i
            ].add(v)
            return acc + jnp.matmul(dense.T, dense, precision=PRECISION), None

        acc0 = jnp.zeros((s, s), dtype=self.values.dtype)
        out, _ = jax.lax.scan(body, acc0, (vals, idx))
        return out


@jax.tree_util.register_pytree_node_class
class EigenPair:
    """Spectral pair of the two-step similarity matrix W.

    ``values`` are eigenvalues of W (σ² of A, or σ when ``root``;
    src/Spectrum.cpp:146-161, src/TruncatedSVD.cpp:18-30); ``vectors`` are
    the √n-rescaled eigenvectors, one row per data point.
    """

    def __init__(self, values: jnp.ndarray, vectors: jnp.ndarray):
        self.values = values
        self.vectors = vectors

    def tree_flatten(self):
        return (self.values, self.vectors), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def K(self) -> int:
        return self.values.shape[-1]

    def laplacian_eigenvalues(self, K: int) -> jnp.ndarray:
        """Graph-Laplacian eigenvalues 1 - λ(W) (src/Spectrum.cpp:86)."""
        return 1.0 - self.values[..., :K]
