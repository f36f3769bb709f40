"""Batched dense linear-algebra helpers shared by the model layer.

The reference's m≤K (direct Cholesky) / m>K (rank-K Woodbury) dual appears in
four places (src/train.cpp:351-433, src/Predict.cpp:40-117,
src/Utils.cpp:215-249); here it is factored once.  The reference's 1e-9
jitter inside log-Cholesky diagonals is kept for behavioral parity.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from ..config import EPS, PRECISION


def pdot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """matmul at HIGHEST precision — the model layer's default contraction
    (an f32 matmul otherwise runs in TF32 on the GPU; see config.PRECISION)."""
    return jnp.matmul(a, b, precision=PRECISION)


def cholesky(C: jnp.ndarray) -> jnp.ndarray:
    return jnp.linalg.cholesky(C)


def chol_solve(L: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Solve C x = B given L = chol(C) (lower)."""
    y = jsl.solve_triangular(L, B, lower=True)
    return jsl.solve_triangular(L.T, y, lower=False)


def chol_logdet_half(L: jnp.ndarray) -> jnp.ndarray:
    """Σ log(diag(L) + 1e-9): half log-determinant with the reference's jitter
    (src/train.cpp:392, 431)."""
    return jnp.sum(jnp.log(jnp.diagonal(L) + EPS))


def add_diag(C: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """C + diag(d) (d scalar or vector)."""
    idx = jnp.arange(C.shape[-1])
    return C.at[..., idx, idx].add(d)


def woodbury_solve_terms(
    V: jnp.ndarray,
    lam_sqrt: jnp.ndarray,
    z_inv: jnp.ndarray,
    Y: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Woodbury solve for C = V·diag(lam)·Vᵀ + diag(1/z_inv).

    Returns (alpha, L_Q) where alpha = C⁻¹Y and L_Q = chol(Q) with
    Q = Λ^{1/2}·Vᵀ·diag(z_inv)·V·Λ^{1/2} + I  (src/train.cpp:500-518 general
    per-point-noise form; the homoscedastic branch at src/train.cpp:393-405 is
    the special case z_inv = const with Q scaled by (noise+σ)).

    z_inv: (m,) elementwise inverse of the diagonal noise.  Y must be (m, q).
    The homoscedastic branch (src/train.cpp:393-405) is the z_inv = const
    special case: its Q is (noise+σ)·(ours), and the log-determinants agree
    through 0.5·(m−K)·log(noise+σ).
    """
    VtZiV = jnp.matmul(V.T, z_inv[:, None] * V, precision=PRECISION)
    Q = lam_sqrt[:, None] * VtZiV * lam_sqrt[None, :]
    Q = add_diag(Q, jnp.ones((), dtype=V.dtype))
    L_Q = cholesky(Q)
    ZiY = z_inv[:, None] * Y
    inner = chol_solve(L_Q, lam_sqrt[:, None] * jnp.matmul(V.T, ZiY, precision=PRECISION))
    alpha = ZiY - z_inv[:, None] * jnp.matmul(V, lam_sqrt[:, None] * inner, precision=PRECISION)
    return alpha, L_Q
