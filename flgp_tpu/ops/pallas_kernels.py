"""Pallas kernel for the local anchor embedding's FISTA loop, through Triton.

Under XLA the 150-iteration FISTA loop of ``ops.lae.lae_weights_xla`` is a
``lax.scan`` whose every step makes several full passes over (n, r) arrays
in device memory, plus a sort and a gather for the simplex projection.  The
work per point is independent and has no matrix product, so here one Triton
program owns a block of points: it loads that block's Gram entries
``Gt (r², n)`` and linear terms ``bt (r, n)`` once, coalesced along the point
axis, runs every iteration in registers with the r-structure unrolled, and
writes ``w (r, n)`` once.  Tail points are masked on load and store.

The kernel is reached only through ``ops.lae.lae_weights_t``, which picks it
per lowering (``cuda``) and runs the XLA scan everywhere else; the point-major
``ops.lae.lae_weights`` and the chunked ``ops.colmajor`` builder both call
that.  ``interpret=True`` runs it through the Pallas
interpreter on any backend; the tests use that on the CPU.

Limits: no gradient rule (nothing differentiates through the LAE weights),
and not batched — ``pl.program_id(0)`` is the point-block index, which a
``vmap`` around the call would re-target.  ``shard_map`` is fine: each shard
runs the kernel on its local points.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

# Points per Triton program.  At r=3 a point needs ~30 live registers, so
# 256 points over 4 warps (2 points a thread) keeps the kernel far from the
# 255-register limit, and n=1e6 gives 3,907 programs — ~30 waves over the
# H100's 132 SMs, enough to hide the one load and one store each makes.
LAE_BLOCK = 256
LAE_NUM_WARPS = 4


def _lae_fista_kernel(gt_ref, bt_ref, w_ref, *, r: int, iters: int, block: int):
    """FISTA for one block of points; every per-point quantity is one (block,)
    vector and the r-wide recurrences are unrolled in Python.  The simplex
    projection is an odd-even transposition sort network over the r vectors,
    so there is no data-dependent control flow (src/lae.cpp:137-153)."""
    n = w_ref.shape[1]
    start = pl.program_id(0) * block
    cols = pl.ds(start, block)
    mask = start + jnp.arange(block, dtype=jnp.int32) < n
    dtype = w_ref.dtype

    # row indices as int32 beside the int32 program id: under x64 a bare
    # Python int would make the interpreter's slice starts mixed-width
    def load(ref, k):
        return plt.load(ref.at[jnp.int32(k), cols], mask=mask, other=0.0).astype(dtype)

    G = [[load(gt_ref, i * r + j) for j in range(r)] for i in range(r)]
    b = [load(bt_ref, k) for k in range(r)]

    # Gershgorin bound on λmax(G) → fixed FISTA step 1/L (masked points have
    # G = 0, b = 0 and so stay at their finite start value)
    L = None
    for i in range(r):
        row = jnp.abs(G[i][0])
        for j in range(1, r):
            row = row + jnp.abs(G[i][j])
        L = row if L is None else jnp.maximum(L, row)
    inv_L = 1.0 / (L + 1e-12)

    def project_simplex(w):
        u = list(w)
        for p in range(r):
            for i in range(p % 2, r - 1, 2):
                u[i], u[i + 1] = jnp.maximum(u[i], u[i + 1]), jnp.minimum(u[i], u[i + 1])
        css = u[0]
        theta = css - 1.0
        for k in range(1, r):
            css = css + u[k]
            cand = (css - 1.0) / (k + 1.0)
            theta = jnp.where(u[k] - cand > 0, cand, theta)
        return tuple(jnp.maximum(w[k] - theta, 0.0) for k in range(r))

    def body(_, carry):
        z_prev, z, d_prev, d_curr = carry
        alpha = (d_prev - 1.0) / d_curr
        v = [z[k] + alpha * (z[k] - z_prev[k]) for k in range(r)]
        w = []
        for s_ in range(r):
            # Σ_k v_k G_ks first, then − b: the XLA scan's order of operations
            g = v[0] * G[0][s_]
            for k in range(1, r):
                g = g + v[k] * G[k][s_]
            w.append(v[s_] - inv_L * (g - b[s_]))
        d_next = (1.0 + jnp.sqrt(1.0 + 4.0 * d_curr * d_curr)) / 2.0
        return (z, project_simplex(w), d_curr, d_next)

    z0 = tuple(jnp.full((block,), 1.0 / r, dtype) for _ in range(r))
    _, z, _, _ = jax.lax.fori_loop(
        0, iters, body, (z0, z0, jnp.asarray(0.0, dtype), jnp.asarray(1.0, dtype))
    )
    for k in range(r):
        plt.store(w_ref.at[jnp.int32(k), cols], z[k], mask=mask)


def lae_fista_t(
    Gt: jnp.ndarray,
    bt: jnp.ndarray,
    iters: int = 150,
    *,
    block: int = LAE_BLOCK,
    interpret: bool = False,
) -> jnp.ndarray:
    """FISTA simplex weights from feature-major inputs: Gt (r², n) flattened
    per-point Grams U_iU_iᵀ and bt (r, n) linear terms U_i·x → (r, n), in
    the dtype of ``bt``.  One Triton program per ``block`` points."""
    r, n = bt.shape
    assert Gt.shape == (r * r, n), (Gt.shape, bt.shape)
    return pl.pallas_call(
        functools.partial(_lae_fista_kernel, r=r, iters=iters, block=block),
        grid=(pl.cdiv(n, block),),
        out_shape=jax.ShapeDtypeStruct((r, n), bt.dtype),
        compiler_params=plt.CompilerParams(num_warps=LAE_NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="lae_fista",
    )(Gt.astype(bt.dtype), bt)
