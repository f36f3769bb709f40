"""Chain-parallel MCMC over a device mesh.

HMC chains are independent, so the chain axis shards with zero collectives in
the hot loop; cross-chain statistics (R̂, pooled step-size summaries, SMC
resampling) are the only communication points.  With C chains on D devices
each device integrates C/D chains, batched by the inner vmap of
``inference.hmc.run_hmc`` — leapfrog gradient evaluations for all local
chains fuse into single batched matmuls.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..inference.chees import CheesRun, run_chees
from ..inference.hmc import HmcRun, run_hmc
from ..inference.nuts import NutsRun, run_nuts


def sharded_hmc_fn(
    mesh: Mesh,
    logprob: Callable[[jnp.ndarray], jnp.ndarray],
    n_warmup: int,
    n_samples: int,
    n_leapfrog: int = 16,
    axis: str = "chain",
):
    """Returns fn(keys (C, 2), x0 (C, dim)) → HmcRun with the chain axis
    sharded over ``axis``.  C must be a multiple of the axis size.

    ``keys`` is the natural ``jax.random.split(key, C)`` output — one raw
    uint32 key pair per chain; each shard seeds its local ``run_hmc`` batch
    from its first local pair (the inner vmap re-splits per chain)."""

    def fn(keys_local, x0_local):
        run = run_hmc(
            keys_local[0],
            logprob,
            x0_local,
            n_warmup=n_warmup,
            n_samples=n_samples,
            n_leapfrog=n_leapfrog,
        )
        return run

    return jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=HmcRun(
            P(None, axis), P(None, axis), P(axis), P(axis)
        ),
        check_vma=False,
    )


def sharded_nuts_fn(
    mesh: Mesh,
    logprob: Callable[[jnp.ndarray], jnp.ndarray],
    n_warmup: int,
    n_samples: int,
    max_depth: int = 8,
    target_accept: float = 0.8,
    axis: str = "chain",
):
    """Chain-sharded NUTS: fn(keys (C, 2), x0 (C, dim)) → NutsRun with the
    chain axis sharded over ``axis``; ``keys`` is the natural
    ``jax.random.split(key, C)`` output, one raw key pair per chain.  Like
    HMC, chains are independent — warmup adaptation (dual averaging +
    diagonal mass) is per-chain, so the hot loop has zero collectives; pool
    results with :func:`pooled_mean_variance` / ``inference.diagnostics``
    afterwards."""

    def fn(keys_local, x0_local):
        return run_nuts(
            keys_local[0],
            logprob,
            x0_local,
            n_warmup=n_warmup,
            n_samples=n_samples,
            max_depth=max_depth,
            target_accept=target_accept,
        )

    return jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=NutsRun(
            P(None, axis), P(None, axis), P(axis), P(axis), P(None, axis)
        ),
        check_vma=False,
    )


def sharded_chees_fn(
    mesh: Mesh,
    logprob: Callable[[jnp.ndarray], jnp.ndarray],
    n_warmup: int,
    n_samples: int,
    max_steps: int = 256,
    axis: str = "chain",
):
    """Chain-sharded ChEES-HMC: fn(keys (C, 2), x0 (C, dim)) → CheesRun.

    Unlike HMC/NUTS sharding, adaptation here is CROSS-chain — every
    reduction inside ``inference.chees`` rides one ``pmean`` over ``axis``
    (step-size harmonic mean, ChEES criterion gradient, metric moments), so
    all devices hold identical adapted (ε, τ, M⁻¹) and the per-iteration
    leapfrog count stays batch-uniform across the whole mesh.  Collective
    payload per iteration: 3 scalars + 2 (dim,) vectors — independent of the
    chain count."""

    def fn(keys_local, x0_local):
        return run_chees(
            keys_local[0],
            logprob,
            x0_local,
            n_warmup=n_warmup,
            n_samples=n_samples,
            max_steps=max_steps,
            axis_name=axis,
        )

    return jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=CheesRun(P(None, axis), P(None, axis), P(), P(), P(), P()),
        check_vma=False,
    )


def pooled_mean_variance(mesh: Mesh, draws: jax.Array, axis: str = "chain"):
    """Cross-chain posterior mean/variance with the chain axis sharded:
    one psum each (the collective the reference never needed)."""

    def fn(d_local):
        # d_local: (n_samples, chains_local, dim)
        s = jnp.sum(d_local, axis=(0, 1))
        ss = jnp.sum(d_local * d_local, axis=(0, 1))
        cnt = jnp.asarray(d_local.shape[0] * d_local.shape[1], d_local.dtype)
        s = jax.lax.psum(s, axis)
        ss = jax.lax.psum(ss, axis)
        cnt = jax.lax.psum(cnt, axis)
        mean = s / cnt
        var = ss / cnt - mean * mean
        return mean, var

    return jax.shard_map(
        fn, mesh=mesh, in_specs=(P(None, axis),), out_specs=(P(), P()), check_vma=False
    )(draws)
