"""No-U-Turn sampler, iterative formulation for XLA.

Recursion-free NUTS with multinomial trajectory sampling (Betancourt 2017)
and the O(log depth) checkpoint scheme for sub-tree U-turn checks (Phan &
Pradhan, numpyro's iterative algorithm — re-derived here for this codebase).
All control flow is ``lax.while_loop``; trees double up to ``max_depth``.

Chains vmap over the leading axis exactly like ``inference.hmc``; warmup
reuses the dual-averaging machinery.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .hmc import (
    DualAveragingState,
    HmcState,
    _find_reasonable_step,
    da_init,
    da_update,
    init_state,
    windowed_warmup,
)

LogProbFn = Callable[[jnp.ndarray], jnp.ndarray]


class _Phase(NamedTuple):
    """Full phase-space point."""

    x: jnp.ndarray
    p: jnp.ndarray
    logp: jnp.ndarray
    grad: jnp.ndarray


def _leapfrog1(logprob: LogProbFn, ph: _Phase, step, inv_mass) -> _Phase:
    p_half = ph.p + 0.5 * step * ph.grad
    x_new = ph.x + step * inv_mass * p_half
    logp, grad = jax.value_and_grad(logprob)(x_new)
    p_new = p_half + 0.5 * step * grad
    return _Phase(x_new, p_new, logp, grad)


def _energy(ph: _Phase, inv_mass) -> jnp.ndarray:
    return -ph.logp + 0.5 * jnp.sum(inv_mass * ph.p * ph.p)


def _is_turning(p_sharp_left, p_sharp_right, p_sum) -> jnp.ndarray:
    """Generalized U-turn criterion on the momentum sum."""
    return jnp.logical_or(
        jnp.dot(p_sharp_left, p_sum) <= 0, jnp.dot(p_sharp_right, p_sum) <= 0
    )


class _TrajState(NamedTuple):
    # frontier in the current integration direction
    frontier: _Phase
    # proposal (multinomial over the trajectory)
    prop_x: jnp.ndarray
    prop_logp: jnp.ndarray
    # trajectory statistics
    p_sum: jnp.ndarray
    log_weight: jnp.ndarray        # log Σ exp(-ΔH) over trajectory
    sum_accept: jnp.ndarray
    n_steps: jnp.ndarray
    diverged: jnp.ndarray
    turning: jnp.ndarray
    # checkpoint stacks for subtree U-turn checks
    ckpt_p: jnp.ndarray            # (max_depth, dim) momentum at checkpoints
    ckpt_psum: jnp.ndarray         # (max_depth, dim) cumulative p_sum at checkpoints
    key: jax.Array


def nuts_kernel(
    logprob: LogProbFn,
    key: jax.Array,
    state: HmcState,
    step: jnp.ndarray,
    inv_mass: jnp.ndarray,
    max_depth: int = 8,
) -> Tuple[HmcState, Tuple[jnp.ndarray, jnp.ndarray]]:
    """One NUTS transition.  Returns (new state, (mean acceptance statistic,
    leapfrog-step count)) — the count is what dispatch-wall guards budget on
    (see :func:`run_nuts_fixed_chunked`).

    Iterative doubling: direction is resampled per doubling; the new subtree
    of 2^depth leaves is integrated leaf-by-leaf with checkpointed U-turn
    checks at power-of-two boundaries (bitwise trick: leaf index i checkpoints
    at trailing-ones boundaries).
    """
    dim = state.x.shape[0]
    dtype = state.x.dtype
    k_mom, k_traj = jax.random.split(key)
    p0 = jax.random.normal(k_mom, (dim,), dtype) / jnp.sqrt(inv_mass)
    start = _Phase(state.x, p0, state.logp, state.grad)
    h0 = _energy(start, inv_mass)

    def build_subtree(carry, direction, depth_count, step_key):
        """Integrate 2^depth_count leaves in `direction` from the frontier."""
        (frontier, psum_init, key) = carry
        n_leaves = depth_count

        init = _TrajState(
            frontier=frontier,
            prop_x=jnp.zeros((dim,), dtype),
            prop_logp=jnp.asarray(-jnp.inf, dtype),
            p_sum=jnp.zeros((dim,), dtype),
            log_weight=jnp.asarray(-jnp.inf, dtype),
            sum_accept=jnp.zeros((), dtype),
            n_steps=jnp.zeros((), jnp.int32),
            diverged=jnp.asarray(False),
            turning=jnp.asarray(False),
            ckpt_p=jnp.zeros((max_depth + 1, dim), dtype),
            ckpt_psum=jnp.zeros((max_depth + 1, dim), dtype),
            key=step_key,
        )

        def leaf_cond(ts: _TrajState):
            return jnp.logical_and(
                ts.n_steps < n_leaves, ~jnp.logical_or(ts.diverged, ts.turning)
            )

        def leaf_body(ts: _TrajState):
            ph = _leapfrog1(logprob, ts.frontier, direction * step, inv_mass)
            h = _energy(ph, inv_mass)
            log_w = h0 - h
            diverged = jnp.logical_or(~jnp.isfinite(log_w), log_w < -1000.0)
            # a NaN-energy leaf must count as accept prob 0, not poison the
            # running sum (jnp.minimum(NaN, 0) is NaN): Stan's convention for
            # divergent leaves
            accept_stat = jnp.where(
                jnp.isfinite(log_w),
                jnp.minimum(1.0, jnp.exp(jnp.minimum(log_w, 0.0))),
                jnp.zeros((), dtype),
            )

            # multinomial proposal update within the subtree
            new_logw = jnp.logaddexp(ts.log_weight, log_w)
            key, k_sel = jax.random.split(ts.key)
            take = jnp.log(jax.random.uniform(k_sel, (), dtype)) < log_w - new_logw
            prop_x = jnp.where(take, ph.x, ts.prop_x)
            prop_logp = jnp.where(take, ph.logp, ts.prop_logp)

            i = ts.n_steps  # leaf index within subtree, 0-based
            p_sum = ts.p_sum + ph.p

            # Checkpoint scheme (numpyro's iterative subtree, re-derived):
            # slot range for leaf i: idx_max = popcount(i >> 1); subtrees of
            # sizes 2,4,… close at odd i — one per trailing 1-bit of i —
            # spanning slots [idx_max - trailing_ones(i) + 1, idx_max].
            def popcount(v):
                def body(c):
                    v, n = c
                    return v >> 1, n + (v & 1)

                _, n = jax.lax.while_loop(lambda c: c[0] > 0, body, (v, jnp.int32(0)))
                return n

            def trailing_ones(v):
                def body(c):
                    v, n = c
                    return v >> 1, n + 1

                _, n = jax.lax.while_loop(lambda c: (c[0] & 1) != 0, body, (v, jnp.int32(0)))
                return n

            idx_max = popcount(i >> 1)
            is_left = (i % 2) == 0

            # even leaf: store (momentum, cumulative-psum-before) at idx_max
            ckpt_p = jnp.where(is_left, ts.ckpt_p.at[idx_max].set(ph.p), ts.ckpt_p)
            ckpt_psum = jnp.where(
                is_left, ts.ckpt_psum.at[idx_max].set(p_sum - ph.p), ts.ckpt_psum
            )

            # odd leaf: check U-turn for every closing subtree
            n_close = jnp.where(is_left, 0, trailing_ones(i))
            idx_min = idx_max - n_close + 1

            def check_slot(l, turning):
                valid = jnp.logical_and(l >= idx_min, l <= idx_max)
                span_psum = p_sum - ckpt_psum[l]
                turn = _is_turning(inv_mass * ckpt_p[l], inv_mass * ph.p, span_psum)
                return jnp.where(
                    jnp.logical_and(valid, n_close > 0),
                    jnp.logical_or(turning, turn),
                    turning,
                )

            turning = jax.lax.fori_loop(0, max_depth + 1, check_slot, ts.turning)

            return _TrajState(
                frontier=ph,
                prop_x=prop_x,
                prop_logp=prop_logp,
                p_sum=p_sum,
                log_weight=new_logw,
                sum_accept=ts.sum_accept + accept_stat,
                n_steps=i + 1,
                diverged=jnp.logical_or(ts.diverged, diverged),
                turning=turning,
                ckpt_p=ckpt_p,
                ckpt_psum=ckpt_psum,
                key=key,
            )

        return jax.lax.while_loop(leaf_cond, leaf_body, init)

    # ---- outer doubling loop ------------------------------------------------
    class Outer(NamedTuple):
        left: _Phase
        right: _Phase
        prop_x: jnp.ndarray
        prop_logp: jnp.ndarray
        p_sum: jnp.ndarray
        log_weight: jnp.ndarray
        depth: jnp.ndarray
        done: jnp.ndarray
        sum_accept: jnp.ndarray
        n_steps: jnp.ndarray
        key: jax.Array

    outer0 = Outer(
        left=start,
        right=start,
        prop_x=start.x,
        prop_logp=start.logp,
        p_sum=p0,
        log_weight=jnp.zeros((), dtype),
        depth=jnp.int32(0),
        done=jnp.asarray(False),
        sum_accept=jnp.zeros((), dtype),
        n_steps=jnp.zeros((), jnp.int32),
        key=k_traj,
    )

    def outer_cond(o: Outer):
        return jnp.logical_and(o.depth < max_depth, ~o.done)

    def outer_body(o: Outer):
        key, k_dir, k_sub, k_merge = jax.random.split(o.key, 4)
        go_right = jax.random.uniform(k_dir, (), dtype) < 0.5
        direction = jnp.where(go_right, 1.0, -1.0).astype(dtype)
        frontier = jax.tree_util.tree_map(
            lambda a, b: jnp.where(go_right, a, b), o.right, o.left
        )
        n_new = jnp.int32(1) << o.depth
        sub = build_subtree((frontier, o.p_sum, key), direction, n_new, k_sub)

        invalid = jnp.logical_or(sub.diverged, sub.turning)

        # biased progressive sampling: accept the new subtree's proposal with
        # prob min(1, w_new/w_old)
        take = jnp.log(jax.random.uniform(k_merge, (), dtype)) < (
            sub.log_weight - o.log_weight
        )
        take = jnp.logical_and(take, ~invalid)
        prop_x = jnp.where(take, sub.prop_x, o.prop_x)
        prop_logp = jnp.where(take, sub.prop_logp, o.prop_logp)

        new_frontier = sub.frontier
        left = jax.tree_util.tree_map(
            lambda a, b: jnp.where(go_right, b, a), new_frontier, o.left
        )
        right = jax.tree_util.tree_map(
            lambda a, b: jnp.where(go_right, a, b), new_frontier, o.right
        )
        p_sum = o.p_sum + sub.p_sum
        turning_total = _is_turning(inv_mass * left.p, inv_mass * right.p, p_sum)
        done = jnp.logical_or(invalid, turning_total)
        return Outer(
            left=left,
            right=right,
            prop_x=prop_x,
            prop_logp=prop_logp,
            p_sum=p_sum,
            log_weight=jnp.logaddexp(o.log_weight, jnp.where(invalid, -jnp.inf, sub.log_weight)),
            depth=o.depth + 1,
            done=done,
            sum_accept=o.sum_accept + sub.sum_accept,
            n_steps=o.n_steps + sub.n_steps,
            key=key,
        )

    out = jax.lax.while_loop(outer_cond, outer_body, outer0)
    _, grad = jax.value_and_grad(logprob)(out.prop_x)
    new_state = HmcState(out.prop_x, out.prop_logp, grad)
    accept_stat = out.sum_accept / jnp.maximum(out.n_steps.astype(dtype), 1.0)
    return new_state, (accept_stat, out.n_steps)


class NutsRun(NamedTuple):
    samples: jnp.ndarray
    accept_stat: jnp.ndarray
    step: jnp.ndarray
    inv_mass: jnp.ndarray
    # (n_samples, n_chains) leapfrog steps per transition: the honest
    # gradient-evaluation count for ESS-per-gradient metrics, and the input
    # to dispatch-wall budgeting (run_nuts_fixed_chunked)
    n_leapfrog: jnp.ndarray


def run_nuts(
    key: jax.Array,
    logprob: LogProbFn,
    x0: jnp.ndarray,
    n_warmup: int = 500,
    n_samples: int = 1000,
    max_depth: int = 8,
    target_accept: float = 0.8,
    inv_mass0: jnp.ndarray | None = None,
) -> NutsRun:
    """Adaptive NUTS for a batch of chains (x0: (n_chains, dim)).

    ``inv_mass0`` (dim,) seeds the warmup metric — essential for posteriors
    with analytically-known anisotropy (see hmc.windowed_warmup)."""
    n_chains, dim = x0.shape
    dtype = x0.dtype

    def one_chain(key, x0_c):
        state = init_state(logprob, x0_c)
        k_warm, k_main = jax.random.split(key)

        def kernel(k, st, step, im):
            st, (ap, _) = nuts_kernel(logprob, k, st, step, im, max_depth)
            return st, ap

        state, step, inv_mass = windowed_warmup(
            kernel, logprob, k_warm, state, n_warmup, target_accept, dtype, inv_mass0
        )

        def main_body(state, k):
            state, (ap, ns) = nuts_kernel(logprob, k, state, step, inv_mass, max_depth)
            return state, (state.x, ap, ns)

        state, (draws, aps, nss) = jax.lax.scan(main_body, state, jax.random.split(k_main, n_samples))
        return draws, aps, nss, step, inv_mass

    draws, aps, nss, step, inv_mass = jax.vmap(one_chain)(jax.random.split(key, n_chains), x0)
    return NutsRun(
        jnp.swapaxes(draws, 0, 1), jnp.swapaxes(aps, 0, 1), step, inv_mass,
        jnp.swapaxes(nss, 0, 1),
    )


def run_nuts_fixed(
    key: jax.Array,
    logprob: LogProbFn,
    x0: jnp.ndarray,
    step: jnp.ndarray,
    inv_mass: jnp.ndarray,
    n_samples: int = 1000,
    max_depth: int = 8,
) -> NutsRun:
    """Steady-state NUTS sampling with FIXED per-chain (step, inv_mass) from
    a prior adaptive run — the sampling-phase throughput in isolation (see
    hmc.run_hmc_fixed).  x0: (n_chains, dim)."""
    n_chains, dim = x0.shape

    def one_chain(key, x0_c, step_c, im_c):
        state = init_state(logprob, x0_c)

        def main_body(state, k):
            state, (ap, ns) = nuts_kernel(logprob, k, state, step_c, im_c, max_depth)
            return state, (state.x, ap, ns)

        _, (draws, aps, nss) = jax.lax.scan(main_body, state, jax.random.split(key, n_samples))
        return draws, aps, nss

    draws, aps, nss = jax.vmap(one_chain)(jax.random.split(key, n_chains), x0, step, inv_mass)
    return NutsRun(
        jnp.swapaxes(draws, 0, 1), jnp.swapaxes(aps, 0, 1), step, inv_mass,
        jnp.swapaxes(nss, 0, 1),
    )


def run_nuts_fixed_chunked(
    key: jax.Array,
    logprob: LogProbFn,
    x0: jnp.ndarray,
    step: jnp.ndarray,
    inv_mass: jnp.ndarray,
    n_samples: int = 1000,
    max_depth: int = 8,
    max_dispatch_seconds: float = 20.0,
    calibration_draws: int = 4,
) -> NutsRun:
    """Steady-state NUTS split into dispatches of BOUNDED worst-case wall.

    A wide-batch NUTS program whose chains run deep trees in lockstep can
    run for a long, hard-to-predict time in one dispatch: the budget that
    matters is SEQUENTIAL leapfrog steps × per-step wall, not memory.  This
    driver bounds the wall of each dispatch, so a caller gets control back
    at a known cadence (progress, checkpoints, time limits).

    This driver (a) times a short calibration dispatch and converts its
    measured per-draw lockstep step count into seconds-per-sequential-step,
    (b) sizes every subsequent dispatch so its WORST-CASE wall —
    draws × (2^max_depth − 1) steps, every tree full — stays under
    ``max_dispatch_seconds``, and (c) carries only the chain states across
    dispatches.  The transition sequence is identical to
    :func:`run_nuts_fixed` draw-for-draw (same per-segment key splits would
    differ — each segment re-splits its own key — but the kernel and
    parameters are the same; this is a sampler, not a bit-repro gate).

    Not jittable as a whole (host loop); everything inside is jitted.
    """
    import time as _time

    n_chains, dim = x0.shape

    fixed = jax.jit(
        lambda k, x, ns: run_nuts_fixed(
            k, logprob, x, step, inv_mass, n_samples=ns, max_depth=max_depth
        ),
        static_argnums=(2,),
    )
    cal = min(calibration_draws, n_samples)
    k_cal, key = jax.random.split(key)
    t0 = _time.perf_counter()
    first = fixed(k_cal, x0, cal)
    first.samples.block_until_ready()
    cal_wall = _time.perf_counter() - t0
    # lockstep sequential steps actually executed: per draw, the slowest
    # chain's tree drives the vmapped while_loop
    seq_steps = float(jnp.sum(jnp.max(first.n_leapfrog, axis=1)))
    sec_per_step = cal_wall / max(seq_steps, 1.0)
    worst_per_draw = (1 << max_depth) - 1
    draws_per_dispatch = max(
        int(max_dispatch_seconds / (worst_per_draw * sec_per_step)), 1
    )

    outs = [first]
    done = cal
    x = first.samples[-1]
    while done < n_samples:
        ns = min(draws_per_dispatch, n_samples - done)
        k_seg, key = jax.random.split(key)
        seg = fixed(k_seg, x, ns)
        seg.samples.block_until_ready()
        x = seg.samples[-1]
        outs.append(seg)
        done += ns
    return NutsRun(
        jnp.concatenate([o.samples for o in outs], axis=0),
        jnp.concatenate([o.accept_stat for o in outs], axis=0),
        step,
        inv_mass,
        jnp.concatenate([o.n_leapfrog for o in outs], axis=0),
    )
