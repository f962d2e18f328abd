"""Batched LDPC syndrome decoders — the framework's hot path.

All six reference algorithms share one message-passing skeleton
(reference: src/qkd_ldpc_algorithm.cpp:3-1029 — six functions differing only
in the check-node update and, for the adaptive pair, where convergence is
detected). Here the skeleton is batched over frames and expressed on the
degree-grouped edge layout in **batch-minor** orientation: message state is
``[E, B]`` (edges major, frames minor) so that

  * the inter-enumeration regroup — the only irregular memory access in the
    decoder — is a *row* gather (`take(..., axis=0)`) moving contiguous
    B-sized lines, unlike an element gather along a minor axis;
  * each degree group's check/bit pass is a contiguous row-slice reshaped to
    ``[count, degree, B]`` with the reduction over the middle axis, keeping
    the batch dimension innermost and contiguous.

Per iteration (everything static-shape, inside one ``lax.while_loop``):
  1. check pass per degree group (tanh-product or two-minimum/sign-parity),
  2. one row gather regroups extrinsics to bit-major order,
  3. bit pass per degree group: total LLR, hard decision, new messages,
  4. one row gather back to check-major order,
  5. per-frame convergence masks (frames whose decision syndrome matches
     Alice's freeze their decision and record the first-success iteration).

Two accumulation modes share the code path:
  * fast mode (float32/bfloat16): vectorized reductions; order differs from
    the C++ reference, which is irrelevant at these precisions' FER.
  * exact mode (float64): statically-unrolled sequential accumulation
    matching the reference's operation order bit-for-bit (IEEE adds are not
    associative; messages landing exactly on 0.0 flip sign under
    reassociation and cascade through min-sum sign products).

Exact reference semantics preserved per frame in both modes: hard-decision
tie-break ``total <= 0 -> 1`` (:80-83), two-minimum tie handling (ties at
the minimum emit min2 == min1, :389-396), min-sum sign conventions (parity
counts m < 0; exclusion sign treats 0 as negative, :383/:402), OMSA
clamp-at-zero (:574), adaptive per-check factor selection from the
*previous* decision's syndrome with convergence detected inside the check
pass (:745-776), and the optional message-LLR threshold clamp applied at the
reference's exact program points (:73-74, :122-123).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from qkd_ldpc_v_tpu.config import DecodingAlgorithm
from qkd_ldpc_v_tpu.models.layout import EdgeLayout
from qkd_ldpc_v_tpu.ops.linapprox import (
    atanh_lin_approx,
    guard_atanh_ratio,
    tanh_lin_approx,
)


class DecodeResult(NamedTuple):
    """Per-frame outcome (batch-shaped analogue of the reference's
    ``decoding_result`` + corrected key, src/qkd_ldpc_algorithm.hpp:16-26)."""

    decision: jax.Array  # [B, N] int8, external bit order
    syndromes_match: jax.Array  # [B] bool
    iterations: jax.Array  # [B] int32 (first-success iteration, or the cap)


def _group_views(flat: jax.Array, groups):
    """Yield (group, [count, degree, B]) contiguous views of a flat [E, B]."""
    b = flat.shape[-1]
    for g in groups:
        size = g.count * g.degree
        yield g, jax.lax.dynamic_slice_in_dim(flat, g.edge_offset, size, axis=0).reshape(
            g.count, g.degree, b
        )


def _concat_groups(parts):
    return jnp.concatenate(parts, axis=0)


def _sum_terms(init: jax.Array, terms: jax.Array, exact: bool) -> jax.Array:
    """init [c,B] + sum of terms [c,d,B] over the degree axis, always in
    the reference's sequential order (std::accumulate starting from the
    channel LLR, src/qkd_ldpc_algorithm.cpp:78).

    XLA's lowering of a ``jnp.sum`` reduce is backend-dependent (a backend
    may reassociate it), which would make "bit-exact" a platform-dependent
    claim at ulp-sensitive frames. Explicit sequential accumulation pins
    one association — the same one the QC decoders use — on every backend.
    Degrees are <= ~6, so the unrolled adds cost what the reduce did."""
    acc = init
    for s in range(terms.shape[1]):
        acc = acc + terms[:, s, :]
    return acc


def _prod_terms(init: jax.Array, terms: jax.Array, exact: bool) -> jax.Array:
    """init [c,B] * product of terms [c,d,B] over the degree axis (reference
    sequential row product: src/qkd_ldpc_algorithm.cpp:57-62)."""
    if not exact:
        return init * jnp.prod(terms, axis=1)
    acc = init
    for s in range(terms.shape[1]):
        acc = acc * terms[:, s, :]
    return acc


def _two_minimum(a: jax.Array, big) -> tuple[jax.Array, jax.Array, jax.Array]:
    """min1, min2, is_min over the degree axis (axis=1) with the reference's
    sequential tie semantics: a tie at the minimum makes min2 == min1
    (reference: src/qkd_ldpc_algorithm.cpp:381-397)."""
    min1 = jnp.min(a, axis=1)
    is_min = a == min1[:, None, :]
    count_min = jnp.sum(is_min, axis=1)
    min2_raw = jnp.min(jnp.where(is_min, big, a), axis=1)
    min2 = jnp.where(count_min >= 2, min1, min2_raw)
    return min1, min2, is_min


def _minsum_check_stats(msgs: jax.Array, syn_sign: jax.Array, big):
    """Common min-sum per-check reduction.

    msgs [c,d,B], syn_sign [c,B] ->
    (row_sign [c,B], excl_sign [c,d,B], eabs [c,d,B]).
    """
    a = jnp.abs(msgs)
    min1, min2, is_min = _two_minimum(a, big)
    neg = jnp.sum(msgs < 0, axis=1)
    row_sign = syn_sign * jnp.where(neg % 2 == 0, 1.0, -1.0).astype(msgs.dtype)
    excl_sign = jnp.where(msgs > 0, 1.0, -1.0).astype(msgs.dtype)
    eabs = jnp.where(is_min, min2[:, None, :], min1[:, None, :])
    return row_sign, excl_sign, eabs


def make_decoder(
    layout: EdgeLayout,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
    dtype=jnp.float32,
    edge_constraint=None,
) -> Callable[..., DecodeResult]:
    """Build a jittable batched decoder for one matrix layout.

    The returned function has signature
        ``decode(llr_ext [B,N], syndrome_ext [B,M] int8, primary, secondary,
                 threshold) -> DecodeResult``
    where primary/secondary are the algorithm's scaling factors (ignored for
    SPA variants) and threshold the optional message-LLR clamp value (traced,
    so sweeps over factors don't recompile).

    ``edge_constraint`` (optional) is applied to every flat ``[E, B]``
    message array inside the iteration — the hook the distribution layer
    uses to shard the edge state over a mesh axis
    (parallel.edge_sharded_decoder); semantics are unchanged.
    """
    dtype = jnp.dtype(dtype)
    big = jnp.finfo(dtype).max
    adaptive = algorithm.is_adaptive
    exact = dtype == jnp.float64  # reference-parity accumulation order
    constrain = edge_constraint if edge_constraint is not None else (lambda x: x)

    bit_order = jnp.asarray(layout.bit_order)
    bit_inv = jnp.asarray(layout.bit_inv)
    check_order = jnp.asarray(layout.check_order)
    check_edge_bit = jnp.asarray(layout.check_edge_bit)
    to_bit_major = jnp.asarray(layout.to_bit_major)
    to_check_major = jnp.asarray(layout.to_check_major)
    check_groups = layout.check_groups
    bit_groups = layout.bit_groups

    if algorithm == DecodingAlgorithm.SPA:
        tanh_fn, atanh_fn = jnp.tanh, jnp.arctanh
    else:
        tanh_fn, atanh_fn = tanh_lin_approx, atanh_lin_approx

    def clamp(x, threshold):
        if use_threshold:
            return jnp.clip(x, -threshold, threshold)
        return x

    def decision_syndrome(decision_int: jax.Array) -> jax.Array:
        """[N, B] int8 internal -> [M, B] int8 internal."""
        edges = jnp.take(decision_int, check_edge_bit, axis=0)
        parts = []
        for g, grp in _group_views(edges, check_groups):
            parts.append(jnp.sum(grp, axis=1, dtype=jnp.int32) & 1)
        return _concat_groups(parts).astype(jnp.int8)

    def spa_check_pass(mbc, syn_sign, primary, secondary, dsyn_factor_unused):
        parts = []
        for g, msgs in _group_views(mbc, check_groups):
            ss = jax.lax.dynamic_slice_in_dim(syn_sign, g.node_start, g.count, axis=0)
            t = tanh_fn(msgs * jnp.asarray(0.5, dtype))
            row_prod = _prod_terms(ss, t, exact)
            ratio = row_prod[:, None, :] / t
            if algorithm == DecodingAlgorithm.SPA and not exact:
                # True-SPA fast modes need the atanh domain guard (SPA-LIN's
                # piecewise atanh is finite everywhere; f64 stays reference-
                # exact). See linapprox.guard_atanh_ratio.
                ratio = guard_atanh_ratio(ratio, dtype)
            e = 2.0 * atanh_fn(ratio)
            parts.append(e.reshape(-1, e.shape[-1]).astype(dtype))
        return _concat_groups(parts)

    def minsum_check_pass(mbc, syn_sign, primary, secondary, factor):
        """factor: None for NMSA/OMSA (use `primary`), or [M, B] per-check
        adaptive factor for ANMSA/AOMSA."""
        parts = []
        for g, msgs in _group_views(mbc, check_groups):
            ss = jax.lax.dynamic_slice_in_dim(syn_sign, g.node_start, g.count, axis=0)
            row_sign, excl_sign, eabs = _minsum_check_stats(msgs, ss, big)
            if factor is None:
                f_bc = primary  # scalar broadcast
            else:
                f_bc = jax.lax.dynamic_slice_in_dim(
                    factor, g.node_start, g.count, axis=0
                )[:, None, :]
            if algorithm in (DecodingAlgorithm.NMSA, DecodingAlgorithm.ANMSA):
                e = f_bc * row_sign[:, None, :] * excl_sign * eabs
            else:  # OMSA / AOMSA: offset and clamp at zero
                diff = eabs - f_bc
                e = row_sign[:, None, :] * excl_sign * jnp.maximum(diff, 0.0)
            parts.append(e.reshape(-1, e.shape[-1]).astype(dtype))
        return _concat_groups(parts)

    check_pass = (
        spa_check_pass
        if algorithm in (DecodingAlgorithm.SPA, DecodingAlgorithm.SPA_APPROX)
        else minsum_check_pass
    )

    def bit_pass(ecb_cm, llr_int, threshold):
        """Returns (total [N,B], decision [N,B] int8, new mbc [E,B])."""
        ecb_bm = jnp.take(ecb_cm, to_bit_major, axis=0)
        totals = []
        new_parts = []
        for g, e in _group_views(ecb_bm, bit_groups):
            llr_g = jax.lax.dynamic_slice_in_dim(
                llr_int, g.node_start, g.count, axis=0
            )
            total_g = _sum_terms(llr_g, e, exact)
            totals.append(total_g)
            new_parts.append((total_g[:, None, :] - e).reshape(-1, e.shape[-1]))
        total = _concat_groups(totals)
        decision = (total <= 0).astype(jnp.int8)
        mb_bm = clamp(_concat_groups(new_parts), threshold)
        mbc = jnp.take(mb_bm, to_check_major, axis=0)
        return total, decision, mbc

    def decode(
        llr_ext: jax.Array,
        syndrome_ext: jax.Array,
        primary=1.0,
        secondary=1.0,
        threshold=0.0,
    ) -> DecodeResult:
        batch = llr_ext.shape[0]
        # External [B, *] -> internal batch-minor [*, B].
        llr_int = jnp.take(llr_ext.astype(dtype), bit_order, axis=1).T
        syndrome_int = jnp.take(syndrome_ext.astype(jnp.int8), check_order, axis=1).T
        syn_sign = jnp.where(syndrome_int == 1, -1.0, 1.0).astype(dtype)
        primary = jnp.asarray(primary, dtype)
        secondary = jnp.asarray(secondary, dtype)
        threshold = jnp.asarray(threshold, dtype)

        # Initial bit->check messages: the channel LLR of the edge's bit
        # (reference: src/qkd_ldpc_algorithm.cpp:21-29).
        mbc0 = constrain(jnp.take(llr_int, check_edge_bit, axis=0))

        decision0 = (llr_int <= 0).astype(jnp.int8)  # used by adaptive init
        converged0 = jnp.zeros((batch,), bool)
        iters0 = jnp.full((batch,), max_iterations, jnp.int32)
        frozen0 = decision0

        def cond(state):
            it, mbc, decision, converged, iters, frozen = state
            return (it < max_iterations) & ~jnp.all(converged)

        if not adaptive:

            def body(state):
                it, mbc, decision, converged, iters, frozen = state
                ecb = constrain(check_pass(mbc, syn_sign, primary, secondary, None))
                ecb = clamp(ecb, threshold)
                total, new_decision, new_mbc = bit_pass(ecb, llr_int, threshold)
                new_mbc = constrain(new_mbc)
                dsyn = decision_syndrome(new_decision)
                ok = jnp.all(dsyn == syndrome_int, axis=0)
                newly = ok & ~converged
                iters = jnp.where(newly, it + 1, iters)
                frozen = jnp.where(newly[None, :], new_decision, frozen)
                converged = converged | ok
                return (it + 1, new_mbc, new_decision, converged, iters, frozen)

        else:

            def body(state):
                it, mbc, decision, converged, iters, frozen = state
                # Convergence is detected inside the check pass from the
                # *previous* decision (reference: :745-776), and that same
                # per-check syndrome drives the adaptive factor.
                dsyn = decision_syndrome(decision)
                ok = jnp.all(dsyn == syndrome_int, axis=0)
                newly = ok & ~converged
                iters = jnp.where(newly, it + 1, iters)
                frozen = jnp.where(newly[None, :], decision, frozen)
                converged = converged | ok
                mismatch = dsyn != syndrome_int
                factor = jnp.where(mismatch, secondary, primary).astype(dtype)
                ecb = constrain(check_pass(mbc, syn_sign, primary, secondary, factor))
                ecb = clamp(ecb, threshold)
                total, new_decision, new_mbc = bit_pass(ecb, llr_int, threshold)
                return (it + 1, constrain(new_mbc), new_decision, converged, iters, frozen)

        state = (jnp.int32(0), mbc0, decision0, converged0, iters0, frozen0)
        it, mbc, decision, converged, iters, frozen = jax.lax.while_loop(
            cond, body, state
        )

        final_decision = jnp.where(converged[None, :], frozen, decision)
        decision_ext = jnp.take(final_decision.T, bit_inv, axis=1)
        return DecodeResult(
            decision=decision_ext, syndromes_match=converged, iterations=iters
        )

    return decode


_DECODER_CACHE: dict = {}


def get_decoder(
    layout: EdgeLayout,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
    dtype=jnp.float32,
    jit: bool = True,
) -> Callable[..., DecodeResult]:
    """Memoized, jitted decoder builder."""
    key = (id(layout), algorithm, max_iterations, use_threshold, jnp.dtype(dtype).name, jit)
    entry = _DECODER_CACHE.get(key)
    if entry is not None and entry[0] is layout:
        # layout held strongly -> id() stable while cached
        return entry[1]
    fn = make_decoder(layout, algorithm, max_iterations, use_threshold, dtype)
    if jit:
        fn = jax.jit(fn)
    _DECODER_CACHE[key] = (layout, fn)
    return fn
