"""Batched decoders specialized for QC-LDPC codes (see models/qc.py).

Same algorithms and semantics as ops/decoders.py (the six reference
algorithms, src/qkd_ldpc_algorithm.cpp:3-1029), but the message tensor is
``[BE, Z, B]`` — one ``[Z, B]`` plane per *block edge* of the base graph.
The check-major <-> bit-major regroup that costs an arbitrary row gather for
random codes becomes, per block edge, a static cyclic roll of its plane
along Z plus a static reordering of the (tiny) block-edge axis. XLA executes
a static roll as two contiguous slices at full HBM bandwidth; the block-axis
reorder moves whole 2 MB planes. No element gathers anywhere in the
iteration.

Message plane convention: ``M[be, z, :]`` is the message on the edge between
check ``(r, z)`` and bit ``(c, (z + s) mod Z)`` for block edge ``be =
(r, c, s)``. Check-side ops therefore read planes directly; bit-side ops
read ``roll(M[be], -s)`` so index j aligns with bit ``(c, j)``:
``roll(M[be], -s)[j] = M[be, (j + s) mod Z]`` — wait, bit j corresponds to
z = (j - s) mod Z, i.e. ``roll(M[be], s)[j] = M[be, (j - s) mod Z]``. Rolls
by +s map check-aligned planes to bit-aligned planes and rolls by -s map
back.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from qkd_ldpc_v_tpu.config import DecodingAlgorithm
from qkd_ldpc_v_tpu.models.qc import QCMatrix
from qkd_ldpc_v_tpu.ops.decoders import DecodeResult
from qkd_ldpc_v_tpu.ops.linapprox import (
    atanh_lin_approx,
    guard_atanh_ratio,
    tanh_lin_approx,
)
from qkd_ldpc_v_tpu.utils import PlanCache


class _QCPlan:
    """Static host-side plan: degree-grouped base rows/columns and the
    block-edge bookkeeping for one QCMatrix."""

    def __init__(self, qc: QCMatrix):
        self.z = qc.lifting
        self.nb = qc.base_bits
        self.mb = qc.base_checks
        shifts = qc.shifts

        row_edges: List[List[Tuple[int, int]]] = [[] for _ in range(self.mb)]
        col_edges: List[List[Tuple[int, int]]] = [[] for _ in range(self.nb)]
        for r in range(self.mb):
            for c in range(self.nb):
                s = int(shifts[r, c])
                if s >= 0:
                    row_edges[r].append((c, s))
                    col_edges[c].append((r, s))

        # Base rows stably sorted by degree; edge storage order follows.
        row_deg = np.array([len(e) for e in row_edges])
        self.row_order = np.argsort(row_deg, kind="stable")
        # edge id (storage position on the BE axis) per (r, c)
        eid = {}
        self.edge_shift: List[int] = []
        self.edge_col: List[int] = []
        self.check_groups: List[Tuple[int, int, int, int]] = []  # (row_start, count, degree, edge_offset)
        off = 0
        start = 0
        pos = 0
        while pos < self.mb:
            d = int(row_deg[self.row_order[pos]])
            end = pos
            while end < self.mb and int(row_deg[self.row_order[end]]) == d:
                end += 1
            self.check_groups.append((pos, end - pos, d, off))
            for p in range(pos, end):
                r = int(self.row_order[p])
                for c, s in row_edges[r]:
                    eid[(r, c)] = off
                    self.edge_shift.append(s)
                    self.edge_col.append(c)
                    off += 1
            pos = end
        self.num_block_edges = off

        col_deg = np.array([len(e) for e in col_edges])
        self.col_order = np.argsort(col_deg, kind="stable")
        # bit groups: (col_start, count, degree); per group the [count, d]
        # tables of edge ids and shifts.
        self.bit_groups: List[Tuple[int, int, int, np.ndarray, np.ndarray]] = []
        pos = 0
        while pos < self.nb:
            d = int(col_deg[self.col_order[pos]])
            end = pos
            while end < self.nb and int(col_deg[self.col_order[end]]) == d:
                end += 1
            ids = np.zeros((end - pos, d), dtype=np.int64)
            shf = np.zeros((end - pos, d), dtype=np.int64)
            for i, q in enumerate(range(pos, end)):
                c = int(self.col_order[q])
                for k, (r, s) in enumerate(col_edges[c]):
                    ids[i, k] = eid[(r, c)]
                    shf[i, k] = s
            self.bit_groups.append((pos, end - pos, d, ids, shf))
            pos = end

        self.col_inv = np.empty(self.nb, dtype=np.int64)
        self.col_inv[self.col_order] = np.arange(self.nb)
        self.row_inv = np.empty(self.mb, dtype=np.int64)
        self.row_inv[self.row_order] = np.arange(self.mb)


_PLAN_CACHE = PlanCache()


def plan_for(qc: QCMatrix) -> _QCPlan:
    plan = _PLAN_CACHE.get(qc)
    if plan is None:
        plan = _QCPlan(qc)
        _PLAN_CACHE.put(qc, plan)
    return plan


def make_qc_decoder(
    qc: QCMatrix,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
    dtype=jnp.float32,
    schedule: str = "flooding",
) -> Callable[..., DecodeResult]:
    """Build a jittable batched QC decoder.

    External API matches ops/decoders.make_decoder: ``decode(llr_ext [B,N],
    syndrome_ext [B,M] int8, primary, secondary, threshold)`` with external
    index order bit = c*Z + j, check = r*Z + i.

    ``schedule="flooding"`` is the reference's schedule; ``"layered"`` is the
    serial-C sweep of ``_make_layered_decoder`` (min-sum family only).
    """
    if schedule == "layered":
        return _make_layered_decoder(
            qc, algorithm, max_iterations, use_threshold, dtype
        )
    if schedule != "flooding":
        raise ValueError(f"unknown schedule {schedule!r}")
    plan = plan_for(qc)
    z, nb, mb = plan.z, plan.nb, plan.mb
    dtype = jnp.dtype(dtype)
    big = jnp.finfo(dtype).max
    adaptive = algorithm.is_adaptive

    if algorithm == DecodingAlgorithm.SPA:
        tanh_fn, atanh_fn = jnp.tanh, jnp.arctanh
    else:
        tanh_fn, atanh_fn = tanh_lin_approx, atanh_lin_approx

    minsum = algorithm not in (DecodingAlgorithm.SPA, DecodingAlgorithm.SPA_APPROX)

    edge_shift = plan.edge_shift
    edge_col = plan.edge_col
    col_order = [int(c) for c in plan.col_order]
    col_inv = [int(c) for c in plan.col_inv]
    row_order = [int(r) for r in plan.row_order]

    def clamp(x, threshold):
        if use_threshold:
            return jnp.clip(x, -threshold, threshold)
        return x

    def to_bit_aligned(m):
        """[BE, Z, B] check-aligned -> bit-aligned (roll each plane by +s)."""
        return jnp.stack(
            [jnp.roll(m[e], edge_shift[e], axis=0) for e in range(plan.num_block_edges)]
        )

    def check_pass(m, syn_sign, primary, secondary, factor):
        """m [BE, Z, B] check-aligned -> extrinsics e [BE, Z, B]."""
        parts = []
        for (row_start, count, d, edge_offset) in plan.check_groups:
            msgs = jax.lax.dynamic_slice_in_dim(
                m, edge_offset, count * d, axis=0
            ).reshape(count, d, z, -1)
            ss = jax.lax.dynamic_slice_in_dim(syn_sign, row_start, count, axis=0)
            if not minsum:
                t = tanh_fn(msgs * jnp.asarray(0.5, dtype))
                row_prod = ss * jnp.prod(t, axis=1)
                ratio = row_prod[:, None] / t
                if algorithm == DecodingAlgorithm.SPA and dtype != jnp.float64:
                    ratio = guard_atanh_ratio(ratio, dtype)
                e = 2.0 * atanh_fn(ratio)
            else:
                a = jnp.abs(msgs)
                min1 = jnp.min(a, axis=1)
                is_min = a == min1[:, None]
                count_min = jnp.sum(is_min, axis=1)
                min2 = jnp.where(
                    count_min >= 2, min1, jnp.min(jnp.where(is_min, big, a), axis=1)
                )
                neg = jnp.sum(msgs < 0, axis=1)
                row_sign = ss * jnp.where(neg % 2 == 0, 1.0, -1.0).astype(dtype)
                excl_sign = jnp.where(msgs > 0, 1.0, -1.0).astype(dtype)
                eabs = jnp.where(is_min, min2[:, None], min1[:, None])
                if factor is None:
                    f_bc = primary
                else:
                    f_bc = jax.lax.dynamic_slice_in_dim(
                        factor, row_start, count, axis=0
                    )[:, None]
                if algorithm in (DecodingAlgorithm.NMSA, DecodingAlgorithm.ANMSA):
                    e = f_bc * row_sign[:, None] * excl_sign * eabs
                else:
                    e = row_sign[:, None] * excl_sign * jnp.maximum(eabs - f_bc, 0.0)
            parts.append(e.reshape(count * d, z, -1).astype(dtype))
        return jnp.concatenate(parts, axis=0)

    def bit_pass(e_cm, llr_blocks, threshold):
        """e_cm [BE, Z, B] check-aligned extrinsics.

        Returns (total [nb, Z, B] in external column order, decision int8,
        new check-aligned messages [BE, Z, B])."""
        e_bit = to_bit_aligned(e_cm)
        batch = e_cm.shape[-1]
        total_by_col = [None] * nb
        new_planes = [None] * plan.num_block_edges
        for (col_start, count, d, ids, shf) in plan.bit_groups:
            sel = e_bit[jnp.asarray(ids.reshape(-1))].reshape(count, d, z, batch)
            cols = [col_order[col_start + i] for i in range(count)]
            llr_g = jnp.stack([llr_blocks[c] for c in cols])
            # Sequential llr-first accumulation — the association every
            # engine shares (see ops/decoders._sum_terms, round 5).
            total_g = llr_g
            for s in range(d):
                total_g = total_g + sel[:, s]
            new_g = clamp(total_g[:, None] - sel, threshold)
            for i in range(count):
                total_by_col[cols[i]] = total_g[i]
                for k in range(d):
                    # roll back to check alignment
                    new_planes[int(ids[i, k])] = jnp.roll(
                        new_g[i, k], -int(shf[i, k]), axis=0
                    )
        total = jnp.stack(total_by_col)  # [nb, Z, B] external col order
        decision = (total <= 0).astype(jnp.int8)
        mbc = jnp.stack(new_planes)
        return total, decision, mbc

    def decision_syndrome(decision):
        """decision [nb, Z, B] int8 external col order -> [mb, Z, B] int8 in
        internal row order."""
        acc_rows = []
        for (row_start, count, d, edge_offset) in plan.check_groups:
            accs = []
            for p in range(row_start, row_start + count):
                acc = None
                for k in range(d):
                    e = edge_offset + (p - row_start) * d + k
                    c = edge_col[e]
                    s = edge_shift[e]
                    contrib = jnp.roll(decision[c], -s, axis=0)
                    acc = contrib if acc is None else acc ^ contrib
                accs.append(acc)
            acc_rows.append(jnp.stack(accs))
        return jnp.concatenate(acc_rows, axis=0)

    def decode(
        llr_ext: jax.Array,
        syndrome_ext: jax.Array,
        primary=1.0,
        secondary=1.0,
        threshold=0.0,
    ) -> DecodeResult:
        batch = llr_ext.shape[0]
        llr_blocks = jnp.moveaxis(
            llr_ext.astype(dtype).reshape(batch, nb, z), 0, -1
        )  # [nb, Z, B] external col order
        syn_blocks = jnp.moveaxis(
            syndrome_ext.astype(jnp.int8).reshape(batch, mb, z), 0, -1
        )
        syn_int = jnp.stack([syn_blocks[r] for r in row_order])  # internal row order
        syn_sign = jnp.where(syn_int == 1, -1.0, 1.0).astype(dtype)
        primary = jnp.asarray(primary, dtype)
        secondary = jnp.asarray(secondary, dtype)
        threshold = jnp.asarray(threshold, dtype)

        # Initial bit->check messages: channel LLR of the edge's bit, rolled
        # into check alignment (reference: src/qkd_ldpc_algorithm.cpp:21-29).
        mbc0 = jnp.stack(
            [
                jnp.roll(llr_blocks[edge_col[e]], -edge_shift[e], axis=0)
                for e in range(plan.num_block_edges)
            ]
        )

        decision0 = (llr_blocks <= 0).astype(jnp.int8)
        converged0 = jnp.zeros((batch,), bool)
        iters0 = jnp.full((batch,), max_iterations, jnp.int32)

        def conv_check(decision):
            dsyn = decision_syndrome(decision)
            return jnp.all((dsyn == syn_int).reshape(-1, batch), axis=0), dsyn

        def cond(state):
            it, mbc, decision, converged, iters, frozen = state
            return (it < max_iterations) & ~jnp.all(converged)

        if not adaptive:

            def body(state):
                it, mbc, decision, converged, iters, frozen = state
                e = clamp(
                    check_pass(mbc, syn_sign, primary, secondary, None), threshold
                )
                total, new_decision, new_mbc = bit_pass(e, llr_blocks, threshold)
                ok, _ = conv_check(new_decision)
                newly = ok & ~converged
                iters = jnp.where(newly, it + 1, iters)
                frozen = jnp.where(newly[None, None, :], new_decision, frozen)
                converged = converged | ok
                return (it + 1, new_mbc, new_decision, converged, iters, frozen)

        else:

            def body(state):
                it, mbc, decision, converged, iters, frozen = state
                ok, dsyn = conv_check(decision)
                newly = ok & ~converged
                iters = jnp.where(newly, it + 1, iters)
                frozen = jnp.where(newly[None, None, :], decision, frozen)
                converged = converged | ok
                factor = jnp.where(dsyn != syn_int, secondary, primary).astype(dtype)
                e = clamp(
                    check_pass(mbc, syn_sign, primary, secondary, factor), threshold
                )
                total, new_decision, new_mbc = bit_pass(e, llr_blocks, threshold)
                return (it + 1, new_mbc, new_decision, converged, iters, frozen)

        state = (jnp.int32(0), mbc0, decision0, converged0, iters0, decision0)
        it, mbc, decision, converged, iters, frozen = jax.lax.while_loop(
            cond, body, state
        )

        final = jnp.where(converged[None, None, :], frozen, decision)
        decision_ext = jnp.moveaxis(final, -1, 0).reshape(batch, nb * z)
        return DecodeResult(
            decision=decision_ext, syndromes_match=converged, iterations=iters
        )

    return decode


def _layered_tables(qc: QCMatrix):
    """Base rows in natural order, each padded to the largest row degree:
    ``(cols [mb, d], shifts [mb, d], valid [mb, d])``, edges within a row
    in ascending column order."""
    present = qc.shifts >= 0
    degree = present.sum(axis=1)
    if (degree == 0).any():
        raise ValueError("every base row needs at least one block edge")
    d = int(degree.max())
    cols = np.zeros((qc.base_checks, d), np.int64)
    shifts = np.zeros((qc.base_checks, d), np.int64)
    valid = np.zeros((qc.base_checks, d), bool)
    for r in range(qc.base_checks):
        cs = np.flatnonzero(present[r])
        cols[r, : len(cs)] = cs
        shifts[r, : len(cs)] = qc.shifts[r, cs] % qc.lifting
        valid[r, : len(cs)] = True
    return cols, shifts, valid


def _make_layered_decoder(
    qc: QCMatrix,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
    dtype,
) -> Callable[..., DecodeResult]:
    """Layered (serial-C) min-sum decoder, a performance mode beyond the
    reference's flooding schedule.

    Each sweep visits the base rows in natural order (one ``fori_loop``
    step per row). A row reads the *current* bit totals rolled into check
    alignment, runs the min-sum check update, and adds the change of its
    check->bit messages back into the totals at once, so information
    propagates within a sweep and frames converge in about half the sweeps
    of flooding. The adaptive pair takes its per-check factor from the
    decisions of the rolled totals the row reads. Convergence is checked
    after every sweep; converged frames freeze their decision.

    A base row holds each block column at most once, so every bit total is
    updated at most once per row and the vectorised row update is exactly
    the sequential one. The specification is ``oracle.layered_oracle``.
    """
    if algorithm in (DecodingAlgorithm.SPA, DecodingAlgorithm.SPA_APPROX):
        raise ValueError("layered schedule supports the min-sum family "
                         "(NMSA/OMSA/ANMSA/AOMSA) only")
    z, nb, mb = qc.lifting, qc.base_bits, qc.base_checks
    n = nb * z
    dtype = jnp.dtype(dtype)
    big = jnp.finfo(dtype).max
    adaptive = algorithm.is_adaptive
    normalized = algorithm in (DecodingAlgorithm.NMSA, DecodingAlgorithm.ANMSA)

    cols, shifts, valid = _layered_tables(qc)
    d = cols.shape[1]
    j = np.arange(z)
    # Row gather: rolled[k, j] = total[c_k * Z + (j + s_k) mod Z].
    gather_idx = cols[:, :, None] * z + (j + shifts[:, :, None]) % z
    # Padding slots scatter out of bounds (dropped), each to its own index.
    pad_idx = n + np.arange(d * z).reshape(d, z)
    scatter_idx = np.where(valid[:, :, None], gather_idx, pad_idx)
    # Syndrome gather over decisions with one zero row appended at index n.
    syn_idx = np.where(valid[:, :, None], gather_idx, n)
    gather_idx = jnp.asarray(gather_idx.reshape(mb, d * z), jnp.int32)
    scatter_idx = jnp.asarray(scatter_idx.reshape(mb, d * z), jnp.int32)
    syn_idx = jnp.asarray(syn_idx.reshape(-1), jnp.int32)
    valid = jnp.asarray(valid)

    def clamp(x, threshold):
        if use_threshold:
            return jnp.clip(x, -threshold, threshold)
        return x

    def decode(
        llr_ext: jax.Array,
        syndrome_ext: jax.Array,
        primary=1.0,
        secondary=1.0,
        threshold=0.0,
    ) -> DecodeResult:
        batch = llr_ext.shape[0]
        total0 = llr_ext.astype(dtype).T  # [N, B], bit c*Z + j
        syn = syndrome_ext.astype(jnp.int8).T.reshape(mb, z, batch)
        syn_neg = syn == 1
        syn_sign = jnp.where(syn_neg, -1.0, 1.0).astype(dtype)
        primary = jnp.asarray(primary, dtype)
        secondary = jnp.asarray(secondary, dtype)
        threshold = jnp.asarray(threshold, dtype)

        def row_update(r, carry):
            total, c2b = carry
            rolled = total.at[gather_idx[r]].get(
                mode="promise_in_bounds", unique_indices=True
            ).reshape(d, z, batch)
            old = c2b[r]
            msgs = rolled - old
            v = valid[r]
            a = jnp.abs(msgs)
            # Pairwise two-minimum chain in edge order (ties give
            # min2 == min1); padding slots leave the chain untouched.
            min1 = a[0]
            min2 = jnp.full_like(min1, big)
            neg = (msgs[0] < 0).astype(jnp.int32)
            for k in range(1, d):
                min2 = jnp.where(
                    v[k], jnp.minimum(min2, jnp.maximum(min1, a[k])), min2
                )
                min1 = jnp.where(v[k], jnp.minimum(min1, a[k]), min1)
                neg = neg + (v[k] & (msgs[k] < 0)).astype(jnp.int32)
            row_sign = syn_sign[r] * jnp.where(
                neg % 2 == 0, 1.0, -1.0
            ).astype(dtype)
            if adaptive:
                mism = syn_neg[r]
                for k in range(d):
                    mism = mism ^ (v[k] & (rolled[k] <= 0))
                f = jnp.where(mism, secondary, primary).astype(dtype)
            else:
                f = primary
            excl = jnp.where(msgs > 0, 1.0, -1.0).astype(dtype)
            eabs = jnp.where(a == min1, min2, min1)
            if normalized:
                val = f * row_sign * excl * eabs
            else:  # OMSA / AOMSA: offset, clamp at zero
                val = row_sign * excl * jnp.maximum(eabs - f, 0.0)
            val = clamp(val.astype(dtype), threshold)
            total = total.at[scatter_idx[r]].set(
                (rolled + (val - old)).reshape(d * z, batch),
                mode="drop", unique_indices=True,
            )
            return total, c2b.at[r].set(val)

        def check(total):
            dec = (total <= 0).astype(jnp.int8)
            padded = jnp.concatenate([dec, jnp.zeros((1, batch), jnp.int8)])
            edges = padded.at[syn_idx].get(mode="promise_in_bounds")
            dsyn = jnp.sum(
                edges.reshape(mb, d, z, batch), axis=1, dtype=jnp.int32
            ) & 1
            ok = jnp.all((dsyn == syn).reshape(-1, batch), axis=0)
            return dec, ok

        def cond(state):
            it, total, c2b, converged, iters, frozen = state
            return (it < max_iterations) & ~jnp.all(converged)

        def body(state):
            it, total, c2b, converged, iters, frozen = state
            total, c2b = jax.lax.fori_loop(0, mb, row_update, (total, c2b))
            dec, ok = check(total)
            newly = ok & ~converged
            iters = jnp.where(newly, it + 1, iters)
            frozen = jnp.where(newly[None, :], dec, frozen)
            return (it + 1, total, c2b, converged | ok, iters, frozen)

        state = (
            jnp.int32(0),
            total0,
            jnp.zeros((mb, d, z, batch), dtype),
            jnp.zeros((batch,), bool),
            jnp.full((batch,), max_iterations, jnp.int32),
            (total0 <= 0).astype(jnp.int8),
        )
        it, total, c2b, converged, iters, frozen = jax.lax.while_loop(
            cond, body, state
        )
        final = jnp.where(converged[None, :], frozen, (total <= 0).astype(jnp.int8))
        return DecodeResult(
            decision=final.T, syndromes_match=converged, iterations=iters
        )

    return decode
