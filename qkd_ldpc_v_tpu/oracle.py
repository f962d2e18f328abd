"""NumPy f64 oracle: per-frame, sequential decoders with the reference's
exact control flow and numeric semantics.

This is the ground truth for the batched JAX decoders (tests) and the
backing engine of the tracing subsystem (tracing.py) and of users'
verification mode. It mirrors the C++ decoders' per-frame logic (reference:
src/qkd_ldpc_algorithm.cpp:3-1029) directly on the adjacency-list HMatrix:
jagged message arrays, sequential two-minimum tracking, syndrome-folded
signs, early exit, and the clamp points. Deliberately slow and simple.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

DBL_MAX = np.finfo(np.float64).max


def _tanh_lin_approx(x: float) -> float:
    ax = abs(x)
    if ax < 0.5:
        r = 0.9242 * ax
    elif ax < 0.9:
        r = 0.6355 * ax + 0.1444
    elif ax < 1.2:
        r = 0.3912 * ax + 0.3642
    elif ax < 1.75:
        r = 0.1958 * ax + 0.5986
    elif ax < 2.5:
        r = 0.0603 * ax + 0.8358
    elif ax < 3.5:
        r = 0.0115 * ax + 0.9577
    elif ax < 8:
        r = 0.0004 * ax + 0.9967
    else:
        r = 1.0
    return -r if x < 0 else r


def _atanh_lin_approx(x: float) -> float:
    ax = abs(x)
    if ax < 0.7:
        r = 1.196 * ax - 0.0323
    elif ax < 0.9:
        r = 2.9187 * ax - 1.214
    elif ax < 0.999:
        r = 10.8717 * ax - 8.3717
    else:
        r = 2510.9 * ax - 2505.9
    return -r if x < 0 else r


def _clamp_jagged(msgs: List[np.ndarray], threshold: float) -> None:
    for row in msgs:
        np.clip(row, -threshold, threshold, out=row)


def calculate_syndrome(check_nodes, bits) -> np.ndarray:
    syn = np.zeros(len(check_nodes), dtype=np.int64)
    for j, row in enumerate(check_nodes):
        for b in row:
            syn[j] ^= int(bits[b])
    return syn


@dataclass
class TraceIteration:
    """Per-iteration intermediates, mirroring the reference's decoder trace
    dump (reference: src/qkd_ldpc_algorithm.cpp:88-99 — E, L, z, s tensors
    per iteration, plus the max-|LLR| watermark of :130-135)."""

    iteration: int
    check_to_bit: List[np.ndarray] = field(default_factory=list)  # E (jagged)
    total_llr: Optional[np.ndarray] = None  # L
    decision: Optional[np.ndarray] = None  # z
    decision_syndrome: Optional[np.ndarray] = None  # s
    max_abs_msg_llr: float = 0.0
    max_abs_total_llr: float = 0.0


def decode_oracle(
    matrix,
    llr: np.ndarray,
    syndrome: np.ndarray,
    algorithm: int,
    max_iterations: int,
    primary: float = 1.0,
    secondary: float = 1.0,
    threshold: float = 0.0,
    use_threshold: bool = False,
    trace: Optional[List[TraceIteration]] = None,
) -> Tuple[np.ndarray, bool, int]:
    """Decode one frame. Returns (decision, syndromes_match, iterations).

    `matrix` is an HMatrix (ascending adjacency). `algorithm` follows the
    DecodingAlgorithm enum (0..5). When ``trace`` is a list, a
    TraceIteration is appended per iteration.
    """
    bit_nodes = matrix.bit_nodes
    check_nodes = matrix.check_nodes
    n = len(bit_nodes)
    m = len(check_nodes)
    llr = np.asarray(llr, dtype=np.float64)

    # bit_to_check[j][k]: message into check j from its k-th bit (ascending).
    b2c = [llr[row].astype(np.float64).copy() for row in check_nodes]
    # check_to_bit[i][k]: message into bit i from its k-th check (ascending).
    c2b = [np.zeros(len(row), dtype=np.float64) for row in bit_nodes]

    decision = np.zeros(n, dtype=np.int64)
    adaptive = algorithm in (4, 5)
    if adaptive:
        decision = (llr <= 0).astype(np.int64)

    # Slot cursors exactly as the reference's running indices: because
    # adjacency is ascending, check j is bit i's `searchsorted` slot etc.
    c2b_slot = [
        {int(j): k for k, j in enumerate(row)} for row in bit_nodes
    ]  # bit i: check j -> slot
    b2c_slot = [
        {int(i): k for k, i in enumerate(row)} for row in check_nodes
    ]  # check j: bit i -> slot

    for it in range(max_iterations):
        if adaptive:
            syndromes_equal = True
        # ---- check pass ----
        for j in range(m):
            row = check_nodes[j]
            msgs = b2c[j]
            if algorithm in (0, 1):  # SPA variants
                t = np.empty(len(msgs))
                for k in range(len(msgs)):
                    t[k] = (
                        math.tanh(msgs[k] / 2.0)
                        if algorithm == 0
                        else _tanh_lin_approx(msgs[k] / 2.0)
                    )
                row_prod = -1.0 if syndrome[j] else 1.0
                for k in range(len(t)):
                    row_prod *= t[k]
                b2c[j] = t  # reference overwrites in place (:60)
                for k, i in enumerate(row):
                    prod = row_prod / t[k]
                    val = 2.0 * (
                        math.atanh(prod) if algorithm == 0 else _atanh_lin_approx(prod)
                    )
                    c2b[i][c2b_slot[i][j]] = val
            else:  # min-sum family
                sign_prod = -1.0 if syndrome[j] else 1.0
                neg = 0
                min1 = DBL_MAX
                min2 = DBL_MAX
                for k in range(len(msgs)):
                    if msgs[k] < 0:
                        neg += 1
                    cur = abs(msgs[k])
                    if cur < min1:
                        min2 = min1
                        min1 = cur
                    elif cur < min2:
                        min2 = cur
                sign_prod *= 1.0 if neg % 2 == 0 else -1.0

                if adaptive:
                    dsyn_j = 0
                    for i in row:
                        dsyn_j ^= int(decision[i])
                    if dsyn_j != syndrome[j]:
                        factor = secondary
                        syndromes_equal = False
                    else:
                        factor = primary
                else:
                    factor = primary

                for k, i in enumerate(row):
                    prod = sign_prod * (1.0 if msgs[k] > 0 else -1.0)
                    eabs = min2 if abs(msgs[k]) == min1 else min1
                    if algorithm in (2, 4):  # normalized
                        val = factor * prod * eabs
                    else:  # offset
                        diff = eabs - factor
                        val = prod * (0.0 if diff < 0.0 else diff)
                    c2b[i][c2b_slot[i][j]] = val

        if adaptive and syndromes_equal:
            if trace is not None:
                trace.append(
                    TraceIteration(
                        iteration=it + 1,
                        decision=decision.copy(),
                        decision_syndrome=np.asarray(syndrome).copy(),
                    )
                )
            return decision.copy(), True, it + 1

        if use_threshold:
            _clamp_jagged(c2b, threshold)

        # ---- bit pass part 1: totals + hard decision ----
        total = np.empty(n, dtype=np.float64)
        for i in range(n):
            s = llr[i]
            for v in c2b[i]:
                s += v
            total[i] = s
            decision[i] = 1 if s <= 0 else 0

        dsyn = calculate_syndrome(check_nodes, decision)
        if trace is not None:
            trace.append(
                TraceIteration(
                    iteration=it + 1,
                    check_to_bit=[row.copy() for row in c2b],
                    total_llr=total.copy(),
                    decision=decision.copy(),
                    decision_syndrome=dsyn.copy(),
                    max_abs_msg_llr=float(
                        max((np.abs(r).max() for r in c2b if len(r)), default=0.0)
                    ),
                    max_abs_total_llr=float(np.abs(total).max()),
                )
            )

        if not adaptive:
            if np.array_equal(dsyn, np.asarray(syndrome)):
                return decision.copy(), True, it + 1

        # ---- bit pass part 2: new bit->check messages ----
        for i in range(n):
            col_sum = total[i]
            for k, j in enumerate(bit_nodes[i]):
                b2c[j][b2c_slot[j][i]] = col_sum - c2b[i][k]

        if use_threshold:
            _clamp_jagged(b2c, threshold)

    return decision.copy(), False, max_iterations


def layered_oracle(
    qc,
    llr: np.ndarray,
    syndrome: np.ndarray,
    algorithm: int,
    primary: float,
    max_iterations: int,
    secondary: float = 1.0,
    threshold: Optional[float] = None,
) -> Tuple[np.ndarray, int, bool]:
    """Decode one frame of a QC code with the layered (serial-C) min-sum
    schedule in float32. Returns (decision, iterations, syndromes_match).

    The specification of ``ops.qc_decoder``'s layered decoder: base rows in
    natural order, edges within a row in ascending column order. Each row
    reads the current bit totals rolled into check alignment, updates its
    check->bit messages (optionally clamped to +-``threshold``) and adds
    their change back into the totals at once; the adaptive pair takes the
    per-check factor from the decisions of those rolled totals. Convergence
    is checked after each full sweep.
    """
    z, nb, mb = qc.lifting, qc.base_bits, qc.base_checks
    rows = [
        [(c, int(qc.shifts[r, c]) % z) for c in range(nb) if qc.shifts[r, c] >= 0]
        for r in range(mb)
    ]
    f32 = np.float32
    total = np.asarray(llr, f32).reshape(nb, z).copy()
    c2b = [[np.zeros(z, f32) for _ in row] for row in rows]
    synb = np.asarray(syndrome).reshape(mb, z)
    big = f32(np.finfo(f32).max)
    adaptive = algorithm in (4, 5)
    normalized = algorithm in (2, 4)
    dec = (total <= 0).astype(np.int8)
    for it in range(1, max_iterations + 1):
        for r, row in enumerate(rows):
            rolled = [np.roll(total[c], -s) for (c, s) in row]
            msgs = [rt - old for rt, old in zip(rolled, c2b[r])]
            a = [np.abs(mm) for mm in msgs]
            min1 = a[0].copy()
            min2 = np.full(z, big)
            for ai in a[1:]:
                min2 = np.minimum(min2, np.maximum(min1, ai))
                min1 = np.minimum(min1, ai)
            neg = sum((mm < 0).astype(np.int32) for mm in msgs)
            ss = np.where(synb[r] == 1, -1.0, 1.0).astype(f32)
            row_sign = ss * np.where(neg % 2 == 0, 1.0, -1.0).astype(f32)
            if adaptive:
                acc = np.zeros(z, np.int32)
                for rt in rolled:
                    acc = acc ^ (rt <= 0).astype(np.int32)
                f = np.where(acc ^ synb[r] != 0, f32(secondary),
                             f32(primary)).astype(f32)
            else:
                f = f32(primary)
            for k, ((c, s), mm, ai) in enumerate(zip(row, msgs, a)):
                excl = np.where(mm > 0, 1.0, -1.0).astype(f32)
                eabs = np.where(ai == min1, min2, min1)
                if normalized:
                    val = (f * row_sign * excl * eabs).astype(f32)
                else:
                    val = (row_sign * excl * np.maximum(eabs - f, f32(0))
                           ).astype(f32)
                if threshold is not None:
                    val = np.clip(val, -f32(threshold), f32(threshold))
                total[c] = (total[c] + np.roll(val - c2b[r][k], s)).astype(f32)
                c2b[r][k] = val
        dec = (total <= 0).astype(np.int8)
        ok = True
        for r, row in enumerate(rows):
            acc = np.zeros(z, np.int8)
            for (c, s) in row:
                acc = acc ^ np.roll(dec[c], -s)
            if not np.array_equal(acc, synb[r]):
                ok = False
        if ok:
            return dec.reshape(-1), it, True
    return dec.reshape(-1), max_iterations, False
