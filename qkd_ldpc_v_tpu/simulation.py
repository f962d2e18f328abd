"""Monte-Carlo sweep driver: combination builder, batched trial execution,
statistics, and the CSV results writer.

Reference counterparts (semantics reproduced, architecture inverted):
  * ``prepare_sim_inputs``        — src/simulation.cpp:371-537 (C18)
  * ``run_trial`` fan-out         — src/simulation.cpp:540-577, 693-768 (C19/C20)
  * ``process_trials_results``    — src/simulation.cpp:580-690 (C21)
  * ``write_file``                — src/simulation.cpp:4-176 (C22)

The reference decodes one frame per CPU-thread task with a barrier per
combination. Here all trials of a combination are decoded as device-wide
*batches*; the thread pool disappears entirely. The rate-adaptation index
vectors (payload/punctured/shortened positions) are **traced device inputs**,
not compile-time constants: frame extension is expressed as a per-position
class vector plus a payload gather map, and the trial statistics
(syndromes_match / keys_match / iterations) never require the variable-length
output compaction. Consequently one XLA executable per
(matrix, algorithm, batch) serves *every* sweep combination — QBER points,
delta/f_EC grids, and scaling-factor crosses are pure data.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from qkd_ldpc_v_tpu.config import (
    Config,
    DecodingAlgorithm,
    RQBERRange,
    RAdaptationParametersRange,
    RQBERAdaptationParametersMap,
    RScalingFactorMap,
    ScalingFactorRange,
)
from qkd_ldpc_v_tpu.models.hmatrix import HMatrix, read_matrix
from qkd_ldpc_v_tpu.models.layout import layout_for
from qkd_ldpc_v_tpu.ops.channel import (
    exact_error_count,
    generate_keys,
    inject_errors,
    syndrome_internal,
    trial_keys,
)
from qkd_ldpc_v_tpu.ops.decoders import get_decoder
from qkd_ldpc_v_tpu.ops.qc_decoder import make_qc_decoder
from qkd_ldpc_v_tpu.privacy import bits_positions_to_remove
from qkd_ldpc_v_tpu.utils import PlanCache
from qkd_ldpc_v_tpu.rate_adapt import (
    ALMOST_ZERO,
    HMatrixParams,
    adapt_code_rate,
    finalize_bits_to_remove,
    get_punctured_bits_untainted,
)

logger = logging.getLogger("qkd_ldpc_v_tpu")


class SimulationError(RuntimeError):
    """Raised on unrecoverable sweep-construction or trial errors."""


# ---------------------------------------------------------------------------
# Rate-based lookups (reference: src/simulation.cpp:182-368). Convention: the
# first entry (ascending code_rate sort) whose code_rate >= matrix rate wins.
# ---------------------------------------------------------------------------


def rate_based_qber_range(
    code_rate: float, ranges: Sequence[RQBERRange]
) -> Tuple[float, ...]:
    """(reference: src/simulation.cpp:182-214)"""
    for r in ranges:
        if code_rate <= r.code_rate:
            return r.qber_values()
    raise SimulationError(
        "An error occurred while generating a QBER range based on code "
        f"rate(R). Matrix code rate, R = {code_rate}."
    )


def rate_based_adapt_parameters_ranges(
    code_rate: float, ranges: Sequence[RAdaptationParametersRange]
) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """Returns (delta values, efficiency values)
    (reference: src/simulation.cpp:220-282)."""
    deltas: Optional[Tuple[float, ...]] = None
    effs: Optional[Tuple[float, ...]] = None
    for r in ranges:
        if code_rate <= r.code_rate:
            deltas = r.delta_values()
            effs = r.efficiency_values()
            break
    if deltas is None or effs is None:
        raise SimulationError(
            "An error occurred while generating a delta range based on code "
            f"rate(R). Matrix code rate, R = {code_rate}."
        )
    return deltas, effs


def rate_based_qber_adapt_parameters_maps(
    code_rate: float, maps: Sequence[RQBERAdaptationParametersMap]
):
    """All map entries sharing the first code_rate >= matrix rate
    (reference: src/simulation.cpp:287-321)."""
    out = []
    target = None
    for m in maps:
        if target is None:
            if code_rate <= m.code_rate:
                target = m.code_rate
                out.append(m.params)
        elif m.code_rate == target:
            out.append(m.params)
        else:
            break
    if not out:
        raise SimulationError(
            "An error occurred while generating a QBER - delta - "
            "efficiency(f_EC) maps based on code rate(R). Matrix code rate, "
            f"R = {code_rate}."
        )
    return out


def rate_based_scaling_factor_value(
    code_rate: float, maps: Sequence[RScalingFactorMap]
) -> float:
    """(reference: src/simulation.cpp:348-368)"""
    for m in maps:
        if code_rate <= m.code_rate:
            return m.scaling_factor
    raise SimulationError(
        "An error occurred while searching scaling factor value based on "
        f"code rate(R). Matrix code rate, R = {code_rate}."
    )


def scaling_factor_range_values(rng: ScalingFactorRange) -> Tuple[float, ...]:
    """(reference: src/simulation.cpp:325-343)"""
    return rng.values()


# ---------------------------------------------------------------------------
# Sweep combination builder (C18)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScalingFactors:
    """(reference: src/qkd_ldpc_algorithm.hpp scaling factors pair)"""

    primary: float = 0.0
    secondary: float = 0.0


@dataclass
class SimCombination:
    """One sweep point (reference: ``sim_combination``, src/simulation.hpp:27-33)."""

    config_qber: float
    matrix_params: HMatrixParams
    scaling_factors: ScalingFactors


@dataclass
class SimInput:
    """All sweep points for one matrix (reference: ``sim_input``,
    src/simulation.hpp:22-26)."""

    matrix: HMatrix
    matrix_path: Path
    combinations: List[SimCombination] = field(default_factory=list)


def prepare_sim_inputs(
    matrix_paths: Sequence, cfg: Config
) -> List[SimInput]:
    """Build the full (matrix x QBER x adaptation x scaling-factor) sweep
    (reference: src/simulation.cpp:371-537)."""
    rng = np.random.default_rng(cfg.simulation_seed)
    sim_inputs: List[SimInput] = []
    for matrix_path in matrix_paths:
        matrix = read_matrix(matrix_path, cfg.matrix_format)
        code_rate = matrix.code_rate
        qber_mat_params: List[Tuple[float, HMatrixParams]] = []

        if cfg.enable_code_rate_adaptation:
            if cfg.enable_untainted_puncturing:
                matrix.punctured_bits_untainted = get_punctured_bits_untainted(
                    matrix_path, rng, matrix
                )
            if cfg.use_adaptation_parameters_ranges:
                deltas, effs = rate_based_adapt_parameters_ranges(
                    code_rate, cfg.r_adapt_params_ranges
                )
                qber_values = rate_based_qber_range(code_rate, cfg.r_qber_ranges)
                points = [
                    (q, d, e) for q in qber_values for d in deltas for e in effs
                ]
            else:
                maps = rate_based_qber_adapt_parameters_maps(
                    code_rate, cfg.r_qber_adapt_params_maps
                )
                points = [(p.qber, p.delta, p.efficiency) for p in maps]
            for qber, delta, efficiency in points:
                mat_params = adapt_code_rate(
                    rng, matrix, qber, delta, efficiency,
                    use_untainted=cfg.enable_untainted_puncturing,
                )
                if mat_params.is_empty:
                    continue  # skipped: unachievable (reference :414, :440)
                finalize_bits_to_remove(
                    matrix, mat_params, cfg.enable_privacy_maintenance
                )
                qber_mat_params.append((qber, mat_params))
        else:
            mat_params = HMatrixParams()
            if cfg.enable_privacy_maintenance:
                mat_params.bits_to_remove = bits_positions_to_remove(matrix)
            for qber in rate_based_qber_range(code_rate, cfg.r_qber_ranges):
                qber_mat_params.append((qber, mat_params))

        # Scaling-factor cross (reference :469-520)
        alg = cfg.decoding_algorithm
        if alg in (DecodingAlgorithm.NMSA, DecodingAlgorithm.OMSA):
            if cfg.primary.use_range:
                primaries = scaling_factor_range_values(cfg.primary.range)
            else:
                primaries = (
                    rate_based_scaling_factor_value(code_rate, cfg.primary.maps),
                )
            scaling = [ScalingFactors(primary=p) for p in primaries]
        elif alg.is_adaptive:
            if cfg.primary.use_range:
                primaries = scaling_factor_range_values(cfg.primary.range)
            else:
                primaries = (
                    rate_based_scaling_factor_value(code_rate, cfg.primary.maps),
                )
            if cfg.secondary.use_range:
                secondaries = scaling_factor_range_values(cfg.secondary.range)
            else:
                secondaries = (
                    rate_based_scaling_factor_value(code_rate, cfg.secondary.maps),
                )
            scaling = [
                ScalingFactors(primary=p, secondary=s)
                for p in primaries
                for s in secondaries
            ]
        else:
            scaling = [ScalingFactors()]

        combinations = [
            SimCombination(q, mp, sf) for (q, mp) in qber_mat_params for sf in scaling
        ]
        sim_inputs.append(
            SimInput(matrix=matrix, matrix_path=Path(matrix_path), combinations=combinations)
        )
    return sim_inputs


# ---------------------------------------------------------------------------
# Batched trial execution: one jitted step per (matrix, algorithm, batch)
# ---------------------------------------------------------------------------

# Frame-position classes for the rate-adaptive extension
# (reference: src/qkd_ldpc_algorithm.cpp:1148-1174).
_CLASS_PAYLOAD = 0
_CLASS_PUNCTURED = 1
_CLASS_SHORTENED = 2


def make_frame_plan(num_bits: int, params: HMatrixParams) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side encoding of one combination's frame extension.

    Returns ``(pos_class [N] int8, payload_gather [N] int32)`` where
    ``payload_gather[i]`` is the payload-key ordinal feeding frame position i
    (0 for non-payload positions). Both are *traced* device inputs, so every
    combination reuses the same compiled step.
    """
    pos_class = np.zeros(num_bits, dtype=np.int8)
    pos_class[params.punctured_bits] = _CLASS_PUNCTURED
    pos_class[params.shortened_bits] = _CLASS_SHORTENED
    payload_mask = pos_class == _CLASS_PAYLOAD
    payload_gather = np.zeros(num_bits, dtype=np.int32)
    payload_gather[payload_mask] = np.arange(
        int(payload_mask.sum()), dtype=np.int32
    )
    return pos_class, payload_gather


def _build_step(
    matrix: HMatrix,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    use_threshold: bool,
    rate_adaptive: bool,
    batch: int,
    dtype,
    select_size: int = 0,
    schedule: str = "flooding",
) -> Callable:
    """One device program for one batch of Monte-Carlo trials.

    Fixed rate  — generate keys, inject exact-count errors, LLR init,
    syndrome, decode (reference: run_trial + QKD_LDPC,
    src/simulation.cpp:540-577 / src/qkd_ldpc_algorithm.cpp:1031-1119).
    Rate adapt  — additionally extend the payload key to the N-bit frame from
    the traced class vector (reference: src/qkd_ldpc_algorithm.cpp:1121-1258;
    the reference generates full-N keys and consumes the first n as payload,
    which the slice below reproduces exactly).

    The decoder is the gather decoder (ops/decoders.py) for the flooding
    schedule on any code, and the layered decoder (ops/qc_decoder.py) for
    ``schedule="layered"`` on a QC matrix with a min-sum algorithm; any other
    layered request warns and floods.

    ``select_size`` > 0 builds the straggler-phase variant: the step takes an
    extra ``sel [select_size] int32`` argument, regenerates the same batch
    from the same PRNG keys, and decodes only the selected frames (used to
    re-decode phase-1 non-converged frames at the full iteration cap).

    Returns ``(syndromes_match, keys_match, iterations)`` over the decoded
    frames — keys_match is on extended frames (reference :1216), so no
    variable-length output compaction is needed for statistics.
    """
    layout = layout_for(matrix)
    dtype = jnp.dtype(dtype)
    n_bits = matrix.num_bit_nodes
    bit_order = jnp.asarray(layout.bit_order)
    if schedule == "layered" and (
        matrix.qc is None
        or algorithm in (DecodingAlgorithm.SPA, DecodingAlgorithm.SPA_APPROX)
    ):
        logger.warning(
            "tpu.schedule = layered needs a QC matrix and a min-sum "
            "algorithm; using the flooding schedule for this combination."
        )
        schedule = "flooding"
    if schedule == "layered":
        decode = make_qc_decoder(
            matrix.qc, algorithm, max_iterations, use_threshold, dtype=dtype,
            schedule="layered",
        )
    else:
        decode = get_decoder(
            layout, algorithm, max_iterations, use_threshold, dtype=dtype,
            jit=False,
        )

    def select(arr, sel):
        if sel is None:
            return arr
        return jnp.take(arr, sel, axis=0)

    def decode_tail(llr_ext, alice_frame, primary, secondary, threshold):
        alice_int = jnp.take(alice_frame, bit_order, axis=1)
        syndrome_int = syndrome_internal(layout, alice_int)
        syndrome_ext = jnp.take(
            syndrome_int, jnp.asarray(layout.check_inv), axis=1
        )
        res = decode(llr_ext, syndrome_ext, primary, secondary, threshold)
        keys_match = jnp.all(res.decision == alice_frame, axis=1)
        return res.syndromes_match, keys_match, res.iterations

    if not rate_adaptive:

        def base_step(ka, ke, kp, qber, num_errors, primary, secondary,
                      threshold, pos_class, payload_gather, sel=None):
            del kp, pos_class, payload_gather
            alice_full = generate_keys(ka, batch, n_bits)
            bob_full = inject_errors(ke, alice_full, num_errors)
            alice = select(alice_full, sel)
            bob = select(bob_full, sel)
            log_p = jnp.log((1.0 - qber) / qber).astype(dtype)
            llr = jnp.where(bob == 1, -log_p, log_p).astype(dtype)
            return decode_tail(llr, alice, primary, secondary, threshold)

    else:

        def base_step(ka, ke, kp, qber, num_errors, primary, secondary,
                      threshold, pos_class, payload_gather, sel=None):
            alice_full = generate_keys(ka, batch, n_bits)
            bob_full = inject_errors(ke, alice_full, num_errors)
            # Payload = first n bits of the full-N key, exactly like the
            # reference's sequential consumption (:1169-1172 over run_trial's
            # full-length keys). The payload_gather map is built over payload
            # ordinals, so gathering through it reads key bits 0..n-1.
            # Bob's punctured draw is dead weight (the decoder reads only
            # the ALMOST_ZERO LLR there and keys_match compares against
            # Alice's frame; the reference consumes it only for trace
            # prints), so only Alice's punctured bits are generated.
            kpa, _ = jax.random.split(kp)
            alice_punct = jax.random.bernoulli(kpa, 0.5, (batch, n_bits)).astype(jnp.int8)

            a_payload = jnp.take(alice_full, payload_gather, axis=1)
            b_payload = jnp.take(bob_full, payload_gather, axis=1)
            is_payload = (pos_class == _CLASS_PAYLOAD)[None, :]
            is_punct = (pos_class == _CLASS_PUNCTURED)[None, :]

            alice_frame = jnp.where(
                is_payload, a_payload, jnp.where(is_punct, alice_punct, 0)
            ).astype(jnp.int8)
            bob_frame = jnp.where(is_payload, b_payload, 0).astype(jnp.int8)

            log_p = jnp.log((1.0 - qber) / qber).astype(dtype)
            payload_llr = jnp.where(bob_frame == 1, -log_p, log_p).astype(dtype)
            llr = jnp.where(
                is_payload,
                payload_llr,
                jnp.where(
                    is_punct,
                    jnp.asarray(ALMOST_ZERO, dtype),
                    jnp.finfo(dtype).max,
                ),
            ).astype(dtype)
            return decode_tail(
                select(llr, sel), select(alice_frame, sel),
                primary, secondary, threshold,
            )

    if select_size <= 0:

        def step(ka, ke, kp, qber, num_errors, primary, secondary, threshold,
                 pos_class, payload_gather):
            return base_step(ka, ke, kp, qber, num_errors, primary, secondary,
                             threshold, pos_class, payload_gather)

    else:

        def step(ka, ke, kp, qber, num_errors, primary, secondary, threshold,
                 pos_class, payload_gather, sel):
            return base_step(ka, ke, kp, qber, num_errors, primary, secondary,
                             threshold, pos_class, payload_gather, sel)

    return step


_STEP_CACHE = PlanCache()
_WARMED_STEPS: set = set()


def get_step(
    matrix: HMatrix,
    cfg: Config,
    batch: int,
    max_iterations: Optional[int] = None,
    select_size: int = 0,
) -> Callable:
    """Memoized single-device jitted trial step (the default step factory;
    the distributed factory in parallel/driver.py shards the same step over
    a data mesh). ``max_iterations`` overrides the config cap (phase-1 of the
    two-phase decode); ``select_size`` builds the straggler variant."""
    cap = (
        cfg.decoding_alg_max_iterations
        if max_iterations is None
        else max_iterations
    )
    key = (
        cfg.decoding_algorithm,
        cap,
        cfg.enable_msg_llr_threshold,
        cfg.enable_code_rate_adaptation,
        batch,
        cfg.dtype,
        select_size,
        cfg.schedule,
    )
    fn = _STEP_CACHE.get(matrix, extra=key)
    if fn is not None:
        return fn
    fn = jax.jit(
        _build_step(
            matrix,
            cfg.decoding_algorithm,
            cap,
            cfg.enable_msg_llr_threshold,
            cfg.enable_code_rate_adaptation,
            batch,
            cfg.dtype,
            select_size=select_size,
            schedule=cfg.schedule,
        )
    )
    _STEP_CACHE.put(matrix, fn, extra=key)
    return fn


def resolve_phase1_cap(cfg: Config) -> int:
    """Effective phase-1 iteration cap (0 = two-phase disabled).

    Auto mode enables two-phase only when the full cap is large enough for
    stragglers to matter."""
    if cfg.phase1_iterations > 0:
        return min(cfg.phase1_iterations, cfg.decoding_alg_max_iterations)
    if cfg.phase1_iterations == 0:
        return 0
    # Auto: half the cap keeps the phase-1 straggler fraction near the FER
    # floor at typical operating points (mean convergence sits well under
    # cap/2 whenever the code is in its working region).
    return (
        cfg.decoding_alg_max_iterations // 2
        if cfg.decoding_alg_max_iterations >= 64
        else 0
    )


# ---------------------------------------------------------------------------
# Statistics (C21) and results (C22)
# ---------------------------------------------------------------------------


@dataclass
class SimResult:
    """Per-combination statistics (reference: ``sim_result``,
    src/simulation.hpp:43-68)."""

    sim_number: int = 0
    matrix_filename: str = ""
    is_regular: bool = True
    num_bit_nodes: int = 0
    num_check_nodes: int = 0
    config_qber: float = 0.0
    accurate_qber: float = 0.0
    delta: float = 0.0
    efficiency: float = 0.0
    punctured_fraction: float = 0.0
    shortened_fraction: float = 0.0
    adapted_code_rate: float = 0.0
    scaling_factors: ScalingFactors = field(default_factory=ScalingFactors)
    iter_success_max: int = 0
    iter_success_min: int = 0
    iter_success_mean: float = 0.0
    iter_success_std: float = 0.0
    ratio_trials_success_decoding: float = 0.0
    ratio_trials_success_ldpc: float = 0.0
    throughput_max: int = 0
    throughput_min: int = 0
    throughput_mean: int = 0
    throughput_std: int = 0


def process_trials_results(
    cfg: Config,
    syndromes_match: np.ndarray,
    keys_match: np.ndarray,
    iterations: np.ndarray,
    runtimes_us: Optional[np.ndarray],
    out_key_length: int,
    result: SimResult,
) -> None:
    """Aggregate one combination's per-trial outcomes into ``result``
    (reference: src/simulation.cpp:580-690; same definitions — iteration
    stats over syndrome-successful trials only, population std-dev,
    throughput in bits/s from out-key length over per-trial runtime with
    optional RTT added)."""
    trials = len(syndromes_match)
    ok = syndromes_match.astype(bool)
    n_dec = int(ok.sum())
    n_ldpc = int((ok & keys_match.astype(bool)).sum())

    if n_dec > 0:
        it_ok = iterations[ok].astype(np.float64)
        result.iter_success_max = int(it_ok.max())
        result.iter_success_min = int(it_ok.min())
        result.iter_success_mean = float(it_ok.mean())
        result.iter_success_std = float(it_ok.std())  # population (ref :622)
    else:
        result.iter_success_max = 0
        result.iter_success_min = 0
        result.iter_success_mean = 0.0
        result.iter_success_std = 0.0

    if cfg.enable_throughput_measurement and runtimes_us is not None:
        rtt_us = cfg.rtt_ms * 1000.0 if cfg.consider_rtt else 0.0
        tp = out_key_length * 1e6 / (runtimes_us.astype(np.float64) + rtt_us)
        result.throughput_max = int(tp.max())
        result.throughput_min = int(tp.min())
        result.throughput_mean = int(tp.mean())
        result.throughput_std = int(tp.std())

    result.ratio_trials_success_decoding = n_dec / trials
    result.ratio_trials_success_ldpc = n_ldpc / trials


def _run_trials_traced(
    matrix: HMatrix,
    comb: SimCombination,
    cfg: Config,
    sim_number: int,
    accurate_qber: float,
    num_errors: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side trial loop through the f64 oracle with console tracing
    (used when any trace flag is enabled — the reference emits its traces
    from inside the per-trial decoders, src/qkd_ldpc_algorithm.cpp:88-99,
    :1094-1116). PRNG discipline matches the device path exactly: same
    threefry keys, same batch generation, so traced runs reproduce the
    untraced sweep's channel realizations."""
    from qkd_ldpc_v_tpu.oracle import calculate_syndrome as oracle_syndrome
    from qkd_ldpc_v_tpu.tracing import traced_decode

    trials = cfg.trials_number
    n_bits = matrix.num_bit_nodes
    batch = cfg.batch_size if cfg.batch_size > 0 else trials
    batch = min(batch, trials)

    # Same chunked PRNG discipline as the device path so traced runs see the
    # identical channel realizations.
    alice_parts, bob_parts, ap_parts = [], [], []
    done = 0
    chunk_index = 0
    while done < trials:
        take = min(batch, trials - done)
        ka, ke, kp = trial_keys(cfg.simulation_seed, sim_number, chunk_index)
        a = np.asarray(generate_keys(ka, batch, n_bits))
        b = np.asarray(inject_errors(ke, jnp.asarray(a), num_errors))
        alice_parts.append(a[:take])
        bob_parts.append(b[:take])
        if cfg.enable_code_rate_adaptation:
            kpa, _ = jax.random.split(kp)
            ap_parts.append(
                np.asarray(
                    jax.random.bernoulli(kpa, 0.5, (batch, n_bits))
                ).astype(np.int8)[:take]
            )
        done += take
        chunk_index += 1
    alice_full = np.concatenate(alice_parts)
    bob_full = np.concatenate(bob_parts)

    if cfg.enable_code_rate_adaptation:
        pos_class, payload_gather = make_frame_plan(n_bits, comb.matrix_params)
        alice_punct = np.concatenate(ap_parts)
        is_payload = pos_class == _CLASS_PAYLOAD
        is_punct = pos_class == _CLASS_PUNCTURED
        a_payload = alice_full[:, payload_gather]
        b_payload = bob_full[:, payload_gather]
        alice_frames = np.where(
            is_payload, a_payload, np.where(is_punct, alice_punct, 0)
        ).astype(np.int8)
        bob_frames = np.where(is_payload, b_payload, 0).astype(np.int8)
        log_p = np.log((1.0 - accurate_qber) / accurate_qber)
        llr_frames = np.where(
            is_payload,
            np.where(bob_frames == 1, -log_p, log_p),
            np.where(is_punct, ALMOST_ZERO, np.finfo(np.float64).max),
        )
    else:
        alice_frames = alice_full
        log_p = np.log((1.0 - accurate_qber) / accurate_qber)
        llr_frames = np.where(bob_full == 1, -log_p, log_p)

    syn = np.zeros(trials, dtype=bool)
    keys = np.zeros(trials, dtype=bool)
    iters = np.zeros(trials, dtype=np.int32)
    for t in range(trials):
        syndrome = oracle_syndrome(matrix.check_nodes, alice_frames[t])
        decision, ok, it, _ = traced_decode(
            matrix,
            llr_frames[t],
            syndrome,
            cfg,
            comb.scaling_factors.primary,
            comb.scaling_factors.secondary,
        )
        syn[t] = ok
        keys[t] = bool(np.array_equal(decision, alice_frames[t]))
        iters[t] = it
        if cfg.trace_qkd_ldpc:
            print(f"Trial {t}: iterations={it} syndromes_match={ok} "
                  f"keys_match={keys[t]}")
    return syn, keys, iters


def run_combination(
    matrix: HMatrix,
    comb: SimCombination,
    cfg: Config,
    sim_number: int,
    progress: Optional[Callable[[int], None]] = None,
    step_factory: Optional[Callable[[HMatrix, Config, int], Callable]] = None,
) -> SimResult:
    """Execute all trials of one combination as device-wide batches.

    The reference's per-trial thread-pool fan-out + barrier
    (src/simulation.cpp:740-746) becomes chunked batched decodes; a chunk is
    the device analogue of the pool, and the barrier is the device sync at
    the end of each chunk.
    """
    n_bits = matrix.num_bit_nodes
    num_errors = exact_error_count(n_bits, comb.config_qber)
    if num_errors == 0:
        raise SimulationError(
            f"Key size '{n_bits}' is too small for QBER."
        )
    accurate_qber = num_errors / n_bits

    if cfg.dtype == "float64" and not jax.config.jax_enable_x64:
        # The advertised reference-parity mode; without x64 JAX would
        # silently truncate everything to float32.
        jax.config.update("jax_enable_x64", True)

    if cfg.trace_qkd_ldpc or cfg.trace_decoding_alg or cfg.trace_decoding_alg_llr:
        t0 = time.perf_counter()
        syn_t, keys_t, iters_t = _run_trials_traced(
            matrix, comb, cfg, sim_number, accurate_qber, num_errors
        )
        elapsed_us = (time.perf_counter() - t0) * 1e6
        if cfg.enable_code_rate_adaptation or cfg.enable_privacy_maintenance:
            out_len = n_bits - len(comb.matrix_params.bits_to_remove)
        else:
            out_len = n_bits
        result = SimResult(
            sim_number=sim_number,
            matrix_filename=Path(matrix.source_path).name if matrix.source_path else "",
            is_regular=matrix.is_regular,
            num_bit_nodes=matrix.num_bit_nodes,
            num_check_nodes=matrix.num_check_nodes,
            config_qber=comb.config_qber,
            accurate_qber=accurate_qber,
            delta=comb.matrix_params.delta,
            efficiency=comb.matrix_params.efficiency,
            punctured_fraction=comb.matrix_params.punctured_fraction,
            shortened_fraction=comb.matrix_params.shortened_fraction,
            adapted_code_rate=comb.matrix_params.adapted_code_rate,
            scaling_factors=comb.scaling_factors,
        )
        process_trials_results(
            cfg, syn_t, keys_t, iters_t,
            np.full(cfg.trials_number, elapsed_us / cfg.trials_number)
            if cfg.enable_throughput_measurement else None,
            out_len, result,
        )
        if progress is not None:
            progress(cfg.trials_number)
        return result

    trials = cfg.trials_number
    batch = cfg.batch_size if cfg.batch_size > 0 else trials
    batch = min(batch, trials)
    # Two-phase straggler re-decode (bit-identical to a single full-cap run,
    # see resolve_phase1_cap) is only wired for the default single-device
    # factory; mesh factories run single-phase.
    if step_factory is not None:
        phase1_cap = 0
        if resolve_phase1_cap(cfg):
            logger.warning(
                "mesh step factory runs single-phase decode: the two-phase "
                "straggler re-decode needs host-side straggler indices and "
                "is only wired for the single-device path (results are "
                "identical; throughput may differ). Set "
                "tpu.phase1_iterations = 0 to silence this."
            )
        step = step_factory(matrix, cfg, batch)
    else:
        phase1_cap = resolve_phase1_cap(cfg)
        step = get_step(matrix, cfg, batch, max_iterations=phase1_cap or None)

    pos_class, payload_gather = make_frame_plan(n_bits, comb.matrix_params)
    pos_class_d = jnp.asarray(pos_class)
    payload_gather_d = jnp.asarray(payload_gather)

    sdtype = jnp.dtype(cfg.dtype)
    scalar_args = (
        jnp.asarray(accurate_qber, sdtype),
        jnp.int32(num_errors),
        jnp.asarray(comb.scaling_factors.primary, sdtype),
        jnp.asarray(comb.scaling_factors.secondary, sdtype),
        jnp.asarray(cfg.msg_llr_threshold, sdtype),
        pos_class_d,
        payload_gather_d,
    )

    if cfg.enable_code_rate_adaptation or cfg.enable_privacy_maintenance:
        out_key_length = n_bits - len(comb.matrix_params.bits_to_remove)
    else:
        out_key_length = n_bits

    syn_parts: List[np.ndarray] = []
    key_parts: List[np.ndarray] = []
    iter_parts: List[np.ndarray] = []
    runtime_parts: List[np.ndarray] = []

    reduce_mode = bool(getattr(step, "reduces", False))

    def step_args(ka, ke, kp, take):
        if reduce_mode:
            return (ka, ke, kp) + scalar_args + (jnp.int32(take),)
        return (ka, ke, kp) + scalar_args

    if cfg.enable_throughput_measurement and id(step) not in _WARMED_STEPS:
        # The reference times pure decode work; keep XLA trace/compile out
        # of the first chunk's runtime.
        ka, ke, kp = trial_keys(cfg.simulation_seed, sim_number, 0)
        jax.block_until_ready(step(*step_args(ka, ke, kp, min(batch, trials))))
        _WARMED_STEPS.add(id(step))

    if reduce_mode:
        # Fully-distributed aggregation: only the six psum_stats scalars per
        # chunk cross to the host (reference aggregation semantics,
        # src/simulation.cpp:580-690, computed from on-device sums).
        return _run_chunks_reduced(
            matrix, comb, cfg, sim_number, accurate_qber, step, step_args,
            batch, trials, out_key_length, progress,
        )

    done = 0
    chunk_index = 0
    while done < trials:
        take = min(batch, trials - done)
        ka, ke, kp = trial_keys(cfg.simulation_seed, sim_number, chunk_index)
        t0 = time.perf_counter()
        syn, keys, iters = jax.device_get(
            step(ka, ke, kp, *scalar_args)
        )
        syn = np.asarray(syn[:take]).copy()
        keys = np.asarray(keys[:take]).copy()
        iters = np.asarray(iters[:take]).copy()

        if phase1_cap:
            # Re-decode phase-1 stragglers from scratch at the full cap: BP
            # from the same initialization is deterministic, so frames that
            # converged in phase 1 already carry their exact full-run result,
            # and stragglers get theirs here.
            stragglers = np.flatnonzero(~syn)
            if len(stragglers):
                s_pad = max(64, 1 << int(np.ceil(np.log2(len(stragglers)))))
                s_pad = min(s_pad, batch)
                step2 = get_step(matrix, cfg, batch, select_size=s_pad)
                sel = np.zeros(s_pad, dtype=np.int32)
                sel[: len(stragglers)] = stragglers
                sel_d = jnp.asarray(sel)
                if (
                    cfg.enable_throughput_measurement
                    and id(step2) not in _WARMED_STEPS
                ):
                    # Exclude the straggler-step compile from the chunk
                    # timer (warm-up only compiled the phase-1 step).
                    t_pause = time.perf_counter()
                    jax.block_until_ready(
                        step2(ka, ke, kp, *scalar_args, sel_d)
                    )
                    _WARMED_STEPS.add(id(step2))
                    t0 += time.perf_counter() - t_pause
                syn2, keys2, iters2 = jax.device_get(
                    step2(ka, ke, kp, *scalar_args, sel_d)
                )
                syn[stragglers] = np.asarray(syn2[: len(stragglers)])
                keys[stragglers] = np.asarray(keys2[: len(stragglers)])
                iters[stragglers] = np.asarray(iters2[: len(stragglers)])

        elapsed_us = (time.perf_counter() - t0) * 1e6
        # Per-trial runtime = batch wall time / batch size: the batch is the
        # device's unit of work (all frames decode simultaneously, even in a
        # short final chunk), so this is the marginal per-frame cost the
        # reference's per-trial timer measures.
        runtime_parts.append(np.full(take, elapsed_us / batch))
        syn_parts.append(syn)
        key_parts.append(keys)
        iter_parts.append(iters)
        done += take
        chunk_index += 1
        if progress is not None:
            progress(take)

    result = SimResult(
        sim_number=sim_number,
        matrix_filename=Path(matrix.source_path).name if matrix.source_path else "",
        is_regular=matrix.is_regular,
        num_bit_nodes=matrix.num_bit_nodes,
        num_check_nodes=matrix.num_check_nodes,
        config_qber=comb.config_qber,
        accurate_qber=accurate_qber,
        delta=comb.matrix_params.delta,
        efficiency=comb.matrix_params.efficiency,
        punctured_fraction=comb.matrix_params.punctured_fraction,
        shortened_fraction=comb.matrix_params.shortened_fraction,
        adapted_code_rate=comb.matrix_params.adapted_code_rate,
        scaling_factors=comb.scaling_factors,
    )
    process_trials_results(
        cfg,
        np.concatenate(syn_parts),
        np.concatenate(key_parts),
        np.concatenate(iter_parts),
        np.concatenate(runtime_parts) if cfg.enable_throughput_measurement else None,
        out_key_length,
        result,
    )
    return result


def _run_chunks_reduced(
    matrix: HMatrix,
    comb: SimCombination,
    cfg: Config,
    sim_number: int,
    accurate_qber: float,
    step: Callable,
    step_args: Callable,
    batch: int,
    trials: int,
    out_key_length: int,
    progress,
) -> SimResult:
    """Chunk loop for reduce-mode mesh steps: per chunk only the six
    psum_stats scalars reach the host, and the reference's statistics
    (iteration stats over syndrome-successful trials, population std-dev —
    src/simulation.cpp:580-690) are reconstructed from the on-device sums.
    Per-frame arrays never leave the devices. Variance combines per-chunk
    M2 sums (deviations about each chunk's mean) with Chan's pairwise
    update in float64 on the host — cancellation-free even though the
    on-device accumulation is float32."""
    n_dec = 0.0
    n_ldpc = 0.0
    it_sum = 0.0
    it_m2 = 0.0
    it_min: Optional[float] = None
    it_max: Optional[float] = None
    tp_chunks: List[Tuple[int, float]] = []  # (trials in chunk, us/trial)
    done = 0
    chunk_index = 0
    while done < trials:
        take = min(batch, trials - done)
        ka, ke, kp = trial_keys(cfg.simulation_seed, sim_number, chunk_index)
        t0 = time.perf_counter()
        d, l, s, m2, mn, mx = jax.device_get(
            step(*step_args(ka, ke, kp, take))
        )
        elapsed_us = (time.perf_counter() - t0) * 1e6
        d = float(d)
        if d > 0:
            # Chan's parallel-variance combination of (n, sum, M2) pairs.
            delta = float(s) / d - (it_sum / n_dec if n_dec > 0 else 0.0)
            it_m2 += float(m2) + (
                delta * delta * n_dec * d / (n_dec + d) if n_dec > 0 else 0.0
            )
        n_dec += d
        n_ldpc += float(l)
        it_sum += float(s)
        if d > 0:
            it_min = float(mn) if it_min is None else min(it_min, float(mn))
            it_max = float(mx) if it_max is None else max(it_max, float(mx))
        if cfg.enable_throughput_measurement:
            tp_chunks.append((take, elapsed_us / batch))
        done += take
        chunk_index += 1
        if progress is not None:
            progress(take)

    result = SimResult(
        sim_number=sim_number,
        matrix_filename=Path(matrix.source_path).name if matrix.source_path else "",
        is_regular=matrix.is_regular,
        num_bit_nodes=matrix.num_bit_nodes,
        num_check_nodes=matrix.num_check_nodes,
        config_qber=comb.config_qber,
        accurate_qber=accurate_qber,
        delta=comb.matrix_params.delta,
        efficiency=comb.matrix_params.efficiency,
        punctured_fraction=comb.matrix_params.punctured_fraction,
        shortened_fraction=comb.matrix_params.shortened_fraction,
        adapted_code_rate=comb.matrix_params.adapted_code_rate,
        scaling_factors=comb.scaling_factors,
    )
    if n_dec > 0:
        mean = it_sum / n_dec
        var = max(it_m2 / n_dec, 0.0)
        result.iter_success_mean = mean
        result.iter_success_std = var**0.5
        result.iter_success_min = int(it_min)
        result.iter_success_max = int(it_max)
    else:
        result.iter_success_mean = 0.0
        result.iter_success_std = 0.0
        result.iter_success_min = 0
        result.iter_success_max = 0
    if cfg.enable_throughput_measurement and tp_chunks:
        rtt_us = cfg.rtt_ms * 1000.0 if cfg.consider_rtt else 0.0
        tps = np.array(
            [out_key_length * 1e6 / (rt + rtt_us) for _, rt in tp_chunks]
        )
        w = np.array([t for t, _ in tp_chunks], dtype=np.float64)
        mean = float((tps * w).sum() / w.sum())
        var = max(float((tps * tps * w).sum() / w.sum() - mean * mean), 0.0)
        result.throughput_mean = int(mean)
        result.throughput_std = int(var**0.5)
        result.throughput_min = int(tps.min())
        result.throughput_max = int(tps.max())
    result.ratio_trials_success_decoding = n_dec / trials
    result.ratio_trials_success_ldpc = n_ldpc / trials
    return result


def _campaign_fingerprint(sim_inputs: Sequence[SimInput], cfg: Config) -> str:
    """Stable id of a sweep campaign for checkpoint/resume: config fields
    that affect results plus the matrix file list."""
    import hashlib

    parts = [
        repr(
            (
                cfg.trials_number,
                cfg.simulation_seed,
                int(cfg.decoding_algorithm),
                cfg.decoding_alg_max_iterations,
                cfg.enable_privacy_maintenance,
                cfg.enable_code_rate_adaptation,
                cfg.enable_untainted_puncturing,
                cfg.enable_msg_llr_threshold,
                cfg.msg_llr_threshold,
                cfg.dtype,
                # batch_size changes trial realizations (chunked threefry
                # key derivation), so a resumed checkpoint must not mix
                # batch sizes.
                cfg.batch_size,
                cfg.schedule,
            )
        )
    ]
    for s in sim_inputs:
        parts.append(str(s.matrix_path))
        for c in s.combinations:
            mp = c.matrix_params
            parts.append(
                repr(
                    (
                        c.config_qber,
                        c.scaling_factors.primary,
                        c.scaling_factors.secondary,
                        mp.delta,
                        mp.efficiency,
                        mp.punctured_bits.tobytes(),
                        mp.shortened_bits.tobytes(),
                        mp.bits_to_remove.tobytes(),
                    )
                )
            )
    return hashlib.sha256("\n".join(parts).encode()).hexdigest()[:16]


def save_checkpoint(path, fingerprint: str, results: Sequence[SimResult]) -> None:
    """Append-style JSON checkpoint of completed combinations. The reference
    writes results only at campaign end and loses everything on a crash
    (reference: src/main.cpp:185); this framework checkpoints each finished
    combination and resumes mid-sweep."""
    import json

    payload = {
        "fingerprint": fingerprint,
        "results": [dataclasses.asdict(r) for r in results],
    }
    tmp = Path(str(path) + ".tmp")
    tmp.write_text(json.dumps(payload))
    tmp.replace(path)


def load_checkpoint(path, fingerprint: str) -> List[SimResult]:
    """Load a matching checkpoint's completed results ([] when absent or
    from a different campaign)."""
    import json

    path = Path(path)
    if not path.exists():
        return []
    try:
        payload = json.loads(path.read_text())
    except (OSError, ValueError):
        return []
    if payload.get("fingerprint") != fingerprint:
        return []
    out = []
    for d in payload.get("results", []):
        sf = d.pop("scaling_factors", {})
        out.append(SimResult(**d, scaling_factors=ScalingFactors(**sf)))
    return out


def qkd_ldpc_batch_simulation(
    sim_inputs: Sequence[SimInput],
    cfg: Config,
    progress: Optional[Callable[[int, int], None]] = None,
    step_factory: Optional[Callable[[HMatrix, Config, int], Callable]] = None,
    checkpoint_path=None,
) -> List[SimResult]:
    """Run the full sweep (reference: src/simulation.cpp:693-768).

    ``progress(trials_done_increment, trials_total)`` is invoked as chunks
    complete (the reference ticks its bar per trial, :744). When
    ``checkpoint_path`` is given, each finished combination is checkpointed
    and a matching prior checkpoint resumes the sweep mid-way.
    """
    sim_total = sum(len(s.combinations) for s in sim_inputs)
    trials_total = sim_total * cfg.trials_number

    fingerprint = ""
    results: List[SimResult] = []
    if checkpoint_path is not None:
        fingerprint = _campaign_fingerprint(sim_inputs, cfg)
        results = load_checkpoint(checkpoint_path, fingerprint)
        if results and progress:
            progress(len(results) * cfg.trials_number, trials_total)

    sim_number = 0
    cb = (lambda inc: progress(inc, trials_total)) if progress else None
    for sim_in in sim_inputs:
        for comb in sim_in.combinations:
            if sim_number < len(results):
                sim_number += 1  # already completed in a prior run
                continue
            res = run_combination(
                sim_in.matrix, comb, cfg, sim_number,
                progress=cb, step_factory=step_factory,
            )
            res.matrix_filename = sim_in.matrix_path.name
            results.append(res)
            sim_number += 1
            if checkpoint_path is not None:
                save_checkpoint(checkpoint_path, fingerprint, results)
    # NB: the checkpoint is left on disk; the caller removes it once the
    # results have safely landed (cli.py deletes it after write_file).
    return results


# ---------------------------------------------------------------------------
# CSV results writer (C22)
# ---------------------------------------------------------------------------


def _num(value: float, prec: int) -> str:
    """Fixed-precision number with comma decimal separator (the reference
    writes with a custom ru-style locale, src/simulation.cpp:10-23)."""
    return f"{value:.{prec}f}".replace(".", ",")


def _gen(value: float) -> str:
    """General formatting ({:L} in the reference) with comma separator."""
    s = repr(float(value)) if not float(value).is_integer() else str(int(value))
    return s.replace(".", ",")


def result_filename(cfg: Config, sim_duration: str) -> str:
    """Self-describing base filename (reference: src/simulation.cpp:81-91)."""
    alg_names = {
        DecodingAlgorithm.SPA: "SPA",
        DecodingAlgorithm.SPA_APPROX: "SPA-LIN-APPROX",
        DecodingAlgorithm.NMSA: "NMSA",
        DecodingAlgorithm.OMSA: "OMSA",
        DecodingAlgorithm.ANMSA: "ANMSA",
        DecodingAlgorithm.AOMSA: "AOMSA",
    }
    if cfg.enable_code_rate_adaptation:
        punct = "untainted" if cfg.enable_untainted_puncturing else "random"
        rate_adapt = f"ON[punct={punct}]"
    else:
        rate_adapt = "OFF"
    rtt_part = ""
    if cfg.enable_throughput_measurement and cfg.consider_rtt:
        rtt_part = f",RTT={cfg.rtt_ms:.3f}ms"
    return (
        "ldpc("
        f"trial_num={cfg.trials_number},"
        f"dec_alg={alg_names[cfg.decoding_algorithm]},"
        f"max_dec_alg_iters={cfg.decoding_alg_max_iterations},"
        f"priv_maint={'ON' if cfg.enable_privacy_maintenance else 'OFF'},"
        f"rate_adapt={rate_adapt}"
        f"{rtt_part},"
        f"seed={cfg.simulation_seed},"
        f"sim_duration={sim_duration}"
        ")"
    )


def write_file(
    results: Sequence[SimResult],
    cfg: Config,
    sim_duration: str,
    directory,
) -> Path:
    """Write the per-combination CSV (reference: src/simulation.cpp:4-176):
    same filename scheme with collision ``_k`` suffix, same semicolon-
    separated columns, same comma decimal separator, FER rounded to trial
    granularity at write time.

    Throughput-column semantics caveat (PARITY.md §3): the reference times
    each trial individually on a CPU thread; here trials decode in device
    batches, so per-trial runtime = chunk wall time / chunk size and the
    THROUGHPUT_MIN/MAX/STD spread reflects *chunk-level* variation (a
    sidecar ``<file>.THROUGHPUT_NOTE.txt`` records this next to the CSV so
    downstream consumers of the directory see it without reading the code;
    the CSV itself stays byte-compatible with the reference format)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)

    base = result_filename(cfg, sim_duration)
    path = directory / f"{base}.csv"
    count = 1
    while path.exists():
        path = directory / f"{base}_{count}.csv"
        count += 1

    scaling_header = {
        DecodingAlgorithm.NMSA: ";ALPHA",
        DecodingAlgorithm.OMSA: ";BETA",
        DecodingAlgorithm.ANMSA: ";ALPHA;NU",
        DecodingAlgorithm.AOMSA: ";BETA;SIGMA",
    }.get(cfg.decoding_algorithm, "")

    header = (
        "#;MATRIX_FILENAME;TYPE;R;M;N;CONFIG_QBER;ACCURATE_QBER;"
        "ITER_SUCCESS_MEAN;ITER_SUCCESS_STD;ITER_SUCCESS_MIN;"
        "ITER_SUCCESS_MAX;RATIO_SUCCESS_DEC;RATIO_SUCCESS_LDPC;FER"
    )
    if cfg.enable_code_rate_adaptation:
        header += ";DELTA;EFFICIENCY;PUNCT_FRACTION;SHORT_FRACTION;R_ADAPTED"
    if cfg.enable_throughput_measurement:
        header += ";THROUGHPUT_MEAN;THROUGHPUT_STD;THROUGHPUT_MIN;THROUGHPUT_MAX"
    header += scaling_header

    lines = [header]
    for r in results:
        fer = 1.0 - r.ratio_trials_success_ldpc
        fer = round(fer * cfg.trials_number) / cfg.trials_number
        code_rate = 1.0 - r.num_check_nodes / r.num_bit_nodes
        line = ";".join(
            [
                str(r.sim_number),
                r.matrix_filename,
                "regular" if r.is_regular else "irregular",
                _num(code_rate, 3),
                str(r.num_check_nodes),
                str(r.num_bit_nodes),
                _num(r.config_qber, 4),
                _num(r.accurate_qber, 4),
                _num(r.iter_success_mean, 2),
                _num(r.iter_success_std, 2),
                str(r.iter_success_min),
                str(r.iter_success_max),
                _gen(r.ratio_trials_success_decoding),
                _gen(r.ratio_trials_success_ldpc),
                _gen(fer),
            ]
        )
        if cfg.enable_code_rate_adaptation:
            line += ";" + ";".join(
                [
                    _num(r.delta, 3),
                    _num(r.efficiency, 3),
                    _num(r.punctured_fraction, 3),
                    _num(r.shortened_fraction, 3),
                    _num(r.adapted_code_rate, 3),
                ]
            )
        if cfg.enable_throughput_measurement:
            line += ";" + ";".join(
                [
                    str(r.throughput_mean),
                    str(r.throughput_std),
                    str(r.throughput_min),
                    str(r.throughput_max),
                ]
            )
        if cfg.decoding_algorithm.uses_scaling_factors:
            line += ";" + _num(r.scaling_factors.primary, 3)
        if cfg.decoding_algorithm.is_adaptive:
            line += ";" + _num(r.scaling_factors.secondary, 3)
        lines.append(line)

    path.write_text("\n".join(lines) + "\n")
    if cfg.enable_throughput_measurement:
        path.with_suffix(".THROUGHPUT_NOTE.txt").write_text(
            "THROUGHPUT_* columns in the sibling CSV are computed from "
            "device-batch wall times (per-trial runtime = chunk wall time / "
            "chunk size), not per-trial timers as in the reference "
            "implementation; MIN/MAX/STD therefore reflect chunk-level "
            "variation. Means are directly comparable. See PARITY.md §3.\n"
        )
    return path
