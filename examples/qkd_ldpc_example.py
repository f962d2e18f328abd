"""Textbook walk-through: one fixed-rate reconciliation round with tracing.

Mirrors the reference's library example (reference:
example/qkd_ldpc_example.cpp:1-41): Johnson, *Introducing Low-Density
Parity-Check Codes*, example 2.5 (p. 33) — a 6-bit key, the 4x6 parity-check
matrix, SPA decoding with an LLR threshold of 100, full tracing.

Run: ``python examples/qkd_ldpc_example.py``

Two decodes are shown: the reference-exact traced f64 oracle (the same
trajectory the C++ example prints), then the batched device decoder on the same
frame, demonstrating they agree.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from qkd_ldpc_v_tpu.config import Config, DecodingAlgorithm, RQBERRange
from qkd_ldpc_v_tpu.models.hmatrix import from_dense
from qkd_ldpc_v_tpu.models.layout import layout_for
from qkd_ldpc_v_tpu.ops.channel import calculate_syndrome
from qkd_ldpc_v_tpu.ops.decoders import get_decoder
from qkd_ldpc_v_tpu.tracing import traced_protocol_round


def main() -> int:
    import jax

    jax.config.update("jax_enable_x64", True)  # f64 reference-parity mode

    # The (N=6, K=2, M=4, R=0.34) matrix of the textbook example — the same
    # asset the reference ships as
    # sparse_matrices/matrices_uncompressed/(N=6,K=2,M=4,R=0.34).mtrx.
    dense = np.array(
        [
            [1, 1, 0, 1, 0, 0],
            [0, 1, 1, 0, 1, 0],
            [1, 0, 0, 0, 1, 1],
            [0, 0, 1, 1, 0, 1],
        ],
        dtype=np.int8,
    )
    matrix = from_dense(dense)

    cfg = Config(
        decoding_algorithm=DecodingAlgorithm.SPA,
        decoding_alg_max_iterations=100,
        enable_msg_llr_threshold=True,
        msg_llr_threshold=100.0,
        trace_qkd_ldpc=True,
        trace_decoding_alg=True,
        trace_decoding_alg_llr=True,
        r_qber_ranges=(RQBERRange(0.99, 0.2, 0.2, 0.1),),
    )

    alice = np.array([0, 0, 1, 0, 1, 1])
    bob = np.array([1, 0, 1, 0, 1, 1])  # one flipped bit
    qber = 0.2

    print("=== Reference-exact traced round (f64 oracle) ===")
    decision, ok, keys_match, iters = traced_protocol_round(
        matrix, alice, bob, qber, cfg
    )

    print("\n=== Batched device decoder on the same frame ===")
    import jax.numpy as jnp

    layout = layout_for(matrix)
    decode = get_decoder(
        layout, cfg.decoding_algorithm, cfg.decoding_alg_max_iterations,
        use_threshold=True, dtype=jnp.float64,
    )
    log_p = float(np.log((1 - qber) / qber))
    llr = jnp.asarray(np.where(bob == 1, -log_p, log_p)[None, :])
    syndrome = calculate_syndrome(layout, jnp.asarray(alice[None, :], jnp.int8))
    res = decode(llr, syndrome, 1.0, 1.0, 100.0)
    device_decision = np.asarray(res.decision[0])
    print(f"decision: {device_decision.tolist()}")
    print(f"iterations: {int(res.iterations[0])} (oracle: {iters})")
    assert np.array_equal(device_decision, decision), "device != oracle"
    assert int(res.iterations[0]) == iters
    print("device decode matches the reference-exact trajectory.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
