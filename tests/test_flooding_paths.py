"""The two XLA flooding decoders against each other and against the f64
oracle.

* The roll decoder (ops/qc_decoder.py) and the gather decoder
  (ops/decoders.py) implement the same flooding schedule: on QC codes they
  must agree exactly in f32 — decisions, convergence flags and iteration
  counts — including degenerate base graphs (one block row, column weight
  1 or 2) and liftings that are not powers of two.
* The gather decoder in f64 follows the reference's sequential arithmetic:
  it must equal the oracle (oracle.py) per frame on a regular and an
  irregular code, for all six algorithms, with and without the message
  clamp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qkd_ldpc_v_tpu.config import DecodingAlgorithm
from qkd_ldpc_v_tpu.models.layout import layout_for
from qkd_ldpc_v_tpu.models.qc import generate_qc_ldpc
from qkd_ldpc_v_tpu.ops.channel import calculate_syndrome
from qkd_ldpc_v_tpu.ops.decoders import get_decoder, make_decoder
from qkd_ldpc_v_tpu.ops.qc_decoder import make_qc_decoder
from tests.irregular import irregular_matrix
from tests.oracle import decode_oracle

FACTORS = {
    DecodingAlgorithm.SPA: (1.0, 1.0),
    DecodingAlgorithm.SPA_APPROX: (1.0, 1.0),
    DecodingAlgorithm.NMSA: (0.8, 1.0),
    DecodingAlgorithm.OMSA: (0.3, 1.0),
    DecodingAlgorithm.ANMSA: (0.88, 0.5),
    DecodingAlgorithm.AOMSA: (0.3, 0.6),
}
MIN_SUM = [DecodingAlgorithm.NMSA, DecodingAlgorithm.OMSA,
           DecodingAlgorithm.ANMSA, DecodingAlgorithm.AOMSA]


def _exact_count_case(matrix, frames, qber, seed, dtype):
    rng = np.random.default_rng(seed)
    n = matrix.num_bit_nodes
    alice = rng.integers(0, 2, (frames, n)).astype(np.int8)
    bob = alice.copy()
    ne = max(2, int(n * qber))
    for f in range(frames):
        bob[f, rng.choice(n, size=ne, replace=False)] ^= 1
    q = ne / n
    log_p = np.log((1 - q) / q)
    llr = np.where(bob == 1, -log_p, log_p).astype(dtype)
    syn = np.asarray(calculate_syndrome(layout_for(matrix), jnp.asarray(alice)))
    return alice, llr, syn


@pytest.mark.parametrize("nb,mb,z,cw,seed", [
    (4, 2, 128, 2, 11),    # two block rows, column weight 2
    (6, 1, 128, 1, 12),    # one block row, column weight 1
    (10, 5, 256, 3, 13),   # Z = 256
    (12, 4, 96, 3, 14),    # Z = 96
])
@pytest.mark.parametrize("alg", MIN_SUM, ids=lambda a: a.name)
def test_roll_matches_gather(nb, mb, z, cw, seed, alg):
    qc = generate_qc_ldpc(nb, mb, z, column_weight=cw, seed=seed)
    matrix = qc.to_hmatrix()
    _, llr, syn = _exact_count_case(matrix, 9, 0.025, seed, np.float32)
    p, s = FACTORS[alg]
    gather = jax.jit(make_decoder(layout_for(matrix), alg, 25, False))
    roll = jax.jit(make_qc_decoder(qc, alg, 25, False))
    rg = gather(llr, syn, p, s, 0.0)
    rr = roll(llr, syn, p, s, 0.0)
    for a, b in zip(rr, rg):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module", params=["regular_512", "irregular_288"])
def code(request, medium_matrix):
    if request.param == "regular_512":
        return medium_matrix
    return irregular_matrix()


@pytest.mark.parametrize("alg", list(DecodingAlgorithm), ids=lambda a: a.name)
@pytest.mark.parametrize("use_threshold", [False, True],
                         ids=["no_clamp", "clamp"])
def test_f64_matches_oracle(code, alg, use_threshold):
    alice, llr, syn = _exact_count_case(code, 4, 0.03, int(alg),
                                        np.float64)
    p, s = FACTORS[alg]
    thr = 6.0
    decode = get_decoder(layout_for(code), alg, 40, use_threshold,
                         dtype=jnp.float64)
    res = decode(jnp.asarray(llr), jnp.asarray(syn), p, s, thr)
    for f in range(llr.shape[0]):
        d_o, ok_o, it_o = decode_oracle(code, llr[f], syn[f], int(alg), 40,
                                        p, s, thr, use_threshold)
        assert bool(res.syndromes_match[f]) == ok_o, f
        assert int(res.iterations[f]) == it_o, f
        np.testing.assert_array_equal(np.asarray(res.decision)[f], d_o)
