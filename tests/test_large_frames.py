"""N=102400 operation — the reference's largest production frames
(sparse_matrices/matrices_alist_100k_all, SURVEY.md §5's long-context
analogue). The generic XLA decoder and the edge-sharded mesh decoder carry
it."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qkd_ldpc_v_tpu.config import DecodingAlgorithm
from qkd_ldpc_v_tpu.models.layout import layout_for
from qkd_ldpc_v_tpu.ops.channel import calculate_syndrome
from qkd_ldpc_v_tpu.ops.decoders import make_decoder
from tests.conftest import REFERENCE_DIR, reference_available

# The committed 100k alist asset (scripts/make_assets.py) keeps this file
# self-contained; the reference's own 100k matrix is preferred when its
# mount is present (the parity campaigns in PARITY.md use it).
MATRIX_100K_LOCAL = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "sparse_matrices/matrices_alist",
    "(N=102400,M=31744,R=0.69,CW=3,SEED=67).mtrx",
)
MATRIX_100K = os.path.join(
    REFERENCE_DIR,
    "sparse_matrices/matrices_alist_100k_all",
    "(N=102400,M=32001,R=0.69,CW=3,SEED=777).mtrx",
)


@pytest.fixture(scope="module")
def matrix_100k():
    from qkd_ldpc_v_tpu.models.hmatrix import read_sparse_matrix_alist

    if reference_available() and os.path.exists(MATRIX_100K):
        return read_sparse_matrix_alist(MATRIX_100K)
    return read_sparse_matrix_alist(MATRIX_100K_LOCAL)


@pytest.fixture(scope="module")
def case_100k(matrix_100k):
    rng = np.random.default_rng(4)
    n = matrix_100k.num_bit_nodes
    batch = 2
    alice = jnp.asarray(rng.integers(0, 2, (batch, n)), jnp.int8)
    # very low QBER so a handful of iterations suffices on CPU
    bob = alice ^ jnp.asarray(rng.random((batch, n)) < 0.005, jnp.int8)
    log_p = float(np.log(0.995 / 0.005))
    llr = jnp.where(bob == 1, -log_p, log_p).astype(jnp.float32)
    syn = calculate_syndrome(layout_for(matrix_100k), alice)
    return alice, llr, syn


def test_100k_frame_decodes(matrix_100k, case_100k):
    assert matrix_100k.num_bit_nodes == 102400
    alice, llr, syn = case_100k
    layout = layout_for(matrix_100k)
    decode = jax.jit(
        make_decoder(layout, DecodingAlgorithm.NMSA, 8, False, jnp.float32)
    )
    res = decode(llr, syn, 0.8, 1.0, 0.0)
    assert np.asarray(res.syndromes_match).all()
    np.testing.assert_array_equal(np.asarray(res.decision), np.asarray(alice))


def test_100k_edge_sharded_matches(matrix_100k, case_100k):
    """Edge-state sharding over a 2-device mesh (SURVEY.md §5): identical
    results, XLA inserts the regroup collectives."""
    from jax.sharding import Mesh

    from qkd_ldpc_v_tpu.parallel.driver import edge_sharded_decoder

    alice, llr, syn = case_100k
    layout = layout_for(matrix_100k)
    mesh = Mesh(np.asarray(jax.devices()[:2]), axis_names=("model",))
    sharded = edge_sharded_decoder(
        layout, DecodingAlgorithm.NMSA, 8, mesh
    )
    plain = jax.jit(
        make_decoder(layout, DecodingAlgorithm.NMSA, 8, False, jnp.float32)
    )
    rs = sharded(llr, syn, 0.8, 1.0, 0.0)
    rp = plain(llr, syn, 0.8, 1.0, 0.0)
    np.testing.assert_array_equal(
        np.asarray(rs.decision), np.asarray(rp.decision)
    )
    np.testing.assert_array_equal(
        np.asarray(rs.iterations), np.asarray(rp.iterations)
    )
