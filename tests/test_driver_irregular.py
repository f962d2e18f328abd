"""Driver paths on an irregular code (several degree groups on both sides):
rate adaptation, two-phase decoding, the iteration cap, the data mesh and
bfloat16 messages."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from qkd_ldpc_v_tpu.config import Config, DecodingAlgorithm, RQBERRange
from qkd_ldpc_v_tpu.models.layout import layout_for
from qkd_ldpc_v_tpu.ops.channel import calculate_syndrome
from qkd_ldpc_v_tpu.ops.decoders import get_decoder
from qkd_ldpc_v_tpu.rate_adapt import (
    HMatrixParams,
    adapt_code_rate,
    finalize_bits_to_remove,
)
from qkd_ldpc_v_tpu.simulation import (
    ScalingFactors,
    SimCombination,
    run_combination,
)
from tests.irregular import irregular_matrix
from tests.oracle import decode_oracle


@pytest.fixture(scope="module")
def irregular():
    return irregular_matrix()


def _cfg(**over):
    base = dict(
        trials_number=16,
        simulation_seed=4,
        decoding_algorithm=DecodingAlgorithm.NMSA,
        decoding_alg_max_iterations=40,
        r_qber_ranges=(RQBERRange(0.99, 0.03, 0.03, 0.01),),
        batch_size=16,
    )
    base.update(over)
    return Config(**base)


def test_rate_adaptive_matches_traced_oracle(irregular, capsys):
    """Rate-adapted frames (punctured and shortened positions) through the
    device f64 step equal the traced oracle path, statistic by statistic."""
    matrix = irregular_matrix()  # rate adaptation annotates the matrix
    rng = np.random.default_rng(2)
    params = adapt_code_rate(rng, matrix, qber=0.05, delta=0.1,
                             efficiency=1.7)
    assert not params.is_empty
    finalize_bits_to_remove(matrix, params, False)
    cfg = _cfg(trials_number=8, batch_size=8, dtype="float64",
               decoding_algorithm=DecodingAlgorithm.AOMSA,
               enable_code_rate_adaptation=True,
               r_qber_ranges=(RQBERRange(0.99, 0.05, 0.05, 0.01),))
    comb = SimCombination(0.05, params, ScalingFactors(0.3, 0.6))
    device = run_combination(matrix, comb, cfg, sim_number=0)
    traced = run_combination(
        matrix, comb, dataclasses.replace(cfg, trace_qkd_ldpc=True),
        sim_number=0,
    )
    capsys.readouterr()
    assert device == traced
    assert device.ratio_trials_success_ldpc > 0


def test_two_phase_equals_single_phase(irregular):
    comb = SimCombination(0.06, HMatrixParams(), ScalingFactors(primary=0.8))
    two = run_combination(
        irregular, comb,
        _cfg(trials_number=32, batch_size=32, decoding_alg_max_iterations=64,
             phase1_iterations=4),
        sim_number=0,
    )
    one = run_combination(
        irregular, comb,
        _cfg(trials_number=32, batch_size=32, decoding_alg_max_iterations=64,
             phase1_iterations=0),
        sim_number=0,
    )
    assert two == one
    # Some frames converged only after phase 1's cap: the merge was used.
    assert two.iter_success_max > 4


def test_unconverged_frames_hit_cap(irregular):
    """Frames that never converge report the cap and the decisions of the
    cap-th iteration, exactly as the oracle."""
    rng = np.random.default_rng(37)
    n = irregular.num_bit_nodes
    alice = rng.integers(0, 2, (6, n)).astype(np.int8)
    bob = alice ^ (rng.random((6, n)) < 0.09).astype(np.int8)
    log_p = np.log(0.91 / 0.09)
    llr = np.where(bob == 1, -log_p, log_p)
    syn = np.asarray(calculate_syndrome(layout_for(irregular),
                                        jnp.asarray(alice)))
    res = get_decoder(layout_for(irregular), DecodingAlgorithm.NMSA, 6,
                      False, dtype=jnp.float64)(jnp.asarray(llr),
                                                jnp.asarray(syn), 0.8)
    conv = np.asarray(res.syndromes_match)
    assert not conv.all()
    assert (np.asarray(res.iterations)[~conv] == 6).all()
    for f in range(6):
        d_o, ok_o, it_o = decode_oracle(irregular, llr[f], syn[f], 2, 6, 0.8)
        assert (bool(conv[f]), int(res.iterations[f])) == (ok_o, it_o)
        np.testing.assert_array_equal(np.asarray(res.decision)[f], d_o)


def test_mesh_factory(irregular):
    """Data and reduce modes of the 4-device mesh agree on every
    statistic."""
    from qkd_ldpc_v_tpu.parallel import make_data_mesh, mesh_step_factory

    mesh = make_data_mesh(4)
    cfg = _cfg(phase1_iterations=0)
    comb = SimCombination(0.03, HMatrixParams(), ScalingFactors(primary=0.8))
    data = run_combination(irregular, comb, cfg, sim_number=0,
                           step_factory=mesh_step_factory(mesh))
    reduced = run_combination(
        irregular, comb, cfg, sim_number=0,
        step_factory=mesh_step_factory(mesh, reduce_stats=True),
    )
    assert data.ratio_trials_success_ldpc > 0.5
    for field in ("ratio_trials_success_decoding", "ratio_trials_success_ldpc",
                  "iter_success_min", "iter_success_max"):
        assert getattr(data, field) == getattr(reduced, field)
    assert data.iter_success_mean == pytest.approx(reduced.iter_success_mean)


@pytest.mark.parametrize("alg", list(DecodingAlgorithm), ids=lambda a: a.name)
def test_bfloat16_messages_decode(irregular, alg):
    """``dtype: bfloat16`` through the driver still corrects most frames at
    an easy point. SPA in bf16 needs the message clamp (bf16 tanh saturates
    near |LLR| 9, and atanh(1) is infinite)."""
    spa = alg in (DecodingAlgorithm.SPA, DecodingAlgorithm.SPA_APPROX)
    cfg = _cfg(dtype="bfloat16", decoding_algorithm=alg,
               enable_msg_llr_threshold=spa, msg_llr_threshold=8.0,
               r_qber_ranges=(RQBERRange(0.99, 0.02, 0.02, 0.01),))
    factors = {DecodingAlgorithm.NMSA: (0.8, 1.0),
               DecodingAlgorithm.OMSA: (0.3, 1.0),
               DecodingAlgorithm.ANMSA: (0.88, 0.5),
               DecodingAlgorithm.AOMSA: (0.3, 0.6)}.get(alg, (0.0, 0.0))
    comb = SimCombination(0.02, HMatrixParams(), ScalingFactors(*factors))
    res = run_combination(irregular, comb, cfg, sim_number=0)
    assert res.ratio_trials_success_ldpc >= 0.8
