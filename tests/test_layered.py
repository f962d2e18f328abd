"""The layered (serial-C) QC decoder (ops/qc_decoder.py) against its NumPy
specification (oracle.layered_oracle), and the driver's routing to it.

The decoder must equal the oracle bit for bit: decisions, iteration counts
and convergence flags, for the four min-sum algorithms."""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qkd_ldpc_v_tpu.config import Config, DecodingAlgorithm, RQBERRange
from qkd_ldpc_v_tpu.models.layout import layout_for
from qkd_ldpc_v_tpu.models.qc import generate_qc_ldpc, generate_qc_peg
from qkd_ldpc_v_tpu.ops.channel import (
    calculate_syndrome,
    exact_error_count,
    generate_keys,
    inject_errors,
    trial_keys,
)
from qkd_ldpc_v_tpu.ops.qc_decoder import make_qc_decoder
from qkd_ldpc_v_tpu.rate_adapt import ALMOST_ZERO, HMatrixParams
from qkd_ldpc_v_tpu.simulation import (
    ScalingFactors,
    SimCombination,
    run_combination,
)
from tests.oracle import layered_oracle

MIN_SUM = [
    (DecodingAlgorithm.NMSA, 0.8, 1.0),
    (DecodingAlgorithm.OMSA, 0.3, 1.0),
    (DecodingAlgorithm.ANMSA, 0.88, 0.5),
    (DecodingAlgorithm.AOMSA, 0.3, 0.6),
]

CODES = {
    # Equal row degrees, Z = 128.
    "z128": lambda: generate_qc_ldpc(8, 4, 128, column_weight=3, seed=5),
    # QC-PEG with unequal row degrees (7, 8, 8, 7): padded row slots.
    "peg_rows_7_8": lambda: generate_qc_peg(10, 4, 64, 3, seed=1),
    # A lifting that is not a power of two, row degrees (7, 7, 6, 7).
    "z96": lambda: generate_qc_peg(9, 4, 96, 3, seed=3),
}


@pytest.fixture(scope="module", params=sorted(CODES))
def qc(request):
    return CODES[request.param]()


def _channel(qc, frames, qber, seed):
    rng = np.random.default_rng(seed)
    n = qc.num_bit_nodes
    alice = rng.integers(0, 2, (frames, n)).astype(np.int8)
    bob = alice ^ (rng.random((frames, n)) < qber).astype(np.int8)
    log_p = np.float32(np.log((1 - qber) / qber))
    llr = np.where(bob == 1, -log_p, log_p).astype(np.float32)
    syn = np.asarray(calculate_syndrome(layout_for(qc.to_hmatrix()),
                                        jnp.asarray(alice)))
    return alice, llr, syn


def _assert_matches_oracle(qc, res, llr, syn, alg, p, s, cap, threshold):
    for f in range(llr.shape[0]):
        d_o, it_o, ok_o = layered_oracle(qc, llr[f], syn[f], alg, p, cap,
                                         secondary=s, threshold=threshold)
        assert bool(np.asarray(res.syndromes_match)[f]) == ok_o, f
        assert int(np.asarray(res.iterations)[f]) == it_o, f
        np.testing.assert_array_equal(np.asarray(res.decision)[f], d_o)


@pytest.mark.parametrize("alg,p,s", MIN_SUM, ids=lambda v: getattr(v, "name", None))
@pytest.mark.parametrize("threshold", [None, 2.5], ids=["no_clamp", "clamp"])
def test_matches_oracle(qc, alg, p, s, threshold):
    # QBER 0.05 with a tight clamp leaves some frames unconverged at the
    # cap, so unconverged decisions are compared too.
    alice, llr, syn = _channel(qc, 6, 0.05, seed=int(alg))
    dec = jax.jit(make_qc_decoder(qc, alg, 30, threshold is not None,
                                  schedule="layered"))
    res = dec(llr, syn, p, s, 0.0 if threshold is None else threshold)
    _assert_matches_oracle(qc, res, llr, syn, alg, p, s, 30, threshold)


@pytest.mark.parametrize("alg,p,s", MIN_SUM, ids=lambda v: getattr(v, "name", None))
def test_rate_adapted_llrs(alg, p, s):
    """Punctured (LLR ~ 0) and shortened (LLR = float32 max) positions, as
    the driver builds them for rate adaptation."""
    qc = generate_qc_ldpc(8, 4, 128, column_weight=3, seed=5)
    alice, llr, syn = _channel(qc, 6, 0.03, seed=40 + int(alg))
    rng = np.random.default_rng(41)
    n = qc.num_bit_nodes
    pos = rng.permutation(n)
    punct, short = pos[:40], pos[40:80]
    alice[:, short] = 0
    llr[:, punct] = np.float32(ALMOST_ZERO)
    llr[:, short] = np.finfo(np.float32).max
    syn = np.asarray(calculate_syndrome(layout_for(qc.to_hmatrix()),
                                        jnp.asarray(alice)))
    dec = jax.jit(make_qc_decoder(qc, alg, 30, False, schedule="layered"))
    res = dec(llr, syn, p, s, 0.0)
    _assert_matches_oracle(qc, res, llr, syn, alg, p, s, 30, None)
    assert np.asarray(res.syndromes_match).any()


def test_converges_in_fewer_sweeps():
    """The point of the mode: fewer sweeps than flooding on the same frames,
    and the converged frames recover Alice's keys."""
    qc = generate_qc_ldpc(8, 4, 128, column_weight=3, seed=5)
    alice, llr, syn = _channel(qc, 8, 0.04, seed=0)
    flood = jax.jit(make_qc_decoder(qc, DecodingAlgorithm.NMSA, 30, False))
    lay = jax.jit(make_qc_decoder(qc, DecodingAlgorithm.NMSA, 30, False,
                                  schedule="layered"))
    rf = flood(llr, syn, 0.8, 1.0, 0.0)
    rl = lay(llr, syn, 0.8, 1.0, 0.0)
    assert np.asarray(rl.syndromes_match).all()
    assert np.asarray(rl.iterations).mean() < np.asarray(rf.iterations).mean()
    np.testing.assert_array_equal(np.asarray(rl.decision), alice)


@pytest.mark.parametrize("alg", [DecodingAlgorithm.SPA,
                                 DecodingAlgorithm.SPA_APPROX])
def test_rejects_spa(alg):
    qc = generate_qc_ldpc(8, 4, 128, column_weight=3, seed=5)
    with pytest.raises(ValueError, match="layered"):
        make_qc_decoder(qc, alg, 30, False, schedule="layered")


@pytest.mark.parametrize("batch", [1, 5, 8])
def test_odd_batches(batch):
    """Any batch size decodes each frame as it would in a batch of 8."""
    qc = generate_qc_peg(10, 4, 64, 3, seed=1)
    alice, llr, syn = _channel(qc, 8, 0.04, seed=9)
    dec = jax.jit(make_qc_decoder(qc, DecodingAlgorithm.OMSA, 30, False,
                                  schedule="layered"))
    full = dec(llr, syn, 0.3, 1.0, 0.0)
    part = dec(llr[:batch], syn[:batch], 0.3, 1.0, 0.0)
    assert part.decision.shape == (batch, qc.num_bit_nodes)
    for a, b in zip(part, full):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b)[:batch])


def _layered_cfg(alg, **extra):
    return Config(
        trials_number=8,
        simulation_seed=3,
        decoding_algorithm=alg,
        decoding_alg_max_iterations=30,
        r_qber_ranges=(RQBERRange(0.99, 0.04, 0.04, 0.01),),
        batch_size=8,
        schedule="layered",
        **extra,
    )


@pytest.mark.parametrize("alg,p,s", MIN_SUM, ids=lambda v: getattr(v, "name", None))
def test_driver_routes_layered_qc(alg, p, s, monkeypatch):
    """run_combination with schedule=layered on a QC matrix decodes through
    the layered decoder: its statistics equal the oracle's on the driver's
    own channel realization."""
    from qkd_ldpc_v_tpu import simulation

    calls = []
    real = simulation.make_qc_decoder

    def spy(*args, **kwargs):
        calls.append(kwargs.get("schedule"))
        return real(*args, **kwargs)

    monkeypatch.setattr(simulation, "make_qc_decoder", spy)
    monkeypatch.setattr(simulation, "_STEP_CACHE", type(simulation._STEP_CACHE)())
    qc = generate_qc_peg(10, 4, 64, 3, seed=1)
    matrix = qc.to_hmatrix()
    cfg = _layered_cfg(alg)
    res = run_combination(
        matrix, SimCombination(0.04, HMatrixParams(), ScalingFactors(p, s)),
        cfg, sim_number=0,
    )
    assert calls == ["layered"]

    n = matrix.num_bit_nodes
    ne = exact_error_count(n, 0.04)
    ka, ke, _ = trial_keys(cfg.simulation_seed, 0, 0)
    alice = np.asarray(generate_keys(ka, 8, n))
    bob = np.asarray(inject_errors(ke, jnp.asarray(alice), ne))
    # The driver's LLR arithmetic: float32 log on the device.
    q = jnp.float32(ne / n)
    log_p = np.float32(jnp.log((1.0 - q) / q))
    llr = np.where(bob == 1, -log_p, log_p).astype(np.float32)
    syn = np.asarray(calculate_syndrome(layout_for(matrix), jnp.asarray(alice)))
    oks, iters, keys = [], [], []
    for f in range(8):
        d, it, ok = layered_oracle(qc, llr[f], syn[f], alg, p, 30,
                                   secondary=s)
        oks.append(ok)
        iters.append(it)
        keys.append(ok and np.array_equal(d, alice[f]))
    assert res.ratio_trials_success_decoding == np.mean(oks)
    assert res.ratio_trials_success_ldpc == np.mean(keys)
    if any(oks):
        assert res.iter_success_mean == pytest.approx(
            np.mean([i for i, o in zip(iters, oks) if o]))


def test_driver_spa_layered_warns_and_floods(caplog):
    """SPA + layered: the driver warns and runs the flooding schedule, so the
    result equals a flooding run."""
    qc = generate_qc_ldpc(8, 4, 128, column_weight=3, seed=5)
    matrix = qc.to_hmatrix()
    comb = SimCombination(0.02, HMatrixParams(), ScalingFactors())
    with caplog.at_level(logging.WARNING, logger="qkd_ldpc_v_tpu"):
        lay = run_combination(matrix, comb, _layered_cfg(DecodingAlgorithm.SPA),
                              sim_number=0)
    assert any("layered" in r.message for r in caplog.records)
    flood_cfg = dataclasses.replace(_layered_cfg(DecodingAlgorithm.SPA),
                                    schedule="flooding")
    flood = run_combination(matrix, comb, flood_cfg, sim_number=0)
    assert lay == flood


def test_mesh_factory_runs_layered():
    """The data mesh composes with the layered decoder: every device runs
    the layered step on its shard, in data and reduce modes alike."""
    from qkd_ldpc_v_tpu.parallel import make_data_mesh, mesh_step_factory

    matrix = generate_qc_peg(10, 4, 64, 3, seed=1).to_hmatrix()
    cfg = _layered_cfg(DecodingAlgorithm.NMSA, phase1_iterations=0)
    cfg = dataclasses.replace(cfg, trials_number=16, batch_size=16)
    mesh = make_data_mesh(4)
    comb = SimCombination(0.03, HMatrixParams(), ScalingFactors(primary=0.8))
    data = run_combination(matrix, comb, cfg, sim_number=0,
                           step_factory=mesh_step_factory(mesh))
    reduced = run_combination(
        matrix, comb, cfg, sim_number=0,
        step_factory=mesh_step_factory(mesh, reduce_stats=True),
    )
    assert data.ratio_trials_success_ldpc > 0.9
    assert data.ratio_trials_success_ldpc == reduced.ratio_trials_success_ldpc
    assert data.iter_success_mean == pytest.approx(reduced.iter_success_mean)
