"""Sweep builder, batched trial execution, statistics, and CSV writer tests
(reference semantics: src/simulation.cpp)."""

import numpy as np
import pytest

from qkd_ldpc_v_tpu.config import (
    Config,
    DecodingAlgorithm,
    RQBERRange,
    RAdaptationParametersRange,
    RScalingFactorMap,
    ScalingFactorParams,
    ScalingFactorRange,
)
from qkd_ldpc_v_tpu.models.generator import generate_regular_ldpc
from qkd_ldpc_v_tpu.models.hmatrix import write_alist
from qkd_ldpc_v_tpu.simulation import (
    SimulationError,
    prepare_sim_inputs,
    process_trials_results,
    qkd_ldpc_batch_simulation,
    rate_based_qber_range,
    rate_based_scaling_factor_value,
    result_filename,
    run_combination,
    write_file,
    SimCombination,
    SimResult,
    ScalingFactors,
)
from qkd_ldpc_v_tpu.rate_adapt import HMatrixParams


def _base_cfg(**kw) -> Config:
    defaults = dict(
        trials_number=64,
        simulation_seed=42,
        decoding_algorithm=DecodingAlgorithm.SPA,
        decoding_alg_max_iterations=50,
        r_qber_ranges=(RQBERRange(0.99, 0.03, 0.03, 0.01),),
    )
    defaults.update(kw)
    return Config(**defaults)


# ---------------------------------------------------------------------------
# Rate-based lookups (reference: src/simulation.cpp:182-368)
# ---------------------------------------------------------------------------


class TestLookups:
    def test_first_rate_geq_wins(self):
        ranges = (
            RQBERRange(0.5, 0.01, 0.01, 0.01),
            RQBERRange(0.7, 0.02, 0.02, 0.01),
            RQBERRange(0.9, 0.03, 0.03, 0.01),
        )
        assert rate_based_qber_range(0.5, ranges) == (0.01,)
        assert rate_based_qber_range(0.6, ranges) == (0.02,)
        assert rate_based_qber_range(0.85, ranges) == (0.03,)

    def test_qber_range_expansion_includes_end(self):
        ranges = (RQBERRange(0.9, 0.01, 0.05, 0.01),)
        vals = rate_based_qber_range(0.5, ranges)
        assert len(vals) == 5
        assert vals[0] == pytest.approx(0.01)
        assert vals[-1] == pytest.approx(0.05)

    def test_no_matching_rate_raises(self):
        ranges = (RQBERRange(0.5, 0.01, 0.01, 0.01),)
        with pytest.raises(SimulationError):
            rate_based_qber_range(0.9, ranges)

    def test_scaling_factor_map_lookup(self):
        maps = (
            RScalingFactorMap(0.5, 0.7),
            RScalingFactorMap(0.8, 0.9),
        )
        assert rate_based_scaling_factor_value(0.4, maps) == 0.7
        assert rate_based_scaling_factor_value(0.6, maps) == 0.9
        with pytest.raises(SimulationError):
            rate_based_scaling_factor_value(0.85, maps)


# ---------------------------------------------------------------------------
# Sweep builder (C18)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def matrix_file(tmp_path_factory):
    mat = generate_regular_ldpc(num_bits=128, num_checks=64, column_weight=3, seed=11)
    path = tmp_path_factory.mktemp("mats") / "(N=128,M=64).mtrx"
    write_alist(mat, path)
    return path


class TestPrepareSimInputs:
    def test_fixed_rate_qber_sweep(self, matrix_file):
        cfg = _base_cfg(
            matrix_format=1,
            r_qber_ranges=(RQBERRange(0.9, 0.01, 0.03, 0.01),),
        )
        inputs = prepare_sim_inputs([matrix_file], cfg)
        assert len(inputs) == 1
        assert len(inputs[0].combinations) == 3
        assert [c.config_qber for c in inputs[0].combinations] == pytest.approx(
            [0.01, 0.02, 0.03]
        )
        assert all(c.matrix_params.is_empty for c in inputs[0].combinations)

    def test_scaling_cross_nmsa_range(self, matrix_file):
        cfg = _base_cfg(
            matrix_format=1,
            decoding_algorithm=DecodingAlgorithm.NMSA,
            primary=ScalingFactorParams(
                use_range=True, range=ScalingFactorRange(0.5, 0.9, 0.1)
            ),
            r_qber_ranges=(RQBERRange(0.9, 0.02, 0.03, 0.01),),
        )
        inputs = prepare_sim_inputs([matrix_file], cfg)
        combos = inputs[0].combinations
        assert len(combos) == 2 * 5  # 2 QBER x 5 alpha
        assert combos[0].scaling_factors.primary == pytest.approx(0.5)
        assert combos[4].scaling_factors.primary == pytest.approx(0.9)

    def test_adaptive_cross_product(self, matrix_file):
        cfg = _base_cfg(
            matrix_format=1,
            decoding_algorithm=DecodingAlgorithm.ANMSA,
            primary=ScalingFactorParams(
                use_range=True, range=ScalingFactorRange(0.8, 0.9, 0.1)
            ),
            secondary=ScalingFactorParams(
                use_range=True, range=ScalingFactorRange(0.3, 0.5, 0.1)
            ),
        )
        inputs = prepare_sim_inputs([matrix_file], cfg)
        combos = inputs[0].combinations
        assert len(combos) == 2 * 3  # alpha x nu
        pairs = {(round(c.scaling_factors.primary, 3), round(c.scaling_factors.secondary, 3))
                 for c in combos}
        assert len(pairs) == 6

    def test_rate_adaptation_ranges(self, matrix_file):
        cfg = _base_cfg(
            matrix_format=1,
            enable_code_rate_adaptation=True,
            use_adaptation_parameters_ranges=True,
            r_qber_ranges=(RQBERRange(0.9, 0.08, 0.08, 0.01),),
            r_adapt_params_ranges=(
                RAdaptationParametersRange(
                    code_rate=0.9,
                    delta_begin=0.1, delta_end=0.1, delta_step=0.1,
                    efficiency_begin=1.2, efficiency_end=1.4, efficiency_step=0.2,
                ),
            ),
        )
        inputs = prepare_sim_inputs([matrix_file], cfg)
        combos = inputs[0].combinations
        # R0 = 0.5, QBER = 0.02 -> some (delta, f_EC) points are achievable
        assert len(combos) >= 1
        for c in combos:
            mp = c.matrix_params
            assert not mp.is_empty
            assert len(mp.bits_to_remove) == len(mp.punctured_bits) + len(
                mp.shortened_bits
            )
            # frame bookkeeping: p + s + n = N
            assert len(mp.punctured_bits) + len(mp.shortened_bits) < 128

    def test_deterministic_given_seed(self, matrix_file):
        cfg = _base_cfg(
            matrix_format=1,
            enable_code_rate_adaptation=True,
            use_adaptation_parameters_ranges=True,
            r_qber_ranges=(RQBERRange(0.9, 0.08, 0.08, 0.01),),
            r_adapt_params_ranges=(
                RAdaptationParametersRange(
                    code_rate=0.9,
                    delta_begin=0.1, delta_end=0.1, delta_step=0.1,
                    efficiency_begin=1.2, efficiency_end=1.2, efficiency_step=0.1,
                ),
            ),
        )
        a = prepare_sim_inputs([matrix_file], cfg)
        b = prepare_sim_inputs([matrix_file], cfg)
        pa = a[0].combinations[0].matrix_params
        pb = b[0].combinations[0].matrix_params
        np.testing.assert_array_equal(pa.punctured_bits, pb.punctured_bits)
        np.testing.assert_array_equal(pa.shortened_bits, pb.shortened_bits)


# ---------------------------------------------------------------------------
# Batched execution + statistics
# ---------------------------------------------------------------------------


class TestRunCombination:
    def test_low_qber_mostly_succeeds(self, medium_matrix):
        medium_matrix.source_path = None
        cfg = _base_cfg(trials_number=32)
        comb = SimCombination(0.02, HMatrixParams(), ScalingFactors())
        res = run_combination(medium_matrix, comb, cfg, sim_number=0)
        assert res.ratio_trials_success_decoding > 0.8
        assert res.ratio_trials_success_ldpc > 0.8
        assert res.accurate_qber == pytest.approx(
            int(512 * 0.02) / 512
        )
        assert 0 < res.iter_success_mean <= 50
        assert res.iter_success_min <= res.iter_success_max

    def test_high_qber_mostly_fails(self, medium_matrix):
        cfg = _base_cfg(trials_number=16)
        comb = SimCombination(0.2, HMatrixParams(), ScalingFactors())
        res = run_combination(medium_matrix, comb, cfg, sim_number=0)
        assert res.ratio_trials_success_ldpc < 0.5

    def test_qber_too_small_raises(self, medium_matrix):
        cfg = _base_cfg(trials_number=4)
        comb = SimCombination(0.0005, HMatrixParams(), ScalingFactors())
        with pytest.raises(SimulationError, match="too small"):
            run_combination(medium_matrix, comb, cfg, sim_number=0)

    def test_chunked_equals_single_batch(self, medium_matrix):
        """Chunking changes only wall-clock, not which trials run: seeds are
        per-chunk, so compare aggregate behaviour with identical chunking."""
        cfg1 = _base_cfg(trials_number=32, batch_size=32)
        cfg2 = _base_cfg(trials_number=32, batch_size=32)
        comb = SimCombination(0.02, HMatrixParams(), ScalingFactors())
        r1 = run_combination(medium_matrix, comb, cfg1, sim_number=0)
        r2 = run_combination(medium_matrix, comb, cfg2, sim_number=0)
        assert r1.ratio_trials_success_ldpc == r2.ratio_trials_success_ldpc
        assert r1.iter_success_mean == r2.iter_success_mean

    def test_rate_adaptive_combination_runs(self, matrix_file):
        cfg = _base_cfg(
            trials_number=16,
            matrix_format=1,
            enable_code_rate_adaptation=True,
            use_adaptation_parameters_ranges=True,
            r_qber_ranges=(RQBERRange(0.9, 0.08, 0.08, 0.01),),
            r_adapt_params_ranges=(
                RAdaptationParametersRange(
                    code_rate=0.9,
                    delta_begin=0.1, delta_end=0.1, delta_step=0.1,
                    efficiency_begin=1.3, efficiency_end=1.3, efficiency_step=0.1,
                ),
            ),
        )
        inputs = prepare_sim_inputs([matrix_file], cfg)
        assert inputs[0].combinations, "no achievable rate-adapt combination"
        results = qkd_ldpc_batch_simulation(inputs, cfg)
        assert len(results) == len(inputs[0].combinations)
        r = results[0]
        assert r.adapted_code_rate > 0
        assert 0.0 <= r.ratio_trials_success_ldpc <= 1.0


class TestProcessTrialsResults:
    def test_iteration_stats_only_over_successful(self):
        cfg = _base_cfg(trials_number=4)
        res = SimResult()
        syn = np.array([True, True, False, False])
        keys = np.array([True, False, False, False])
        iters = np.array([3, 5, 50, 50])
        process_trials_results(cfg, syn, keys, iters, None, 100, res)
        assert res.iter_success_mean == pytest.approx(4.0)
        assert res.iter_success_min == 3
        assert res.iter_success_max == 5
        assert res.iter_success_std == pytest.approx(1.0)
        assert res.ratio_trials_success_decoding == pytest.approx(0.5)
        assert res.ratio_trials_success_ldpc == pytest.approx(0.25)

    def test_no_success_zeroes(self):
        cfg = _base_cfg(trials_number=2)
        res = SimResult()
        process_trials_results(
            cfg,
            np.array([False, False]),
            np.array([False, False]),
            np.array([50, 50]),
            None,
            100,
            res,
        )
        assert res.iter_success_mean == 0.0
        assert res.iter_success_min == 0
        assert res.iter_success_max == 0

    def test_throughput_with_rtt(self):
        cfg = _base_cfg(
            trials_number=2,
            enable_throughput_measurement=True,
            consider_rtt=True,
            rtt_ms=1.0,
        )
        res = SimResult()
        runtimes = np.array([1000.0, 1000.0])  # 1 ms decode + 1 ms RTT
        process_trials_results(
            cfg,
            np.array([True, True]),
            np.array([True, True]),
            np.array([1, 1]),
            runtimes,
            1000,
            res,
        )
        # 1000 bits / 2 ms = 500_000 bits/s
        assert res.throughput_mean == 500_000
        assert res.throughput_std == 0


# ---------------------------------------------------------------------------
# CSV writer (C22)
# ---------------------------------------------------------------------------


class TestWriteFile:
    def _result(self):
        return SimResult(
            sim_number=0,
            matrix_filename="m.mtrx",
            is_regular=True,
            num_bit_nodes=128,
            num_check_nodes=64,
            config_qber=0.03,
            accurate_qber=0.0293,
            iter_success_mean=4.5,
            iter_success_std=1.25,
            iter_success_min=2,
            iter_success_max=9,
            ratio_trials_success_decoding=0.75,
            ratio_trials_success_ldpc=0.5,
            scaling_factors=ScalingFactors(0.72, 0.31),
        )

    def test_base_columns_and_comma_decimals(self, tmp_path):
        cfg = _base_cfg(trials_number=4)
        path = write_file([self._result()], cfg, "00h-00m-01s", tmp_path)
        lines = path.read_text().splitlines()
        header = lines[0].split(";")
        assert header[:6] == ["#", "MATRIX_FILENAME", "TYPE", "R", "M", "N"]
        assert header[-1] == "FER"
        row = lines[1].split(";")
        assert len(row) == len(header)
        assert row[3] == "0,500"  # R with comma decimal
        assert row[6] == "0,0300"
        # FER = 1 - 0.5 rounded to 1/4 granularity
        assert row[-1] == "0,5"

    def test_filename_encodes_run(self, tmp_path):
        cfg = _base_cfg(trials_number=4)
        name = result_filename(cfg, "00h-00m-01s")
        assert "trial_num=4" in name
        assert "dec_alg=SPA" in name
        assert "rate_adapt=OFF" in name
        assert "seed=42" in name

    def test_collision_suffix(self, tmp_path):
        cfg = _base_cfg(trials_number=4)
        p1 = write_file([self._result()], cfg, "00h-00m-01s", tmp_path)
        p2 = write_file([self._result()], cfg, "00h-00m-01s", tmp_path)
        assert p1 != p2
        assert p2.stem.endswith("_1")

    def test_scaling_and_throughput_columns(self, tmp_path):
        cfg = _base_cfg(
            trials_number=4,
            decoding_algorithm=DecodingAlgorithm.AOMSA,
            enable_throughput_measurement=True,
        )
        path = write_file([self._result()], cfg, "00h-00m-01s", tmp_path)
        lines = path.read_text().splitlines()
        header = lines[0]
        assert header.endswith(
            "THROUGHPUT_MEAN;THROUGHPUT_STD;THROUGHPUT_MIN;THROUGHPUT_MAX;"
            "BETA;SIGMA"
        )
        row = lines[1].split(";")
        assert row[-2] == "0,720"
        assert row[-1] == "0,310"

    def test_rate_adapt_block(self, tmp_path):
        cfg = _base_cfg(trials_number=4, enable_code_rate_adaptation=True)
        path = write_file([self._result()], cfg, "00h-00m-01s", tmp_path)
        header = path.read_text().splitlines()[0]
        assert ";DELTA;EFFICIENCY;PUNCT_FRACTION;SHORT_FRACTION;R_ADAPTED" in header


class TestTwoPhase:
    def test_two_phase_bit_identical_to_single_phase(self, medium_matrix):
        """Phase-1 cap + straggler re-decode must reproduce the single-run
        results exactly (BP from the same init is deterministic)."""
        comb = SimCombination(0.045, HMatrixParams(), ScalingFactors())
        base = dict(
            trials_number=64,
            simulation_seed=3,
            decoding_algorithm=DecodingAlgorithm.SPA,
            decoding_alg_max_iterations=64,
            r_qber_ranges=(RQBERRange(0.99, 0.045, 0.045, 0.01),),
        )
        # phase-1 cap of 3 sits below the typical convergence iteration
        # (mean ~4, max ~7 at this operating point), so stragglers include
        # frames that succeed in phase 2 — the interesting merge case.
        cfg_two = Config(**base, phase1_iterations=3)
        cfg_one = Config(**base, phase1_iterations=0)
        r_two = run_combination(medium_matrix, comb, cfg_two, sim_number=0)
        r_one = run_combination(medium_matrix, comb, cfg_one, sim_number=0)
        assert r_two.ratio_trials_success_decoding == r_one.ratio_trials_success_decoding
        assert r_two.ratio_trials_success_ldpc == r_one.ratio_trials_success_ldpc
        assert r_two.iter_success_mean == r_one.iter_success_mean
        assert r_two.iter_success_min == r_one.iter_success_min
        assert r_two.iter_success_max == r_one.iter_success_max

    def test_auto_phase1_resolution(self):
        from qkd_ldpc_v_tpu.simulation import resolve_phase1_cap

        assert resolve_phase1_cap(_base_cfg(decoding_alg_max_iterations=100)) == 50
        assert resolve_phase1_cap(_base_cfg(decoding_alg_max_iterations=50)) == 0
        assert resolve_phase1_cap(
            _base_cfg(decoding_alg_max_iterations=100, phase1_iterations=0)
        ) == 0
        assert resolve_phase1_cap(
            _base_cfg(decoding_alg_max_iterations=100, phase1_iterations=20)
        ) == 20


class TestCheckpointResume:
    def test_resume_skips_completed(self, matrix_file, tmp_path):
        from qkd_ldpc_v_tpu.simulation import (
            load_checkpoint,
            qkd_ldpc_batch_simulation,
            _campaign_fingerprint,
        )

        cfg = _base_cfg(
            trials_number=8,
            matrix_format=1,
            r_qber_ranges=(RQBERRange(0.9, 0.02, 0.04, 0.01),),
        )
        inputs = prepare_sim_inputs([matrix_file], cfg)
        ckpt = tmp_path / "run.checkpoint.json"

        # Simulate a crash after the first combination: run it manually and
        # checkpoint.
        from qkd_ldpc_v_tpu.simulation import run_combination, save_checkpoint

        first = run_combination(inputs[0].matrix, inputs[0].combinations[0], cfg, 0)
        first.matrix_filename = inputs[0].matrix_path.name
        fp = _campaign_fingerprint(inputs, cfg)
        save_checkpoint(ckpt, fp, [first])
        assert len(load_checkpoint(ckpt, fp)) == 1

        calls = []
        results = qkd_ldpc_batch_simulation(
            inputs, cfg,
            progress=lambda inc, total: calls.append(inc),
            checkpoint_path=ckpt,
        )
        assert len(results) == 3
        # first combination restored, not re-run: first progress callback is
        # the bulk restore of 1 combination's trials
        assert calls[0] == 8
        assert results[0].config_qber == first.config_qber
        assert results[0].ratio_trials_success_ldpc == first.ratio_trials_success_ldpc
        # checkpoint is left for the caller to remove after results land
        assert ckpt.exists()

    def test_changed_sweep_values_invalidate_checkpoint(self, matrix_file, tmp_path):
        """Editing sweep parameters (same combination count) must not resume
        from the stale checkpoint."""
        from qkd_ldpc_v_tpu.simulation import _campaign_fingerprint

        cfg_a = _base_cfg(
            trials_number=4, matrix_format=1,
            r_qber_ranges=(RQBERRange(0.9, 0.02, 0.04, 0.01),),
        )
        cfg_b = _base_cfg(
            trials_number=4, matrix_format=1,
            r_qber_ranges=(RQBERRange(0.9, 0.05, 0.07, 0.01),),
        )
        fa = _campaign_fingerprint(prepare_sim_inputs([matrix_file], cfg_a), cfg_a)
        fb = _campaign_fingerprint(prepare_sim_inputs([matrix_file], cfg_b), cfg_b)
        assert fa != fb

    def test_mismatched_fingerprint_ignored(self, matrix_file, tmp_path):
        from qkd_ldpc_v_tpu.simulation import load_checkpoint, save_checkpoint

        ckpt = tmp_path / "c.json"
        save_checkpoint(ckpt, "aaaa", [SimResult(sim_number=0)])
        assert load_checkpoint(ckpt, "bbbb") == []
        assert len(load_checkpoint(ckpt, "aaaa")) == 1


class TestDriverEdgeCases:
    def test_privacy_plus_rate_adapt_through_driver(self, matrix_file):
        """Privacy maintenance on top of rate adaptation: the out-key length
        and the stats pipeline stay consistent."""
        cfg = _base_cfg(
            trials_number=8,
            matrix_format=1,
            enable_privacy_maintenance=True,
            enable_code_rate_adaptation=True,
            use_adaptation_parameters_ranges=True,
            enable_throughput_measurement=True,
            r_qber_ranges=(RQBERRange(0.9, 0.08, 0.08, 0.01),),
            r_adapt_params_ranges=(
                RAdaptationParametersRange(
                    code_rate=0.9,
                    delta_begin=0.1, delta_end=0.1, delta_step=0.1,
                    efficiency_begin=1.2, efficiency_end=1.2, efficiency_step=0.1,
                ),
            ),
        )
        inputs = prepare_sim_inputs([matrix_file], cfg)
        assert inputs[0].combinations
        mp = inputs[0].combinations[0].matrix_params
        # privacy adds removals beyond punctured+shortened
        assert len(mp.bits_to_remove) > len(mp.punctured_bits) + len(mp.shortened_bits)
        results = qkd_ldpc_batch_simulation(inputs, cfg)
        assert results[0].throughput_mean > 0

    def test_trials_not_multiple_of_batch(self, medium_matrix):
        cfg = _base_cfg(trials_number=23, batch_size=8)
        comb = SimCombination(0.02, HMatrixParams(), ScalingFactors())
        res = run_combination(medium_matrix, comb, cfg, sim_number=0)
        assert 0.0 <= res.ratio_trials_success_ldpc <= 1.0

    def test_multiple_scaling_factors_share_one_step(self, medium_matrix):
        """Sweeping alpha must not recompile: same step object reused."""
        from qkd_ldpc_v_tpu.simulation import _STEP_CACHE, get_step

        cfg = _base_cfg(trials_number=8, decoding_algorithm=DecodingAlgorithm.NMSA)
        before = len(_STEP_CACHE)
        for alpha in (0.7, 0.8, 0.9):
            comb = SimCombination(0.02, HMatrixParams(), ScalingFactors(primary=alpha))
            run_combination(medium_matrix, comb, cfg, sim_number=0)
        assert len(_STEP_CACHE) <= before + 2  # phase1 + phase2 tier at most
