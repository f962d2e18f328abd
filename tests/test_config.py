"""Config parser tests: schema keys, validation rules, and the reference's
active config file."""

import json
import os

import pytest

from qkd_ldpc_v_tpu.config import (
    Config,
    ConfigError,
    DecodingAlgorithm,
    MatrixFormat,
    format_config_info,
    parse_config_data,
)
from tests.conftest import REFERENCE_DIR, reference_available


def minimal_config(**overrides):
    cfg = {
        "threads_number": 1,
        "trials_number": 10,
        "use_config_simulation_seed": True,
        "simulation_seed": 42,
        "enable_privacy_maintenance": False,
        "enable_throughput_measurement": False,
        "decoding_algorithm": 0,
        "decoding_algorithm_max_iterations": 100,
        "matrix_format": 0,
        "trace_qkd_ldpc": False,
        "trace_decoding_algorithm": False,
        "trace_decoding_algorithm_llr": False,
        "enable_decoding_algorithm_msg_llr_threshold": False,
        "code_rate_QBER_ranges": [
            {"code_rate": 0.5, "QBER": {"begin": 0.01, "end": 0.05, "step": 0.01}}
        ],
        "enable_code_rate_adaptation": False,
    }
    cfg.update(overrides)
    return cfg


def write_cfg(tmp_path, cfg, name="c.json"):
    p = tmp_path / name
    p.write_text(json.dumps(cfg))
    return p


def test_minimal_parses(tmp_path):
    c = parse_config_data(write_cfg(tmp_path, minimal_config()))
    assert isinstance(c, Config)
    assert c.simulation_seed == 42
    assert c.decoding_algorithm == DecodingAlgorithm.SPA
    assert c.matrix_format == MatrixFormat.UNCOMPRESSED
    assert len(c.r_qber_ranges) == 1
    assert c.r_qber_ranges[0].qber_values() == pytest.approx(
        (0.01, 0.02, 0.03, 0.04, 0.05)
    )


def test_requires_json_extension(tmp_path):
    p = tmp_path / "c.txt"
    p.write_text("{}")
    with pytest.raises(ConfigError, match="json extension"):
        parse_config_data(p)


def test_missing_file(tmp_path):
    with pytest.raises(ConfigError, match="not found"):
        parse_config_data(tmp_path / "nope.json")


def test_bad_trials(tmp_path):
    with pytest.raises(ConfigError, match="trials must be >= 1"):
        parse_config_data(write_cfg(tmp_path, minimal_config(trials_number=0)))


def test_bad_algorithm(tmp_path):
    with pytest.raises(ConfigError, match="six options"):
        parse_config_data(write_cfg(tmp_path, minimal_config(decoding_algorithm=6)))


def test_bad_qber_range(tmp_path):
    cfg = minimal_config(
        code_rate_QBER_ranges=[
            {"code_rate": 0.5, "QBER": {"begin": 0.05, "end": 0.01, "step": 0.01}}
        ]
    )
    with pytest.raises(ConfigError, match="Invalid QBER"):
        parse_config_data(write_cfg(tmp_path, cfg))


def test_qber_step_too_large(tmp_path):
    cfg = minimal_config(
        code_rate_QBER_ranges=[
            {"code_rate": 0.5, "QBER": {"begin": 0.01, "end": 0.02, "step": 0.5}}
        ]
    )
    with pytest.raises(ConfigError, match="step is too large"):
        parse_config_data(write_cfg(tmp_path, cfg))


def test_nmsa_maps(tmp_path):
    cfg = minimal_config(
        decoding_algorithm=2,
        min_sum_normalized_parameters={
            "use_alpha_range": False,
            "code_rate_alpha_maps": [
                {"code_rate": 0.7, "alpha": 0.9},
                {"code_rate": 0.5, "alpha": 0.8},
            ],
        },
    )
    c = parse_config_data(write_cfg(tmp_path, cfg))
    # sorted ascending by code rate
    assert c.primary.maps[0].code_rate == 0.5
    assert c.primary.maps[1].scaling_factor == 0.9


def test_anmsa_map_consistency_enforced(tmp_path):
    cfg = minimal_config(
        decoding_algorithm=4,
        adaptive_min_sum_normalized_parameters={
            "use_alpha_range": False,
            "code_rate_alpha_maps": [{"code_rate": 0.5, "alpha": 0.9}],
            "use_nu_range": False,
            "code_rate_nu_maps": [{"code_rate": 0.7, "nu": 0.5}],
        },
    )
    with pytest.raises(ConfigError, match="Mismatch of code_rate"):
        parse_config_data(write_cfg(tmp_path, cfg))


def test_scaling_range_validation(tmp_path):
    cfg = minimal_config(
        decoding_algorithm=2,
        min_sum_normalized_parameters={
            "use_alpha_range": True,
            "alpha_range": {"begin": 0.5, "end": 0.4, "step": 0.1},
        },
    )
    with pytest.raises(ConfigError, match="begin cannot be larger"):
        parse_config_data(write_cfg(tmp_path, cfg))


def test_throughput_and_rtt(tmp_path):
    cfg = minimal_config(
        enable_throughput_measurement=True,
        throughput_measurement_parameters={"consider_RTT": True, "RTT": 0.4},
    )
    c = parse_config_data(write_cfg(tmp_path, cfg))
    assert c.enable_throughput_measurement
    assert c.consider_rtt
    assert c.rtt_ms == 0.4


def test_rate_adaptation_ranges(tmp_path):
    cfg = minimal_config(
        enable_code_rate_adaptation=True,
        code_rate_adaptation_parameters={
            "enable_untainted_puncturing": True,
            "use_adaptation_parameters_ranges": True,
            "code_rate_adaptation_parameters_ranges": [
                {
                    "code_rate": 0.5,
                    "delta": {"begin": 0.05, "end": 0.1, "step": 0.05},
                    "efficiency": {"begin": 1.1, "end": 1.2, "step": 0.1},
                }
            ],
        },
    )
    c = parse_config_data(write_cfg(tmp_path, cfg))
    assert c.enable_untainted_puncturing
    r = c.r_adapt_params_ranges[0]
    assert r.delta_values() == pytest.approx((0.05, 0.1))
    assert r.efficiency_values() == pytest.approx((1.1, 1.2))


def test_efficiency_below_one_rejected(tmp_path):
    cfg = minimal_config(
        enable_code_rate_adaptation=True,
        code_rate_adaptation_parameters={
            "enable_untainted_puncturing": False,
            "use_adaptation_parameters_ranges": False,
            "code_rate_QBER_adaptation_parameters_maps": [
                {"code_rate": 0.5, "QBER": 0.03, "delta": 0.1, "efficiency": 0.9}
            ],
        },
    )
    with pytest.raises(ConfigError, match="f_EC"):
        parse_config_data(write_cfg(tmp_path, cfg))


def test_tpu_extension_block(tmp_path):
    cfg = minimal_config(tpu={"batch_size": 256, "dtype": "float64"})
    c = parse_config_data(write_cfg(tmp_path, cfg))
    assert c.batch_size == 256
    assert c.dtype == "float64"
    assert c.schedule == "flooding"
    assert not hasattr(c, "force_engine")
    assert not hasattr(c, "use_pallas")


def test_tpu_force_engine_validated(tmp_path):
    cfg = minimal_config(tpu={"force_engine": "xla"})
    parse_config_data(write_cfg(tmp_path, cfg))
    bad = minimal_config(tpu={"force_engine": "cuda"})
    with pytest.raises(ConfigError, match="force_engine"):
        parse_config_data(write_cfg(tmp_path, bad))


@pytest.mark.parametrize("value", [True, False])
def test_use_pallas_parses_and_warns(tmp_path, caplog, value):
    """Older configs carry tpu.use_pallas: it still parses, selects
    nothing, and says so once."""
    import logging

    cfg = minimal_config(tpu={"batch_size": 64, "use_pallas": value})
    with caplog.at_level(logging.WARNING, logger="qkd_ldpc_v_tpu"):
        c = parse_config_data(write_cfg(tmp_path, cfg))
    assert c.batch_size == 64
    msgs = [r.getMessage() for r in caplog.records]
    assert len(msgs) == 1 and "use_pallas selects nothing" in msgs[0]


@pytest.mark.parametrize("value", ["", "xla"])
def test_force_engine_xla_accepted(tmp_path, caplog, value):
    import logging

    cfg = minimal_config(tpu={"force_engine": value})
    with caplog.at_level(logging.WARNING, logger="qkd_ldpc_v_tpu"):
        c = parse_config_data(write_cfg(tmp_path, cfg))
    assert c.schedule == "flooding"
    assert not caplog.records


@pytest.mark.parametrize("engine", ["qc", "qc_stream", "generic", "stream"])
def test_force_engine_removed_engines_rejected(tmp_path, engine):
    cfg = minimal_config(tpu={"force_engine": engine})
    with pytest.raises(ConfigError, match="removed") as err:
        parse_config_data(write_cfg(tmp_path, cfg))
    assert repr(engine) in str(err.value)


@pytest.mark.skipif(not reference_available(), reason="reference assets absent")
def test_reference_active_config_parses():
    path = os.path.join(REFERENCE_DIR, "configs", "ADAPTIVE T.json")
    c = parse_config_data(path)
    assert c.decoding_algorithm == DecodingAlgorithm.AOMSA
    assert c.trials_number == 10
    assert c.simulation_seed == 5555
    assert c.enable_code_rate_adaptation
    assert c.enable_untainted_puncturing
    assert not c.use_adaptation_parameters_ranges
    assert c.matrix_format == MatrixFormat.SPARSE_2
    assert c.rtt_ms == 0.4
    assert len(c.r_qber_adapt_params_maps) == 26
    assert c.msg_llr_threshold == 100.0
    banner = format_config_info(c, "ADAPTIVE T.json", 1)
    assert "AOMSA" in banner
