"""End-to-end CLI test: config dir + matrix dir -> CSV results
(reference contract: src/main.cpp:157-189)."""

import json

import pytest

from qkd_ldpc_v_tpu.cli import main
from qkd_ldpc_v_tpu.models.generator import generate_regular_ldpc
from qkd_ldpc_v_tpu.models.hmatrix import write_alist


def _reference_schema_config(**overrides):
    cfg = {
        "threads_number": 1,
        "trials_number": 8,
        "use_config_simulation_seed": True,
        "simulation_seed": 7,
        "enable_privacy_maintenance": False,
        "enable_throughput_measurement": True,
        "throughput_measurement_parameters": {"consider_RTT": True, "RTT": 0.4},
        "decoding_algorithm": 0,
        "decoding_algorithm_max_iterations": 30,
        "matrix_format": 1,
        "trace_qkd_ldpc": False,
        "trace_decoding_algorithm": False,
        "trace_decoding_algorithm_llr": False,
        "enable_decoding_algorithm_msg_llr_threshold": False,
        "code_rate_QBER_ranges": [
            {"code_rate": 0.9, "QBER": {"begin": 0.02, "end": 0.03, "step": 0.01}}
        ],
        "enable_code_rate_adaptation": False,
    }
    cfg.update(overrides)
    return cfg


@pytest.fixture
def workspace(tmp_path):
    configs = tmp_path / "configs"
    matrices = tmp_path / "sparse_matrices" / "matrices_alist"
    results = tmp_path / "results"
    configs.mkdir(parents=True)
    matrices.mkdir(parents=True)
    (configs / "run.json").write_text(json.dumps(_reference_schema_config()))
    mat = generate_regular_ldpc(num_bits=128, num_checks=64, column_weight=3, seed=5)
    write_alist(mat, matrices / "(N=128,M=64).mtrx")
    return tmp_path


def test_cli_end_to_end(workspace, capsys):
    rc = main(
        [
            "--configs", str(workspace / "configs"),
            "--matrices", str(workspace / "sparse_matrices"),
            "--results", str(workspace / "results"),
            "--quiet",
        ]
    )
    out = capsys.readouterr().out
    assert rc == 0, out
    csvs = list((workspace / "results").glob("*.csv"))
    assert len(csvs) == 1
    lines = csvs[0].read_text().splitlines()
    assert len(lines) == 3  # header + 2 QBER points
    assert "THROUGHPUT_MEAN" in lines[0]
    assert "CONFIG #1 INFO" in out
    assert "successfully completed" in out


def test_cli_missing_configs_dir(tmp_path, capsys):
    rc = main(["--configs", str(tmp_path / "nope")])
    assert rc == 1
    assert "ERROR" in capsys.readouterr().err


def test_cli_help_config(capsys):
    rc = main(["--help-config"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "decoding_algorithm" in out
    assert "matrix_format" in out
    # The retired engine keys are not part of the schema any more.
    assert "use_pallas" not in out and "force_engine" not in out
