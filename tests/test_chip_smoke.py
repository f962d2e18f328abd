"""chip_smoke.py on the CPU: it refuses to run without a GPU, and each of its
phase functions runs here at a tiny size (the mesh phase on four of the
suite's virtual CPU devices)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke
from qkd_ldpc_v_tpu.models.qc import generate_qc_ldpc

ROOT = Path(__file__).resolve().parents[1]


def test_refuses_cpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "needs a GPU" in out.stderr


TINY_CASES = {
    "layered": chip_smoke.CliCase(
        "tiny layered", "example_qc_layered.json",
        "matrices_qc/(N=1024,M=384,R=0.62,CW=3,Z=128,SEED=33).mtrx", 0.5,
        "tiny sanity bound",
    ),
    "alist": chip_smoke.CliCase(
        "tiny alist", "campaign_fer_sweep_10k.json",
        "matrices_alist/(N=1024,M=283,R=0.72,CW=4,SEED=6).mtrx", 0.5,
        "tiny sanity bound", matrix_format=1,
    ),
    "adaptive": chip_smoke.CliCase(
        "tiny adaptive", "campaign_adaptive_aomsa.json",
        "matrices_qc/(N=1024,M=384,R=0.62,CW=3,Z=128,SEED=33).mtrx", 1.0,
        "tiny sanity bound", rows="top_efficiency",
    ),
}


@pytest.mark.parametrize("case", sorted(TINY_CASES))
def test_cli_phase_tiny(case, tmp_path, capsys):
    rows = chip_smoke.run_cli_case(TINY_CASES[case], tmp_path, trials=32)
    out = capsys.readouterr().out
    assert "memory_analysis" in out and "peak_bytes_in_use" in out
    # One QBER point; the adaptive config crosses it with the achievable
    # points of its delta x efficiency grid.
    if case == "adaptive":
        assert rows and all("R_ADAPTED" in r for r in rows)
    else:
        assert len(rows) == 1


def test_cli_phase_enforces_fer_bound(tmp_path):
    hard = chip_smoke.CliCase(
        "impossible bound", "campaign_fer_sweep_10k.json",
        "matrices_alist/(N=1024,M=283,R=0.72,CW=4,SEED=6).mtrx", -1.0,
        "a bound no run can meet", matrix_format=1,
    )
    with pytest.raises(AssertionError, match="above the bound"):
        chip_smoke.run_cli_case(hard, tmp_path, trials=8)


def test_layered_phase_tiny():
    qc = generate_qc_ldpc(8, 4, 128, column_weight=3, seed=5)
    chip_smoke.phase_layered(qc, frames=4, qber=0.04, max_iterations=30)


def test_flooding_phase_tiny(small_matrix):
    chip_smoke.phase_flooding(small_matrix, frames=4, qber=0.04,
                              max_iterations=30)


def test_mesh_phase_four_virtual_devices(medium_matrix, capsys):
    chip_smoke.phase_mesh(medium_matrix, per_card_batch=4, n_cards=4,
                          qber=0.03, max_iterations=20)
    out = capsys.readouterr().out
    assert "4 shards of 4 frames" in out


def test_last_line_contract(monkeypatch, capsys):
    """main() ends with the one-line JSON record, after every phase ran."""
    import qkd_ldpc_v_tpu.utils

    ran = []
    monkeypatch.setattr(qkd_ldpc_v_tpu.utils, "enable_compilation_cache",
                        lambda: None)
    monkeypatch.setattr(chip_smoke, "device_check", lambda: {
        "platform": "gpu", "kind": "stub", "count": 1})
    monkeypatch.setattr(chip_smoke, "phase_cli", lambda: ran.append(1))
    monkeypatch.setattr(chip_smoke, "phase_layered", lambda qc: ran.append(2))
    monkeypatch.setattr(chip_smoke, "phase_flooding", lambda m: ran.append(3))
    assert chip_smoke.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {
        "ok": True, "device": {"platform": "gpu", "kind": "stub", "count": 1}
    }
    assert ran == [1, 2, 3]
