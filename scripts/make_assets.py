"""Generate the repo's starter asset library (deterministic).

The reference ships matrix suites and example configs
(sparse_matrices/*, configs/*); this script generates our equivalents:
QC-PEG base-graph matrices (this repo's QC format), small alist codes for
the generic path, and example sweep configs in the reference JSON schema.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from qkd_ldpc_v_tpu.models.generator import generate_regular_ldpc
from qkd_ldpc_v_tpu.models.hmatrix import (
    from_dense,
    write_alist,
    write_dense,
    write_sparse_1,
    write_sparse_2,
)
from qkd_ldpc_v_tpu.models.qc import generate_qc_peg, write_qc_matrix
from qkd_ldpc_v_tpu.rate_adapt import get_punctured_bits_untainted

ROOT = Path(__file__).resolve().parent.parent


def _untp(matrix_path, matrix, seed: int) -> None:
    """Generate-and-commit the .untp cache next to a matrix (deterministic:
    the greedy's SplitMix64 stream is seeded explicitly)."""
    get_punctured_bits_untainted(
        matrix_path, np.random.default_rng(seed), matrix
    )


def main() -> int:
    qc_dir = ROOT / "sparse_matrices" / "matrices_qc"
    alist_dir = ROOT / "sparse_matrices" / "matrices_alist"
    cfg_dir = ROOT / "configs"
    qc_dir.mkdir(parents=True, exist_ok=True)
    alist_dir.mkdir(parents=True, exist_ok=True)
    cfg_dir.mkdir(parents=True, exist_ok=True)

    # QC-PEG suites mirroring the reference's rate ladders
    # (matrices_alist_{1k,10k,100k}_all span R = 0.36-0.92): committed,
    # deterministic, with .untp caches at 1k/10k. Column weight 4 wherever
    # mb allows (a column of weight cw needs mb >= cw), else 3.
    qc_suite = []
    # N = 1024 (Z = 128, nb = 8): the 1k QC ladder stops at R = 0.625;
    # higher 1k rates live in the alist suite below.
    for mb, cw, seed in ((5, 4, 31), (4, 4, 32), (3, 3, 33)):
        qc_suite.append((8, mb, 128, cw, seed))
    # N = 10240 (Z = 256, nb = 40): R = 0.35 .. 0.925.
    for mb, cw, seed in (
        (26, 4, 41), (22, 4, 42), (19, 4, 43), (16, 4, 44),
        (12, 4, 45), (9, 4, 46), (6, 4, 47), (3, 3, 48),
    ):
        qc_suite.append((40, mb, 256, cw, seed))
    # The round-1 bench/headline codes (kept: committed seeds are an
    # invariant — the headline bench depends on them).
    qc_suite += [
        (20, 6, 512, 4, 9),     # N=10240, R=0.70 (headline bench code)
        (40, 11, 256, 4, 9),    # N=10240, R=0.725 (tight-efficiency point)
        (40, 8, 256, 4, 10),    # N=10240, R=0.80
        (40, 14, 256, 4, 11),   # N=10240, R=0.65
        (8, 4, 128, 3, 12),     # N=1024,  R=0.5 (small/test)
    ]
    # N = 102400 (Z = 1024, nb = 100): the reference's largest frames.
    for mb, cw, seed in ((64, 4, 51), (50, 4, 52), (30, 4, 53), (15, 4, 54),
                         (8, 4, 55)):
        qc_suite.append((100, mb, 1024, cw, seed))
    # N = 102400 wide-lift variants (Z = 2048, nb = 50, CW = 3 — the
    # reference's own 100k column weight): half the block-edge count of the
    # Z = 1024 ladder. R=0.70 is the 100k QC bench code; R=0.84 / R=0.50
    # extend the 100k FER ladder.
    for mb, seed in ((15, 56), (8, 57), (25, 58)):
        qc_suite.append((50, mb, 2048, 3, seed))

    for nb, mb, z, cw, seed in qc_suite:
        qc = generate_qc_peg(nb, mb, z, cw, seed=seed)
        name = (
            f"(N={qc.num_bit_nodes},M={qc.num_check_nodes},"
            f"R={qc.code_rate:.2f},CW={cw},Z={z},SEED={seed}).mtrx"
        )
        write_qc_matrix(qc, qc_dir / name)
        _untp(qc_dir / name, qc.to_hmatrix(), seed=1000 + seed)
        print("wrote", qc_dir / name)

    # alist codes for the generic decoder path: a 1k rate ladder covering
    # the high rates the 1k QC ladder cannot reach, plus the originals.
    alist_suite = [
        (1024, 512, 3, 5), (1024, 283, 4, 6),          # round-1 originals
        (1024, 655, 3, 61),                            # R = 0.36
        (1024, 384, 3, 62),                            # R = 0.625
        (1024, 256, 4, 63),                            # R = 0.75
        (1024, 154, 5, 64),                            # R = 0.85
        (1024, 82, 5, 65),                             # R = 0.92
        (10240, 2841, 4, 66),                          # R = 0.72 (the
        # reference's headline 10k operating point, regenerated here so the
        # alist campaign runs from this repo alone)
        (102400, 31744, 3, 67),                        # R = 0.69 — the
        # reference's 100k shape (matrices_alist_100k_all: N=102400, CW=3),
        # so the 100k workload and its tests run from this repo alone
    ]
    for n, m, cw, seed in alist_suite:
        mat = generate_regular_ldpc(n, m, cw, seed=seed)
        name = f"(N={n},M={m},R={1 - m / n:.2f},CW={cw},SEED={seed}).mtrx"
        write_alist(mat, alist_dir / name)
        _untp(alist_dir / name, mat, seed=2000 + seed)
        print("wrote", alist_dir / name)

    # ------------------------------------------------------------------
    # The remaining reference matrix formats, so every format the CLI
    # accepts has committed assets (reference directory conventions:
    # src/main.cpp:7-11 — matrices_uncompressed / matrices_1 / matrices_2).
    # ------------------------------------------------------------------

    # Dense uncompressed: the Johnson textbook code (the same asset the
    # reference ships as matrices_uncompressed/(N=6,K=2,M=4,R=0.34).mtrx;
    # examples/qkd_ldpc_example.py decodes it) plus a generated toy.
    dense_dir = ROOT / "sparse_matrices" / "matrices_uncompressed"
    dense_dir.mkdir(parents=True, exist_ok=True)
    johnson = from_dense(np.array(
        [
            [1, 1, 0, 1, 0, 0],
            [0, 1, 1, 0, 1, 0],
            [1, 0, 0, 0, 1, 1],
            [0, 0, 1, 1, 0, 1],
        ],
        dtype=np.int8,
    ))
    write_dense(johnson, dense_dir / "(N=6,K=2,M=4,R=0.34).mtrx")
    _untp(dense_dir / "(N=6,K=2,M=4,R=0.34).mtrx", johnson, seed=5001)
    print("wrote", dense_dir / "(N=6,K=2,M=4,R=0.34).mtrx")
    toy = generate_regular_ldpc(32, 16, 3, seed=71)
    write_dense(toy, dense_dir / "(N=32,M=16,R=0.50,CW=3,SEED=71).mtrx")
    _untp(dense_dir / "(N=32,M=16,R=0.50,CW=3,SEED=71).mtrx", toy, seed=5071)
    print("wrote", dense_dir / "(N=32,M=16,R=0.50,CW=3,SEED=71).mtrx")

    # Format 1 (MacKay/PEG) and format 2: the same generated codes as two
    # of the alist ladder entries (identical seeds — cross-format reads
    # must agree, tests/test_assets.py) plus the 10k point in format 2
    # (the reference's matrices_2_10k_all family), with .untp caches.
    fmt1_dir = ROOT / "sparse_matrices" / "matrices_1"
    fmt2_dir = ROOT / "sparse_matrices" / "matrices_2"
    fmt1_dir.mkdir(parents=True, exist_ok=True)
    fmt2_dir.mkdir(parents=True, exist_ok=True)
    for n, m, cw, seed in ((1024, 512, 3, 5), (1024, 256, 4, 63)):
        mat = generate_regular_ldpc(n, m, cw, seed=seed)
        name = f"(N={n},M={m},R={1 - m / n:.2f},CW={cw},SEED={seed}).mtrx"
        write_sparse_1(mat, fmt1_dir / name)
        _untp(fmt1_dir / name, mat, seed=3000 + seed)
        print("wrote", fmt1_dir / name)
    for n, m, cw, seed in (
        (1024, 283, 4, 6), (1024, 154, 5, 64), (10240, 2841, 4, 66),
    ):
        mat = generate_regular_ldpc(n, m, cw, seed=seed)
        name = f"(N={n},M={m},R={1 - m / n:.2f},CW={cw},SEED={seed}).mtrx"
        write_sparse_2(mat, fmt2_dir / name)
        _untp(fmt2_dir / name, mat, seed=4000 + seed)
        print("wrote", fmt2_dir / name)

    sweep = {
        "threads_number": 1,
        "trials_number": 1024,
        "use_config_simulation_seed": True,
        "simulation_seed": 42,
        "enable_privacy_maintenance": False,
        "enable_throughput_measurement": True,
        "throughput_measurement_parameters": {"consider_RTT": True, "RTT": 0.4},
        "decoding_algorithm": 2,
        "min_sum_normalized_parameters": {
            "use_alpha_range": False,
            "alpha_range": {"begin": 0.7, "end": 0.9, "step": 0.05},
            "code_rate_alpha_maps": [
                {"code_rate": 0.55, "alpha": 0.75},
                {"code_rate": 0.99, "alpha": 0.70},
            ],
        },
        "decoding_algorithm_max_iterations": 100,
        "matrix_format": 4,
        "trace_qkd_ldpc": False,
        "trace_decoding_algorithm": False,
        "trace_decoding_algorithm_llr": False,
        "enable_decoding_algorithm_msg_llr_threshold": False,
        "code_rate_QBER_ranges": [
            {"code_rate": 0.55, "QBER": {"begin": 0.05, "end": 0.07, "step": 0.01}},
            {"code_rate": 0.65, "QBER": {"begin": 0.035, "end": 0.045, "step": 0.005}},
            {"code_rate": 0.70, "QBER": {"begin": 0.025, "end": 0.035, "step": 0.005}},
            {"code_rate": 0.75, "QBER": {"begin": 0.02, "end": 0.03, "step": 0.005}},
            {"code_rate": 0.85, "QBER": {"begin": 0.01, "end": 0.02, "step": 0.005}},
            {"code_rate": 0.99, "QBER": {"begin": 0.005, "end": 0.01, "step": 0.005}},
        ],
        "enable_code_rate_adaptation": False,
        "tpu": {"batch_size": 1024},
    }
    (cfg_dir / "example_qc_sweep.json").write_text(json.dumps(sweep, indent=2))
    print("wrote", cfg_dir / "example_qc_sweep.json")

    adapt = {
        "threads_number": 1,
        "trials_number": 256,
        "use_config_simulation_seed": True,
        "simulation_seed": 7,
        "enable_privacy_maintenance": True,
        "enable_throughput_measurement": True,
        "throughput_measurement_parameters": {"consider_RTT": True, "RTT": 0.4},
        "decoding_algorithm": 5,
        "adaptive_min_sum_offset_parameters": {
            "use_beta_range": False,
            "beta_range": {"begin": 0.3, "end": 0.9, "step": 0.1},
            "code_rate_beta_maps": [{"code_rate": 0.99, "beta": 0.6}],
            "use_sigma_range": False,
            "sigma_range": {"begin": 0.3, "end": 0.9, "step": 0.1},
            "code_rate_sigma_maps": [{"code_rate": 0.99, "sigma": 0.8}],
        },
        "decoding_algorithm_max_iterations": 100,
        "matrix_format": 1,
        "trace_qkd_ldpc": False,
        "trace_decoding_algorithm": False,
        "trace_decoding_algorithm_llr": False,
        "enable_decoding_algorithm_msg_llr_threshold": False,
        "code_rate_QBER_ranges": [
            {"code_rate": 0.99, "QBER": {"begin": 0.05, "end": 0.05, "step": 0.01}}
        ],
        "enable_code_rate_adaptation": True,
        "code_rate_adaptation_parameters": {
            "enable_untainted_puncturing": True,
            "use_adaptation_parameters_ranges": True,
            "code_rate_adaptation_parameters_ranges": [
                {
                    "code_rate": 0.99,
                    "delta": {"begin": 0.1, "end": 0.1, "step": 0.05},
                    "efficiency": {"begin": 1.2, "end": 1.4, "step": 0.1},
                }
            ],
        },
    }
    (cfg_dir / "example_rate_adapt.json").write_text(json.dumps(adapt, indent=2))
    print("wrote", cfg_dir / "example_rate_adapt.json")

    # ------------------------------------------------------------------
    # Campaign configs reproducing the reference's standard experiment
    # shapes (configs_all/: FER sweeps, alpha/beta optimization, adaptive
    # rate adaptation, f_EC measurement) against the committed suites —
    # the CLI runs every one of these with zero reference mounts.
    # ------------------------------------------------------------------

    def base_cfg(**over):
        cfg = {
            "threads_number": 1,
            "trials_number": 4096,
            "use_config_simulation_seed": True,
            "simulation_seed": 42,
            "enable_privacy_maintenance": False,
            "enable_throughput_measurement": True,
            "throughput_measurement_parameters": {
                "consider_RTT": True, "RTT": 0.4,
            },
            "decoding_algorithm": 2,
            "decoding_algorithm_max_iterations": 100,
            "matrix_format": 4,
            "trace_qkd_ldpc": False,
            "trace_decoding_algorithm": False,
            "trace_decoding_algorithm_llr": False,
            "enable_decoding_algorithm_msg_llr_threshold": False,
            "enable_code_rate_adaptation": False,
            "tpu": {"batch_size": 4096},
        }
        cfg.update(over)
        return cfg

    # Near-capacity QBER ladder per code rate (first-rate >= R lookup).
    qber_points = [
        (0.36, 0.115), (0.46, 0.092), (0.53, 0.077), (0.61, 0.061),
        (0.71, 0.040), (0.78, 0.028), (0.86, 0.017), (0.93, 0.0075),
    ]
    fer_ranges = [
        {"code_rate": r, "QBER": {
            "begin": round(q * 0.8, 4), "end": round(q * 1.2, 4),
            "step": round(q * 0.1, 4),
        }}
        for r, q in qber_points
    ]
    alpha_maps = [
        {"code_rate": r, "alpha": 0.75 if r < 0.7 else 0.7}
        for r, _ in qber_points
    ]

    campaigns = {
        # 1. FER vs QBER on the 10k QC ladder (reference shape:
        #    configs_all/config 10k NMSA FER=*.json)
        "campaign_fer_sweep_10k.json": base_cfg(
            min_sum_normalized_parameters={
                "use_alpha_range": False,
                "alpha_range": {"begin": 0.7, "end": 0.9, "step": 0.05},
                "code_rate_alpha_maps": alpha_maps,
            },
            code_rate_QBER_ranges=fer_ranges,
        ),
        # 2. NMSA alpha optimization at fixed near-capacity QBER
        #    (reference shape: configs_all/config * alpha optimization)
        "campaign_alpha_opt_nmsa.json": base_cfg(
            trials_number=2048,
            min_sum_normalized_parameters={
                "use_alpha_range": True,
                "alpha_range": {"begin": 0.5, "end": 1.0, "step": 0.05},
                "code_rate_alpha_maps": [],
            },
            code_rate_QBER_ranges=[
                {"code_rate": r, "QBER": {"begin": q, "end": q, "step": 0.01}}
                for r, q in qber_points
            ],
        ),
        # 3. OMSA beta optimization (reference shape: beta optimization)
        "campaign_beta_opt_omsa.json": base_cfg(
            trials_number=2048,
            decoding_algorithm=3,
            min_sum_offset_parameters={
                "use_beta_range": True,
                "beta_range": {"begin": 0.05, "end": 0.6, "step": 0.05},
                "code_rate_beta_maps": [],
            },
            code_rate_QBER_ranges=[
                {"code_rate": r, "QBER": {"begin": q, "end": q, "step": 0.01}}
                for r, q in qber_points
            ],
        ),
        # 4. AOMSA + rate adaptation + untainted puncturing + RTT
        #    (reference shape: configs/ADAPTIVE T.json)
        "campaign_adaptive_aomsa.json": base_cfg(
            trials_number=2048,
            decoding_algorithm=5,
            enable_privacy_maintenance=True,
            adaptive_min_sum_offset_parameters={
                "use_beta_range": False,
                "beta_range": {"begin": 0.3, "end": 0.9, "step": 0.1},
                "code_rate_beta_maps": [
                    {"code_rate": r, "beta": 0.5} for r, _ in qber_points
                ],
                "use_sigma_range": False,
                "sigma_range": {"begin": 0.3, "end": 0.9, "step": 0.1},
                "code_rate_sigma_maps": [
                    {"code_rate": r, "sigma": 1.0} for r, _ in qber_points
                ],
            },
            code_rate_QBER_ranges=[
                {"code_rate": r, "QBER": {
                    "begin": round(q * 0.9, 4), "end": round(q * 0.9, 4),
                    "step": 0.01,
                }}
                for r, q in qber_points
            ],
            enable_code_rate_adaptation=True,
            code_rate_adaptation_parameters={
                "enable_untainted_puncturing": True,
                "use_adaptation_parameters_ranges": True,
                "code_rate_adaptation_parameters_ranges": [
                    {"code_rate": r, "delta": {
                        "begin": 0.05, "end": 0.1, "step": 0.05,
                    }, "efficiency": {
                        "begin": 1.3, "end": 1.5, "step": 0.1,
                    }}
                    for r, _ in qber_points
                ],
            },
        ),
        # 5. f_EC measurement: efficiency swept over the reference's
        #    1.12-1.85 band with rate adaptation (reference shape:
        #    configs_all/config * f_EC)
        "campaign_fec_measurement.json": base_cfg(
            trials_number=2048,
            min_sum_normalized_parameters={
                "use_alpha_range": False,
                "alpha_range": {"begin": 0.7, "end": 0.9, "step": 0.05},
                "code_rate_alpha_maps": alpha_maps,
            },
            code_rate_QBER_ranges=[
                {"code_rate": r, "QBER": {
                    "begin": round(q * 0.85, 4), "end": round(q * 0.85, 4),
                    "step": 0.01,
                }}
                for r, q in qber_points
            ],
            enable_code_rate_adaptation=True,
            code_rate_adaptation_parameters={
                "enable_untainted_puncturing": True,
                "use_adaptation_parameters_ranges": True,
                "code_rate_adaptation_parameters_ranges": [
                    {"code_rate": r, "delta": {
                        "begin": 0.1, "end": 0.1, "step": 0.05,
                    }, "efficiency": {
                        "begin": 1.12, "end": 1.82, "step": 0.1,
                    }}
                    for r, _ in qber_points
                ],
            },
        ),
        # 6. FER sweep on the 1k alist ladder (the reference's own code
        #    family / format)
        "campaign_fer_1k_alist.json": base_cfg(
            matrix_format=1,
            min_sum_normalized_parameters={
                "use_alpha_range": False,
                "alpha_range": {"begin": 0.7, "end": 0.9, "step": 0.05},
                "code_rate_alpha_maps": alpha_maps,
            },
            code_rate_QBER_ranges=fer_ranges,
        ),
        # 7. FER sweep at the reference's largest production frame size
        #    (its config 100k shapes, configs_all/config 100k*.json) on the
        #    committed 100k QC ladder. A small batch keeps the 100k
        #    flooding state ([E, B] messages) small.
        "campaign_fer_sweep_100k.json": base_cfg(
            trials_number=4096,
            min_sum_normalized_parameters={
                "use_alpha_range": False,
                "alpha_range": {"begin": 0.7, "end": 0.9, "step": 0.05},
                "code_rate_alpha_maps": alpha_maps,
            },
            code_rate_QBER_ranges=fer_ranges,
            tpu={"batch_size": 256},
        ),
    }
    for name, cfg in campaigns.items():
        (cfg_dir / name).write_text(json.dumps(cfg, indent=2))
        print("wrote", cfg_dir / name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
