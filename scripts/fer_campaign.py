"""FER-vs-QBER characterization campaign.

Runs the framework's decoders over a grid of (code, QBER) points and writes
a markdown table plus a CSV. Because the f64 path is A/B-verified bit-exact
against the reference C++ (tests/test_reference_parity.py), the f32 curves
produced here characterize the same decoders the reference implements, at
device speed.

Usage: python scripts/fer_campaign.py [--suite 10k|1k|100k]
       [--trials 4096] [--out docs/FER_CURVES.md]

Suites mirror the reference's three frame sizes (its configs_all campaign
shapes): 10k (default; docs/FER_CURVES.md), 1k and 100k (their own docs
files). Per-code QBER grids track each rate's waterfall region.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import jax

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--suite", choices=("10k", "1k", "100k"), default="10k")
    p.add_argument("--trials", type=int, default=4096)
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args()
    if args.out is None:
        args.out = Path({
            "10k": "docs/FER_CURVES.md",
            "1k": "docs/FER_CURVES_1K.md",
            "100k": "docs/FER_CURVES_100K.md",
        }[args.suite])

    from qkd_ldpc_v_tpu.config import Config, DecodingAlgorithm, RQBERRange
    from qkd_ldpc_v_tpu.models.hmatrix import read_sparse_matrix_alist
    from qkd_ldpc_v_tpu.models.qc import generate_qc_peg
    from qkd_ldpc_v_tpu.rate_adapt import HMatrixParams
    from qkd_ldpc_v_tpu.simulation import (
        ScalingFactors,
        SimCombination,
        run_combination,
    )
    from qkd_ldpc_v_tpu.utils import enable_compilation_cache

    enable_compilation_cache()

    from qkd_ldpc_v_tpu.config import MatrixFormat
    from qkd_ldpc_v_tpu.models.hmatrix import read_matrix

    root = Path(__file__).resolve().parent.parent
    mid = (0.02, 0.025, 0.03, 0.035, 0.04)
    alist_dir = root / "sparse_matrices/matrices_alist"
    # (name, matrix, alpha, qber grid, batch)
    if args.suite == "10k":
        codes = [
            ("QC-PEG R=0.70 Z=512 CW=4 (headline)",
             generate_qc_peg(20, 6, 512, 4, seed=9).to_hmatrix(),
             0.65, mid, args.trials),
            ("QC-PEG R=0.725 Z=256 CW=4",
             generate_qc_peg(40, 11, 256, 4, seed=9).to_hmatrix(),
             0.70, mid, args.trials),
            ("alist R=0.72 CW=4 (committed)",
             read_sparse_matrix_alist(
                 alist_dir / "(N=10240,M=2841,R=0.72,CW=4,SEED=66).mtrx"),
             0.80, mid, args.trials),
        ]
    elif args.suite == "1k":
        low = (0.01, 0.015, 0.02, 0.025, 0.03)
        codes = [
            ("alist 1k R=0.72 CW=4 (committed)",
             read_sparse_matrix_alist(
                 alist_dir / "(N=1024,M=283,R=0.72,CW=4,SEED=6).mtrx"),
             0.60, low, args.trials),
            ("alist 1k R=0.62 CW=3 (committed)",
             read_sparse_matrix_alist(
                 alist_dir / "(N=1024,M=384,R=0.62,CW=3,SEED=62).mtrx"),
             0.70, (0.02, 0.03, 0.04, 0.05, 0.06), args.trials),
        ]
    else:  # 100k
        qc_dir = root / "sparse_matrices/matrices_qc"
        codes = [
            ("QC 100k R=0.70 Z=2048 CW=3",
             read_matrix(qc_dir / "(N=102400,M=30720,R=0.70,CW=3,"
                         "Z=2048,SEED=56).mtrx", MatrixFormat.QC),
             0.80, mid, 1024),
            ("QC 100k R=0.84 Z=2048 CW=3",
             read_matrix(qc_dir / "(N=102400,M=16384,R=0.84,CW=3,"
                         "Z=2048,SEED=57).mtrx", MatrixFormat.QC),
             0.80, (0.005, 0.01, 0.0125, 0.015, 0.02), 1024),
            ("QC 100k R=0.50 Z=2048 CW=3",
             read_matrix(qc_dir / "(N=102400,M=51200,R=0.50,CW=3,"
                         "Z=2048,SEED=58).mtrx", MatrixFormat.QC),
             0.80, (0.06, 0.07, 0.08, 0.09, 0.10), 1024),
            ("alist 100k R=0.69 CW=3",
             read_sparse_matrix_alist(
                 alist_dir / "(N=102400,M=31744,R=0.69,CW=3,SEED=67).mtrx"),
             0.80, mid, 256),
        ]

    rows = []
    for name, matrix, alpha, qbers, batch in codes:
        for q in qbers:
            cfg = Config(
                trials_number=args.trials,
                simulation_seed=99,
                decoding_algorithm=DecodingAlgorithm.NMSA,
                decoding_alg_max_iterations=100,
                r_qber_ranges=(RQBERRange(0.99, q, q, 0.01),),
                batch_size=batch,
            )
            comb = SimCombination(
                q, HMatrixParams(), ScalingFactors(primary=alpha)
            )
            t0 = time.perf_counter()
            res = run_combination(matrix, comb, cfg, sim_number=0)
            dt = time.perf_counter() - t0
            fer = 1 - res.ratio_trials_success_ldpc
            rows.append((name, alpha, q, fer, res.iter_success_mean,
                         args.trials / dt))
            print(
                f"{name} q={q}: FER={fer:.5f} iters={res.iter_success_mean:.1f}"
                f" ({args.trials / dt:,.0f} frames/s)",
                file=sys.stderr, flush=True,
            )

    device = jax.devices()[0]
    args.out.parent.mkdir(parents=True, exist_ok=True)
    lines = [
        "# FER vs QBER — NMSA, 100-iteration cap, exact-count channel",
        "",
        f"{args.trials} trials per point, one {device.device_kind} "
        f"({device.platform}), f32 decode",
        "(the f64 path is A/B-verified bit-exact against the reference C++;",
        "see PARITY.md). Generated by scripts/fer_campaign.py.",
        "",
        "",
        "Throughput is bench.py's contract (steady-state, warmed); these",
        "campaign runs time compile/warm-up inside each point, so no",
        "frames/s column is reported here.",
        "",
        "| code | alpha | QBER | FER | mean iters |",
        "|---|---|---|---|---|",
    ]
    for name, alpha, q, fer, iters, _fps in rows:
        lines.append(
            f"| {name} | {alpha} | {q} | {fer:.5f} | {iters:.1f} |"
        )
    args.out.write_text("\n".join(lines) + "\n")
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
