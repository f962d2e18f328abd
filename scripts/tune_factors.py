"""Tune scaling factors for the shipped QC-PEG codes on the device.

Sweeps the min-sum family's factors (NMSA alpha, OMSA beta, ANMSA alpha x nu,
AOMSA beta x sigma) on a QC code at its working QBER through the production
driver path. Factors are traced scalars in the compiled step, so the
whole sweep costs ONE compile per algorithm. Prints a markdown table of
FER / mean converged iterations per point; use it to pick the defaults
shipped in configs/ (the reference leaves factor choice to the user's
config sweeps - configs_all/ "NMSA optimization" campaigns).

Usage: python scripts/tune_factors.py [--trials 8192] [--qber 0.03]
                                      [--alg NMSA,OMSA,ANMSA,AOMSA]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--trials", type=int, default=8192)
    p.add_argument("--qber", type=float, default=0.03)
    p.add_argument("--alg", default="NMSA,OMSA,ANMSA,AOMSA")
    p.add_argument("--matrix", default=None,
                   help="alist matrix path (default: the QC headline code)")
    args = p.parse_args()

    from qkd_ldpc_v_tpu.config import Config, DecodingAlgorithm, RQBERRange
    from qkd_ldpc_v_tpu.models.qc import generate_qc_peg
    from qkd_ldpc_v_tpu.rate_adapt import HMatrixParams
    from qkd_ldpc_v_tpu.simulation import (
        ScalingFactors,
        SimCombination,
        run_combination,
    )
    from qkd_ldpc_v_tpu.utils import enable_compilation_cache

    enable_compilation_cache()

    if args.matrix:
        from qkd_ldpc_v_tpu.models.hmatrix import read_sparse_matrix_alist

        matrix = read_sparse_matrix_alist(args.matrix)
    else:
        matrix = generate_qc_peg(
            base_bits=20, base_checks=6, lifting=512, column_weight=4, seed=9
        ).to_hmatrix()

    grids = {
        "NMSA": [(a, 1.0) for a in (0.5, 0.55, 0.6, 0.65, 0.7, 0.75, 0.8,
                                    0.85, 0.9)],
        "OMSA": [(b, 1.0) for b in (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.8, 1.0)],
        "ANMSA": [(a, nu) for a in (0.6, 0.7, 0.8, 0.9)
                  for nu in (0.2, 0.4, 0.6, 0.8)],
        "AOMSA": [(b, s) for b in (0.3, 0.5, 0.7) for s in (0.5, 1.0, 1.5)],
    }

    rows = ["| alg | primary | secondary | FER | mean iters |",
            "|---|---|---|---|---|"]
    for name in args.alg.split(","):
        alg = DecodingAlgorithm[name if name != "SPA-LIN" else "SPA_APPROX"]
        cfg = Config(
            trials_number=args.trials,
            simulation_seed=31,
            decoding_algorithm=alg,
            decoding_alg_max_iterations=100,
            r_qber_ranges=(RQBERRange(0.99, args.qber, args.qber, 0.01),),
            batch_size=args.trials,
        )
        best = None
        for i, (prim, sec) in enumerate(grids[name]):
            comb = SimCombination(
                args.qber, HMatrixParams(), ScalingFactors(prim, sec)
            )
            t0 = time.perf_counter()
            res = run_combination(matrix, comb, cfg, sim_number=i)
            dt = time.perf_counter() - t0
            fer = 1 - res.ratio_trials_success_ldpc
            rows.append(
                f"| {name} | {prim} | {sec} | {fer:.5f} | "
                f"{res.iter_success_mean:.1f} |"
            )
            print(f"{name} {prim}/{sec}: FER={fer:.5f} "
                  f"iters={res.iter_success_mean:.1f} ({dt:.1f}s)",
                  file=sys.stderr, flush=True)
            key = (fer, res.iter_success_mean)
            if best is None or key < best[0]:
                best = (key, prim, sec)
        print(f"# best {name}: primary={best[1]} secondary={best[2]} "
              f"FER={best[0][0]:.5f}", file=sys.stderr, flush=True)
    print("\n".join(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
