"""Decoded frames per second through the driver (run_combination), one GPU.

Five legs at QBER 0.03, NMSA, iteration cap 100, f32, each the median of
``--reps`` timed runs of one batch after one warm-up run (the warm-up
compiles; compile time is not in the median):

  * ``qc_layered`` (``value``) — the QC-PEG code N=10240, R=0.70, Z=512,
    CW=4, SEED=9 (f_EC = 1.54) at alpha 0.65, layered schedule;
  * ``qc_flooding`` — the same code and point, the reference's flooding
    schedule;
  * ``alist_10k`` — the committed 10k alist code (N=10240, R=0.72, CW=4,
    SEED=66) at alpha 0.7;
  * ``alist_100k`` — the committed 100k alist code (N=102400, R=0.69, CW=3,
    SEED=67) at alpha 0.8;
  * ``qc_100k`` — the 100k QC code (N=102400, R=0.70, Z=2048, CW=3,
    SEED=56) at alpha 0.8, layered schedule.

Requires a GPU: with none, it exits nonzero and prints no record. A failing
leg fails the run. Prints exactly one JSON line on stdout (diagnostics go
to stderr), naming the device and the card's name and power limit.

Usage: python bench.py [--reps 5]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
QBER = 0.03
MAX_ITERATIONS = 100

# Batches. The decoders keep their message state in device memory, so the
# batch sets the footprint, and a JAX process may use 60 GB of the card's
# 80 GB. Per frame, in f32:
#   * 10k QC layered: check->bit messages [mb=6, d=14, Z=512] 172 KB, bit
#     totals 41 KB, row temporaries [14, 512] about 5 x 29 KB, channel
#     keys and sort about 160 KB: about 0.55 MB, so 16384 frames take 9 GB.
#   * 10k flooding (QC or alist, E = 40,960 edges): each [E] message array
#     is 164 KB and about six are live, with the channel about 1.2 MB: 16384
#     frames take 20 GB.
#   * 100k alist flooding (E = 307,200): about 1.2 MB per [E] array and six
#     live, with the channel about 9 MB: 1024 frames take 9 GB.
#   * 100k QC layered (mb=15, d=10, Z=2048): messages 1.2 MB, totals
#     0.4 MB, channel about 1.6 MB: 4096 frames take 13 GB.
LEGS = (
    # name, matrix (format dir, file), alpha, schedule, batch
    ("qc_layered", ("matrices_qc", "(N=10240,M=3072,R=0.70,CW=4,Z=512,SEED=9)"),
     0.65, "layered", 16384),
    ("qc_flooding", ("matrices_qc", "(N=10240,M=3072,R=0.70,CW=4,Z=512,SEED=9)"),
     0.65, "flooding", 16384),
    ("alist_10k", ("matrices_alist", "(N=10240,M=2841,R=0.72,CW=4,SEED=66)"),
     0.70, "flooding", 16384),
    ("alist_100k", ("matrices_alist", "(N=102400,M=31744,R=0.69,CW=3,SEED=67)"),
     0.80, "flooding", 1024),
    ("qc_100k", ("matrices_qc", "(N=102400,M=30720,R=0.70,CW=3,Z=2048,SEED=56)"),
     0.80, "layered", 4096),
)


def measure(matrix, alpha: float, schedule: str, batch: int, reps: int,
            label: str) -> dict:
    """Warm up once, then time ``reps`` runs of one batch each."""
    from qkd_ldpc_v_tpu.config import Config, DecodingAlgorithm, RQBERRange
    from qkd_ldpc_v_tpu.rate_adapt import HMatrixParams
    from qkd_ldpc_v_tpu.simulation import (
        ScalingFactors,
        SimCombination,
        run_combination,
    )

    cfg = Config(
        trials_number=batch,
        simulation_seed=123,
        decoding_algorithm=DecodingAlgorithm.NMSA,
        decoding_alg_max_iterations=MAX_ITERATIONS,
        r_qber_ranges=(RQBERRange(0.99, QBER, QBER, 0.01),),
        batch_size=batch,
        schedule=schedule,
    )
    comb = SimCombination(QBER, HMatrixParams(), ScalingFactors(primary=alpha))
    t0 = time.perf_counter()
    warm = run_combination(matrix, comb, cfg, sim_number=0)
    setup = time.perf_counter() - t0
    samples, fers, iters = [], [], []
    for rep in range(reps):
        t0 = time.perf_counter()
        res = run_combination(matrix, comb, cfg, sim_number=1 + rep)
        samples.append(batch / (time.perf_counter() - t0))
        fers.append(1 - res.ratio_trials_success_ldpc)
        iters.append(res.iter_success_mean)
    out = {
        "frames_per_s": statistics.median(samples),
        "fps_min": min(samples),
        "fps_max": max(samples),
        "fer_max": max(fers),
        "mean_iters": statistics.mean(iters),
        "warmup_s": setup,
        "warmup_fer": 1 - warm.ratio_trials_success_ldpc,
        "batch": batch,
        "reps": reps,
        "schedule": schedule,
    }
    print(f"bench[{label}]: {json.dumps(out)}", file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, JAX found platform {dev.platform!r}",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()

    from qkd_ldpc_v_tpu.config import MatrixFormat
    from qkd_ldpc_v_tpu.models.hmatrix import read_matrix
    from qkd_ldpc_v_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    t_start = time.perf_counter()
    legs = {}
    for name, (fmt_dir, stem), alpha, schedule, batch in LEGS:
        fmt = MatrixFormat.QC if fmt_dir == "matrices_qc" else MatrixFormat.ALIST
        matrix = read_matrix(REPO / "sparse_matrices" / fmt_dir / f"{stem}.mtrx",
                             fmt)
        legs[name] = {"matrix": stem, "alpha": alpha,
                      **measure(matrix, alpha, schedule, batch, args.reps,
                                name)}
    print(json.dumps({
        "metric": "decoded_10k_frames_per_s_qber0.03",
        "value": legs["qc_layered"]["frames_per_s"],
        "unit": "frames/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "nvidia_smi": smi,
        "legs": legs,
        "bench_seconds": time.perf_counter() - t_start,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
