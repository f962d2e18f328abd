"""Data-mesh scaling report: frames/s vs device count.

Runs the same Monte-Carlo combination over 1, 2, 4, ... devices of the
available fleet (the GPUs of a host, or the virtual CPU mesh for mechanics
validation) and reports throughput and parallel efficiency.

Usage:
  python scripts/scaling_report.py [--trials 4096] [--qber 0.03]
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python scripts/scaling_report.py --trials 256 --bits 1024

On a multi-host fleet, start one process per host with the usual
coordinator environment; qkd_ldpc_v_tpu.parallel.initialize_distributed is
invoked automatically from JAX_COORDINATOR_* variables if present.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--trials", type=int, default=4096)
    p.add_argument("--qber", type=float, default=0.03)
    p.add_argument("--bits", type=int, default=10240)
    p.add_argument("--alpha", type=float, default=0.7)
    p.add_argument("--max-iters", type=int, default=100)
    p.add_argument("--max-devices", type=int, default=0,
                   help="cap the device ladder (0 = all)")
    p.add_argument("--reduce-stats", action="store_true",
                   help="use the O(1)-host-traffic reduce-mode mesh steps")
    args = p.parse_args()

    import jax

    want = os.environ.get("JAX_PLATFORMS")
    if want and jax.config.jax_platforms != want:
        jax.config.update("jax_platforms", want)

    from qkd_ldpc_v_tpu.config import Config, DecodingAlgorithm, RQBERRange
    from qkd_ldpc_v_tpu.models.generator import generate_regular_ldpc
    from qkd_ldpc_v_tpu.parallel import make_data_mesh, mesh_step_factory
    from qkd_ldpc_v_tpu.rate_adapt import HMatrixParams
    from qkd_ldpc_v_tpu.simulation import (
        ScalingFactors,
        SimCombination,
        run_combination,
    )
    from qkd_ldpc_v_tpu.utils import enable_compilation_cache

    enable_compilation_cache()

    if os.environ.get("JAX_COORDINATOR_ADDRESS"):
        from qkd_ldpc_v_tpu.parallel import initialize_distributed

        initialize_distributed(
            coordinator_address=os.environ["JAX_COORDINATOR_ADDRESS"],
            num_processes=int(os.environ.get("JAX_NUM_PROCESSES", "1")),
            process_id=int(os.environ.get("JAX_PROCESS_ID", "0")),
        )

    devices = jax.devices()
    print(f"fleet: {len(devices)} x {devices[0].device_kind}", file=sys.stderr)

    matrix = generate_regular_ldpc(
        num_bits=args.bits, num_checks=int(args.bits * 0.275) // 1,
        column_weight=4, seed=9,
    )
    cfg = Config(
        trials_number=args.trials,
        simulation_seed=17,
        decoding_algorithm=DecodingAlgorithm.NMSA,
        decoding_alg_max_iterations=args.max_iters,
        r_qber_ranges=(RQBERRange(0.99, args.qber, args.qber, 0.01),),
        batch_size=args.trials,
        phase1_iterations=0,
    )
    comb = SimCombination(
        args.qber, HMatrixParams(), ScalingFactors(primary=args.alpha)
    )

    results = []
    n = 1
    limit = len(devices) if args.max_devices <= 0 else min(
        args.max_devices, len(devices)
    )
    while n <= limit:
        mesh = make_data_mesh(n)
        factory = mesh_step_factory(mesh, reduce_stats=args.reduce_stats)
        run_combination(matrix, comb, cfg, 0, step_factory=factory)  # warm
        t0 = time.perf_counter()
        res = run_combination(matrix, comb, cfg, 1, step_factory=factory)
        dt = time.perf_counter() - t0
        fps = args.trials / dt
        results.append((n, fps))
        base = results[0][1]
        eff = fps / (base * n)
        print(
            f"devices={n}: {fps:,.0f} frames/s  efficiency={eff:.2f}  "
            f"FER={1 - res.ratio_trials_success_ldpc:.4f}",
            file=sys.stderr,
        )
        n *= 2

    print(json.dumps({
        "metric": "scaling",
        "results": [{"devices": d, "frames_per_s": round(f, 1)} for d, f in results],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
