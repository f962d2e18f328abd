"""Command-line entry point: batch-process config files into CSV results.

Mirrors the reference CLI contract (reference: src/main.cpp:6-203): every
``*.json`` in the config directory is one run; the matrix directory is chosen
by the config's ``matrix_format``; each run produces one self-describing CSV
in the results directory. Differences by design: directories are flags
instead of compile-time constants, there is no interactive "press Enter"
pause, and ``--help-config`` replaces the giant ``--help`` text
(reference: src/main.cpp:28-154).
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from pathlib import Path

from qkd_ldpc_v_tpu.config import format_config_info, parse_config_data
from qkd_ldpc_v_tpu.simulation import (
    prepare_sim_inputs,
    qkd_ldpc_batch_simulation,
    write_file,
)
from qkd_ldpc_v_tpu.utils import (
    enable_compilation_cache,
    format_duration,
    get_file_paths_in_directory,
)

CONFIG_HELP = """\
CONFIG FILE REFERENCE (JSON; one file = one simulation run)
===========================================================

Core keys (all required, as in the reference schema):
  threads_number                int >= 1. Kept for schema compatibility; the
                                driver decodes trials as device batches
                                (see tpu.batch_size below).
  trials_number                 int >= 1. Monte-Carlo trials per sweep point.
  use_config_simulation_seed    bool. true -> use simulation_seed; false ->
                                seed from current time.
  simulation_seed               int. Master PRNG seed.
  enable_privacy_maintenance    bool. Greedily delete one key bit per check
                                node after reconciliation.
  enable_throughput_measurement bool. Record per-trial decode throughput.
  throughput_measurement_parameters.consider_RTT   bool. Add a modeled
                                round-trip time to the throughput denominator.
  throughput_measurement_parameters.RTT            float ms >= 0.
  decoding_algorithm            int 0..5:
                                  0 SPA    sum-product (tanh/atanh)
                                  1 SPA    with piecewise-linear tanh/atanh
                                  2 NMSA   normalized min-sum (alpha)
                                  3 OMSA   offset min-sum (beta)
                                  4 ANMSA  adaptive normalized min-sum
                                           (alpha, nu)
                                  5 AOMSA  adaptive offset min-sum
                                           (beta, sigma)
  min_sum_normalized_parameters       (NMSA)  use_alpha_range + alpha_range
                                      {begin,end,step} or code_rate_alpha_maps
                                      [{code_rate, alpha}].
  min_sum_offset_parameters           (OMSA)  same with beta.
  adaptive_min_sum_normalized_parameters (ANMSA) alpha and nu blocks.
  adaptive_min_sum_offset_parameters     (AOMSA) beta and sigma blocks.
                                Map lookup rule everywhere: the first entry
                                (ascending code_rate) with code_rate >= the
                                matrix's rate wins.
  decoding_algorithm_max_iterations   int >= 1. Iteration cap (typ. 100).
  matrix_format                 int 0..4:
                                  0 uncompressed dense 0/1 text
                                  1 alist
                                  2 sparse_1 (MacKay/PEG, 1-based rows)
                                  3 sparse_2 ("N M" header, rows then cols)
                                  4 quasi-cyclic base-graph shifts
                                    (extension; directory matrices_qc)
  trace_qkd_ldpc                bool. Dump protocol-level tensors.
  trace_decoding_algorithm      bool. Dump per-iteration decoder tensors.
  trace_decoding_algorithm_llr  bool. Track the max-|LLR| watermark.
  enable_decoding_algorithm_msg_llr_threshold  bool. Clamp messages to
                                +-threshold each pass.
  decoding_algorithm_msg_llr_threshold         float > 0.
  code_rate_QBER_ranges         [{code_rate, QBER:{begin,end,step}}]. QBER
                                sweep per matrix rate (same lookup rule).
  enable_code_rate_adaptation   bool. Puncture/shorten to hit
                                R = 1 - f_EC*h(QBER) per Elkouss et al.
  code_rate_adaptation_parameters.enable_untainted_puncturing   bool. Select
                                punctured bits by the untainted greedy
                                (cached in a .untp file next to the matrix).
  code_rate_adaptation_parameters.use_adaptation_parameters_ranges  bool.
    true  -> code_rate_adaptation_parameters_ranges:
             [{code_rate, delta:{begin,end,step},
               efficiency:{begin,end,step}}] crossed with the QBER range.
    false -> code_rate_QBER_adaptation_parameters_maps:
             [{code_rate, QBER, delta, efficiency}] explicit points.

Extensions (optional "tpu" object; defaults keep reference semantics):
  tpu.batch_size                int. Frames decoded per device program
                                (0 = all trials at once).
  tpu.dtype                     float32 | float64 | bfloat16. Decoder message
                                precision (float64 = reference-parity mode).
  tpu.phase1_iterations         int. Exact two-phase straggler re-decode:
                                -1 auto (cap/2 when cap >= 64), 0 off,
                                >0 explicit phase-1 cap.
  tpu.schedule                  flooding | layered. "layered" (serial-C)
                                halves decoding sweeps at equal-or-better
                                FER (QC matrices, min-sum family only;
                                otherwise warns and floods). "flooding"
                                is the reference's schedule.

Results: one CSV per config in the results directory, semicolon-separated
with comma decimal marks; filename encodes trials, algorithm, iteration cap,
privacy, rate-adaptation mode, RTT, seed, and duration.
"""


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="qkd-ldpc-tpu",
        description=(
            "Batched Monte-Carlo simulator of LDPC information "
            "reconciliation for QKD (JAX)."
        ),
    )
    p.add_argument(
        "--configs", type=Path, default=Path("configs"),
        help="directory of *.json run configs (default: ./configs)",
    )
    p.add_argument(
        "--matrices", type=Path, default=Path("sparse_matrices"),
        help=(
            "root directory of matrix assets; the per-format subdirectory "
            "(matrices_uncompressed/matrices_alist/matrices_1/matrices_2) is "
            "chosen by each config (default: ./sparse_matrices)"
        ),
    )
    p.add_argument(
        "--results", type=Path, default=Path("results"),
        help="output directory for CSV results (default: ./results)",
    )
    p.add_argument(
        "--matrix-ext", default=".mtrx",
        help="matrix file extension filter (default: .mtrx)",
    )
    p.add_argument(
        "--help-config", action="store_true",
        help="print the config-file schema reference and exit",
    )
    p.add_argument(
        "--quiet", action="store_true", help="suppress progress output"
    )
    p.add_argument(
        "--profile", type=Path, default=None, metavar="DIR",
        help=(
            "capture a jax.profiler trace of the whole campaign into DIR "
            "(view with TensorBoard / xprof)"
        ),
    )
    return p


def _progress_printer(quiet: bool):
    # `base` counts trials credited within 2s of startup (checkpoint
    # restores); they are excluded from the ETA rate so a resumed campaign
    # doesn't report a near-zero ETA.
    state = {"done": 0, "base": 0, "last": -1.0, "t0": time.monotonic()}

    def cb(inc: int, total: int) -> None:
        if quiet:
            return
        now = time.monotonic()
        state["done"] += inc
        if now - state["t0"] < 2.0:
            state["base"] = state["done"]
        if now - state["last"] >= 0.5 or state["done"] >= total:
            state["last"] = now
            pct = 100.0 * state["done"] / total
            elapsed = now - state["t0"]
            # ETA like the reference's progress bar (src/simulation.cpp:703-709)
            session_done = max(state["done"] - state["base"], 1)
            eta = elapsed * (total - state["done"]) / session_done
            print(
                f"\rPROGRESS [{state['done']}/{total}] {pct:5.1f}% "
                f"elapsed {elapsed:5.0f}s eta {eta:5.0f}s",
                end="", flush=True,
            )
            if state["done"] >= total:
                print()

    return cb


def _color(code: str, text: str) -> str:
    """ANSI color when stdout is a terminal (the reference prints its
    banner/results/errors in color, reference: src/config.cpp:52-86,
    src/main.cpp:186-197)."""
    if not sys.stdout.isatty():
        return text
    return f"\033[{code}m{text}\033[0m"


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if args.help_config:
        print(CONFIG_HELP)
        return 0

    logging.basicConfig(level=logging.WARNING, format="%(message)s")
    enable_compilation_cache()
    profiling = False
    try:
        if args.profile is not None:
            import jax

            args.profile.mkdir(parents=True, exist_ok=True)
            jax.profiler.start_trace(str(args.profile))
            profiling = True
        config_paths = get_file_paths_in_directory(args.configs, ".json")
        if not config_paths:
            print(f"No *.json configs found in {args.configs}", file=sys.stderr)
            return 1
        for i, config_path in enumerate(config_paths):
            cfg = parse_config_data(config_path)
            print(_color('96', format_config_info(cfg, config_path.name, i + 1)))
            matrix_dir = args.matrices / cfg.matrix_format.directory_name
            matrix_paths = get_file_paths_in_directory(
                matrix_dir, args.matrix_ext
            )
            if not matrix_paths:
                raise FileNotFoundError(
                    f"No *{args.matrix_ext} matrices found in {matrix_dir}"
                )
            sim_inputs = prepare_sim_inputs(matrix_paths, cfg)

            start = time.monotonic()
            args.results.mkdir(parents=True, exist_ok=True)
            checkpoint = args.results / f".{config_path.stem}.checkpoint.json"
            results = qkd_ldpc_batch_simulation(
                sim_inputs, cfg, progress=_progress_printer(args.quiet),
                checkpoint_path=checkpoint,
            )
            duration = format_duration(time.monotonic() - start)

            result_path = write_file(results, cfg, duration, args.results)
            # Only drop the checkpoint once the CSV has safely landed.
            checkpoint.unlink(missing_ok=True)
            print(_color("92", f"The results are written to the file: {result_path}")
                  + "\n")
    except Exception as e:  # noqa: BLE001 — mirror reference catch-all
        print(_color("91", f"ERROR: {e}"), file=sys.stderr)
        return 1
    finally:
        if profiling:
            import jax

            jax.profiler.stop_trace()
    print(_color("92", "Simulations successfully completed!"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
