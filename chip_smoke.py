"""Smoke run of the simulator on an NVIDIA GPU, through its normal entry points.

    python chip_smoke.py                # phases 0-3 on one card
    python chip_smoke.py --four-cards   # phase 4 only: the data mesh on 4 cards

Phases (any failure exits nonzero; nothing is caught and reported as a pass):

0. Device check: JAX must see a GPU (no CPU fallback). Prints the platform,
   the device kind and count, and the card's name and power limit.
1. CLI end to end (``qkd_ldpc_v_tpu.cli.main`` in-process) on committed
   configs and matrices, copied into a temporary workspace. Only the trial
   count (one batch) and the number of QBER points (one) are cut; code,
   algorithm, batch and schedule are the config's. Each case checks its CSV
   rows and an FER bound, and prints the step's ``memory_analysis()`` and
   the device's ``peak_bytes_in_use``.
2. Layered QC decoder vs the NumPy layered oracle on the 10k Z=512 code,
   16 frames, the four min-sum algorithms: bit-exact.
3. Flooding decoder vs the f64 oracle (``oracle.py``) on the 10k alist
   code, 16 frames, all six algorithms: f64 min-sum bit-exact; SPA pair in
   f64 and f32-vs-f64 by frame agreement.
4. (``--four-cards`` only) ``run_combination`` through ``mesh_step_factory``
   over a 4-card ``data`` mesh; every shard equals a one-card run of the
   local step with its ``fold_in`` keys, and reduce mode's six scalars equal
   the host's aggregate of data mode.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
MATRICES = ROOT / "sparse_matrices"
QC_10K = "matrices_qc/(N=10240,M=3072,R=0.70,CW=4,Z=512,SEED=9).mtrx"
ALIST_10K = "matrices_alist/(N=10240,M=2841,R=0.72,CW=4,SEED=66).mtrx"
ALIST_100K = "matrices_alist/(N=102400,M=31744,R=0.69,CW=3,SEED=67).mtrx"

# Phase 3: frame agreement required where bit-exactness is not the
# contract. SPA's tanh/atanh come from the device's math library, which
# may differ from glibc's in the last bit, and f32 rounds every message;
# at QBER 0.015, far below this code's waterfall (docs/FER_CURVES.md: FER 0
# at 0.025), such differences can move an iteration count but should not
# change whether a frame converges. 0.9 is the suite's own f32-vs-f64 bound
# (tests/test_decoders.py::test_f32_statistically_close).
MIN_FRAME_AGREEMENT = 0.9


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase 0
# ---------------------------------------------------------------------------


def device_check() -> dict:
    """Require a GPU; return the device record of the last line."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found platform {dev.platform!r}"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    log(f"phase 0: platform={device['platform']} kind={device['kind']} "
        f"count={device['count']}")
    log(f"nvidia-smi: {smi}")
    return device


def peak_bytes() -> str:
    import jax

    stats = jax.devices()[0].memory_stats()
    if not stats:
        return "not reported"
    return f"{stats['peak_bytes_in_use'] / 2**30:.2f} GiB"


# ---------------------------------------------------------------------------
# Phase 1: the CLI
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CliCase:
    name: str
    config: str  # file under configs/
    matrix: str  # path under sparse_matrices/
    fer_bound: float
    why: str  # where the bound comes from
    matrix_format: int | None = None  # override of the config's format
    # "all": every CSV row must meet the bound; "top_efficiency": only the
    # rows at the largest f_EC (the easiest rate-adapted points).
    rows: str = "all"


CLI_CASES = (
    CliCase(
        "a: QC Z=512 layered NMSA", "example_qc_layered.json", QC_10K, 0.01,
        "FER 0 in 2e5 trials at QBER 0.03 layered (docs/FER_CURVES.md "
        "§Layered)",
    ),
    CliCase(
        "b: 10k alist NMSA", "campaign_fer_sweep_10k.json", ALIST_10K, 0.02,
        "the same-shape reference alist code has FER 0 at QBER 0.025 and "
        "0.022 at 0.03, alpha 0.8 (docs/FER_CURVES.md); this point is "
        "QBER 0.0224",
        matrix_format=1,
    ),
    CliCase(
        "c: rate-adaptive AOMSA", "campaign_adaptive_aomsa.json", QC_10K, 0.5,
        "no published FER at the adapted rates; the mother code floods at "
        "FER 0.118 at QBER 0.035 (docs/FER_CURVES.md) and the grid's "
        "largest f_EC lowers its rate, so the bound is a sanity margin",
        rows="top_efficiency",
    ),
    CliCase(
        "d: 100k alist NMSA", "campaign_fer_sweep_100k.json", ALIST_100K, 0.02,
        "FER 0 at QBER 0.03 and 0.035, alpha 0.8 "
        "(docs/FER_CURVES_100K.md); this point is QBER 0.032",
        matrix_format=1,
    ),
)


def _cut_config(raw: dict, trials: int | None,
                matrix_format: int | None) -> dict:
    """One batch of trials and the first QBER point of every range."""
    raw = json.loads(json.dumps(raw))
    batch = int(raw.get("tpu", {}).get("batch_size", 0))
    raw["trials_number"] = trials if trials is not None else batch
    for r in raw.get("code_rate_QBER_ranges", []):
        r["QBER"]["end"] = r["QBER"]["begin"]
    if matrix_format is not None:
        raw["matrix_format"] = matrix_format
    return raw


def _read_rows(results: Path) -> list:
    files = sorted(results.glob("*.csv"))
    if len(files) != 1:
        raise AssertionError(f"expected one CSV in {results}, found {files}")
    with files[0].open() as fh:
        rows = list(csv.DictReader(fh, delimiter=";"))
    if not rows:
        raise AssertionError(f"{files[0].name} has no result rows")
    return rows


def _num(cell: str) -> float:
    return float(cell.replace(",", "."))


def step_memory(matrix, cfg) -> str:
    """``memory_analysis()`` of the step the CLI compiled for ``cfg``."""
    import jax.numpy as jnp

    from qkd_ldpc_v_tpu.ops.channel import trial_keys
    from qkd_ldpc_v_tpu.simulation import get_step, resolve_phase1_cap

    batch = min(cfg.batch_size or cfg.trials_number, cfg.trials_number)
    step = get_step(matrix, cfg, batch,
                    max_iterations=resolve_phase1_cap(cfg) or None)
    n = matrix.num_bit_nodes
    f = jnp.dtype(cfg.dtype)
    args = tuple(trial_keys(0, 0, 0)) + (
        jnp.asarray(0.03, f), jnp.int32(int(0.03 * n)), jnp.asarray(0.8, f),
        jnp.asarray(1.0, f), jnp.asarray(0.0, f),
        jnp.zeros(n, jnp.int8), jnp.zeros(n, jnp.int32),
    )
    ma = step.lower(*args).compile().memory_analysis()
    if ma is None:
        return "memory_analysis: not reported"
    gib = 2.0**30
    return (f"memory_analysis: args {ma.argument_size_in_bytes / gib:.3f} "
            f"GiB, outputs {ma.output_size_in_bytes / gib:.3f} GiB, temps "
            f"{ma.temp_size_in_bytes / gib:.3f} GiB, code "
            f"{ma.generated_code_size_in_bytes / 2**20:.1f} MiB")


def run_cli_case(case: CliCase, workdir: Path,
                 trials: int | None = None) -> list:
    """Run one case through ``cli.main``; return its CSV rows."""
    from qkd_ldpc_v_tpu import cli
    from qkd_ldpc_v_tpu.config import parse_config_data
    from qkd_ldpc_v_tpu.models.hmatrix import read_matrix

    raw = json.loads((ROOT / "configs" / case.config).read_text())
    cut = _cut_config(raw, trials, case.matrix_format)
    cfg_dir = workdir / "configs"
    res_dir = workdir / "results"
    cfg_dir.mkdir(parents=True)
    cfg_path = cfg_dir / case.config
    cfg_path.write_text(json.dumps(cut, indent=2))
    cfg = parse_config_data(cfg_path)
    src = MATRICES / case.matrix
    mat_dir = workdir / "sparse_matrices" / cfg.matrix_format.directory_name
    mat_dir.mkdir(parents=True)
    shutil.copy(src, mat_dir / src.name)
    untp = src.with_suffix(".untp")
    if untp.exists():
        shutil.copy(untp, mat_dir / untp.name)

    t0 = time.perf_counter()
    rc = cli.main(["--configs", str(cfg_dir), "--matrices",
                   str(workdir / "sparse_matrices"), "--results",
                   str(res_dir), "--quiet"])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{case.name}: cli.main returned {rc}")
    rows = _read_rows(res_dir)
    checked = rows
    if case.rows == "top_efficiency":
        top = max(_num(r["EFFICIENCY"]) for r in rows)
        checked = [r for r in rows if _num(r["EFFICIENCY"]) == top]
    for r in rows:
        log(f"  {case.name}: QBER {r['CONFIG_QBER']} FER {r['FER']} "
            f"mean iters {r['ITER_SUCCESS_MEAN']}"
            + (f" f_EC {r['EFFICIENCY']} R {r['R_ADAPTED']}"
               if "EFFICIENCY" in r else ""))
    worst = max(_num(r["FER"]) for r in checked)
    if not worst <= case.fer_bound:
        raise AssertionError(
            f"{case.name}: FER {worst} above the bound {case.fer_bound} "
            f"({case.why})"
        )
    matrix = read_matrix(mat_dir / src.name, cfg.matrix_format)
    log(f"  {case.name}: {len(rows)} rows, {cfg.trials_number} trials, "
        f"batch {cfg.batch_size}, schedule {cfg.schedule}, wall {wall:.1f} s; "
        f"{step_memory(matrix, cfg)}; peak_bytes_in_use {peak_bytes()}")
    return rows


def phase_cli() -> None:
    for case in CLI_CASES:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            run_cli_case(case, Path(tmp))
        log(f"phase 1 {case.name}: ok")


# ---------------------------------------------------------------------------
# Phases 2 and 3: decoders vs their NumPy references
# ---------------------------------------------------------------------------


def channel(n: int, frames: int, qber: float, seed: int):
    """Alice's keys and Bob's LLRs with an exact error count per frame."""
    rng = np.random.default_rng(seed)
    alice = rng.integers(0, 2, (frames, n)).astype(np.int8)
    bob = alice.copy()
    ne = int(n * qber)
    for f in range(frames):
        bob[f, rng.permutation(n)[:ne]] ^= 1
    q = ne / n
    log_p = np.log((1.0 - q) / q)
    return alice, np.where(bob == 1, -log_p, log_p)


FACTORS = {0: (1.0, 1.0), 1: (1.0, 1.0), 2: (0.65, 1.0), 3: (0.3, 1.0),
           4: (0.88, 0.5), 5: (0.5, 1.0)}


def phase_layered(qc, frames: int = 16, qber: float = 0.03,
                  max_iterations: int = 100) -> None:
    import jax
    import jax.numpy as jnp

    from qkd_ldpc_v_tpu.config import DecodingAlgorithm
    from qkd_ldpc_v_tpu.models.layout import layout_for
    from qkd_ldpc_v_tpu.ops.channel import calculate_syndrome
    from qkd_ldpc_v_tpu.ops.qc_decoder import make_qc_decoder
    from qkd_ldpc_v_tpu.oracle import layered_oracle

    alice, llr = channel(qc.num_bit_nodes, frames, qber, seed=2)
    llr = llr.astype(np.float32)
    syn = np.asarray(calculate_syndrome(layout_for(qc.to_hmatrix()),
                                        jnp.asarray(alice)))
    for alg in (DecodingAlgorithm.NMSA, DecodingAlgorithm.OMSA,
                DecodingAlgorithm.ANMSA, DecodingAlgorithm.AOMSA):
        p, s = FACTORS[int(alg)]
        dec = jax.jit(make_qc_decoder(qc, alg, max_iterations, False,
                                      schedule="layered"))
        res = jax.device_get(dec(jnp.asarray(llr), jnp.asarray(syn), p, s,
                                 0.0))
        for f in range(frames):
            d_o, it_o, ok_o = layered_oracle(qc, llr[f], syn[f], alg, p,
                                             max_iterations, secondary=s)
            if (bool(res.syndromes_match[f]) != ok_o
                    or int(res.iterations[f]) != it_o
                    or not np.array_equal(res.decision[f], d_o)):
                raise AssertionError(
                    f"layered {alg.name} frame {f}: device "
                    f"(ok={bool(res.syndromes_match[f])}, "
                    f"iters={int(res.iterations[f])}) vs oracle "
                    f"(ok={ok_o}, iters={it_o}) or decisions differ"
                )
        log(f"phase 2 layered {alg.name}: {frames}/{frames} frames "
            f"bit-exact, mean sweeps {np.mean(res.iterations):.2f}")


def phase_flooding(matrix, frames: int = 16, qber: float = 0.015,
                   max_iterations: int = 100) -> None:
    import jax
    import jax.numpy as jnp

    from qkd_ldpc_v_tpu.config import DecodingAlgorithm
    from qkd_ldpc_v_tpu.models.layout import layout_for
    from qkd_ldpc_v_tpu.ops.channel import calculate_syndrome
    from qkd_ldpc_v_tpu.ops.decoders import get_decoder
    from qkd_ldpc_v_tpu.oracle import decode_oracle

    jax.config.update("jax_enable_x64", True)
    layout = layout_for(matrix)
    alice, llr = channel(matrix.num_bit_nodes, frames, qber, seed=3)
    syn = np.asarray(calculate_syndrome(layout, jnp.asarray(alice)))
    for alg in DecodingAlgorithm:
        p, s = FACTORS[int(alg)]
        r64 = jax.device_get(get_decoder(
            layout, alg, max_iterations, False, dtype=jnp.float64
        )(jnp.asarray(llr), jnp.asarray(syn), p, s, 0.0))
        r32 = jax.device_get(get_decoder(
            layout, alg, max_iterations, False, dtype=jnp.float32
        )(jnp.asarray(llr, jnp.float32), jnp.asarray(syn), p, s, 0.0))
        exact = 0
        agree = 0
        for f in range(frames):
            d_o, ok_o, it_o = decode_oracle(matrix, llr[f], syn[f], int(alg),
                                            max_iterations, p, s)
            exact += (bool(r64.syndromes_match[f]) == ok_o
                      and int(r64.iterations[f]) == it_o
                      and np.array_equal(r64.decision[f], d_o))
            agree += bool(r64.syndromes_match[f]) == ok_o
        f32_agree = float(np.mean(r32.syndromes_match == r64.syndromes_match))
        log(f"phase 3 flooding {alg.name}: f64 vs oracle bit-exact "
            f"{exact}/{frames}, convergence agreement {agree}/{frames}; "
            f"f32 vs f64 agreement {f32_agree:.3f}; mean iters f64 "
            f"{np.mean(r64.iterations):.2f} f32 {np.mean(r32.iterations):.2f}")
        if alg.uses_scaling_factors:  # the min-sum family
            if exact != frames:
                raise AssertionError(
                    f"flooding {alg.name}: f64 min-sum is not bit-exact vs "
                    f"the oracle on {frames - exact} of {frames} frames"
                )
        elif agree / frames < MIN_FRAME_AGREEMENT:
            raise AssertionError(
                f"flooding {alg.name}: f64 vs oracle frame agreement "
                f"{agree / frames} below {MIN_FRAME_AGREEMENT}"
            )
        if f32_agree < MIN_FRAME_AGREEMENT:
            raise AssertionError(
                f"flooding {alg.name}: f32 vs f64 frame agreement "
                f"{f32_agree} below {MIN_FRAME_AGREEMENT}"
            )


# ---------------------------------------------------------------------------
# Phase 4: the data mesh over four cards
# ---------------------------------------------------------------------------


def phase_mesh(matrix, per_card_batch: int = 4096, n_cards: int = 4,
               qber: float = 0.03, max_iterations: int = 100) -> None:
    import jax
    import jax.numpy as jnp

    from qkd_ldpc_v_tpu.config import Config, DecodingAlgorithm, RQBERRange
    from qkd_ldpc_v_tpu.ops.channel import exact_error_count, trial_keys
    from qkd_ldpc_v_tpu.parallel import (
        make_data_mesh, mesh_step_factory, sharded_step,
    )
    from qkd_ldpc_v_tpu.rate_adapt import HMatrixParams
    from qkd_ldpc_v_tpu.simulation import (
        ScalingFactors, SimCombination, _build_step, make_frame_plan,
        run_combination,
    )

    if len(jax.devices()) < n_cards:
        raise SystemExit(f"chip_smoke: --four-cards needs {n_cards} devices, "
                         f"found {len(jax.devices())}")
    mesh = make_data_mesh(n_cards)
    global_batch = per_card_batch * n_cards
    cfg = Config(
        trials_number=global_batch,
        simulation_seed=11,
        decoding_algorithm=DecodingAlgorithm.NMSA,
        decoding_alg_max_iterations=max_iterations,
        r_qber_ranges=(RQBERRange(0.99, qber, qber, 0.01),),
        batch_size=global_batch,
        phase1_iterations=0,
    )
    comb = SimCombination(qber, HMatrixParams(), ScalingFactors(primary=0.8))

    t0 = time.perf_counter()
    data = run_combination(matrix, comb, cfg, 0,
                           step_factory=mesh_step_factory(mesh))
    reduced = run_combination(
        matrix, comb, cfg, 0,
        step_factory=mesh_step_factory(mesh, reduce_stats=True),
    )
    log(f"phase 4 run_combination: data FER "
        f"{1 - data.ratio_trials_success_ldpc:.5f} mean iters "
        f"{data.iter_success_mean:.3f}; reduce FER "
        f"{1 - reduced.ratio_trials_success_ldpc:.5f} mean iters "
        f"{reduced.iter_success_mean:.3f} ({time.perf_counter() - t0:.1f} s)")
    for field in ("ratio_trials_success_decoding", "ratio_trials_success_ldpc",
                  "iter_success_min", "iter_success_max"):
        if getattr(data, field) != getattr(reduced, field):
            raise AssertionError(f"mesh {field}: data {getattr(data, field)} "
                                 f"vs reduce {getattr(reduced, field)}")
    if not np.isclose(data.iter_success_mean, reduced.iter_success_mean,
                      rtol=1e-9):
        raise AssertionError("mesh iter_success_mean differs between modes")

    n = matrix.num_bit_nodes
    ne = exact_error_count(n, qber)
    pos_class, payload_gather = make_frame_plan(n, HMatrixParams())
    ka, ke, kp = trial_keys(cfg.simulation_seed, 0, 0)
    f = jnp.float32
    scalars = (jnp.asarray(ne / n, f), jnp.int32(ne), jnp.asarray(0.8, f),
               jnp.asarray(0.0, f), jnp.asarray(0.0, f),
               jnp.asarray(pos_class), jnp.asarray(payload_gather))
    step = sharded_step(matrix, cfg, global_batch, mesh)
    outs = step(ka, ke, kp, *scalars)
    for out in outs:
        shards = out.addressable_shards
        devices = {s.device for s in shards}
        if len(devices) != n_cards or any(
                s.data.shape[0] != per_card_batch for s in shards):
            raise AssertionError(
                f"mesh output not split over {n_cards} cards: "
                f"{[(str(s.device), s.data.shape) for s in shards]}"
            )
    syn, keys, iters = (np.asarray(o) for o in outs)
    local = jax.jit(_build_step(
        matrix, cfg.decoding_algorithm, max_iterations,
        cfg.enable_msg_llr_threshold, False, per_card_batch, cfg.dtype,
    ))
    for i in range(n_cards):
        fold = [jax.random.fold_in(k, i) for k in (ka, ke, kp)]
        ref = jax.device_get(local(*fold, *scalars))
        sl = slice(i * per_card_batch, (i + 1) * per_card_batch)
        for name, got, want in zip(("syndromes_match", "keys_match",
                                    "iterations"), (syn, keys, iters), ref):
            if not np.array_equal(got[sl], want):
                raise AssertionError(f"mesh shard {i} {name} differs from "
                                     "the one-card local step")
    log(f"phase 4 shards: {n_cards} shards of {per_card_batch} frames equal "
        "the one-card local step")

    rstep = sharded_step(matrix, cfg, global_batch, mesh, reduce_stats=True)
    got = [float(v) for v in jax.device_get(
        rstep(ka, ke, kp, *scalars, jnp.int32(global_batch)))]
    ok = syn.astype(bool)
    it_ok = iters[ok].astype(np.float64)
    mean = it_ok.mean() if ok.any() else 0.0
    want = [float(ok.sum()), float((ok & keys.astype(bool)).sum()),
            float(it_ok.sum()), float(((it_ok - mean) ** 2).sum()),
            float(it_ok.min()) if ok.any() else float(np.iinfo(np.int32).max),
            float(it_ok.max()) if ok.any() else -1.0]
    names = ("n_dec", "n_ldpc", "iter_sum", "iter_m2", "iter_min", "iter_max")
    for name, g, w in zip(names, got, want):
        # iter_m2 sums squared deviations in the device's float32; the
        # others are integer counts, exact in float32 at these sizes.
        tol = 1e-5 * max(abs(w), 1.0) if name == "iter_m2" else 0.0
        if abs(g - w) > tol:
            raise AssertionError(f"reduce {name}: device {g} vs host {w}")
    log("phase 4 reduce: six scalars equal the host aggregate "
        + ", ".join(f"{k}={v:g}" for k, v in zip(names, got)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-card data-mesh phase")
    args = parser.parse_args(argv)

    device = device_check()
    from qkd_ldpc_v_tpu.config import MatrixFormat
    from qkd_ldpc_v_tpu.models.hmatrix import read_matrix
    from qkd_ldpc_v_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    logging.basicConfig(level=logging.WARNING, format="%(message)s")
    t0 = time.perf_counter()
    alist_10k = read_matrix(MATRICES / ALIST_10K, MatrixFormat.ALIST)
    if args.four_cards:
        phase_mesh(alist_10k)
    else:
        phase_cli()
        phase_layered(read_matrix(MATRICES / QC_10K, MatrixFormat.QC).qc)
        phase_flooding(alist_10k)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0



if __name__ == "__main__":
    sys.exit(main())
