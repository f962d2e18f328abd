"""Statistical FER parity campaign vs the compiled reference decoder.

Runs matched-channel Monte-Carlo trials (identical alice/bob keys) through
BOTH the reference C++ decoder core (tools/reference_harness, compiled from
/root/reference/src) and this framework's production f32 path, at
production scale (reference 10k matrix, 1e4 trials, several QBER points,
NMSA + AOMSA), and reports FER agreement with binomial confidence
intervals. Because the channels are identical, the per-frame agreement rate
is reported too (f64 mode is bit-exact per frame — tests/
test_reference_parity.py; f32 is the speed path whose FER must match
statistically).

Output: a markdown table (append to PARITY.md §"FER parity at production
scale") plus one JSON line per point.

Usage: python scripts/fer_parity_campaign.py [trials] [--cpu]
         [--matrix=PATH] [--points=NAME:QBER,...] [--chunk=N]
         [--qc] [--schedule=flooding[,layered]]

Both sides decode the driver's own channel realizations: each chunk's keys
come from the same threefry keys the compiled trial step
(``simulation.get_step``) uses, and the step then decodes them on the
device. --matrix accepts any alist matrix. With --qc the matrix is read in
the QC shift format and expanded to alist in a temp file for the C++ side
(the reference has no QC reader); --schedule accepts a comma list so one
pass over the expensive C++ side serves every schedule on identical
channels. Layered rows compare the beyond-reference layered schedule's FER
against the flooding C++ (frame agreement is then informational — the
schedules converge on different frames near threshold).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

ROOT = Path(__file__).resolve().parents[1]
HARNESS = ROOT / "tools" / "reference_harness" / "ref_harness"
MATRIX = (ROOT / "sparse_matrices" / "matrices_alist"
          / "(N=10240,M=2841,R=0.72,CW=4,SEED=66).mtrx")
CHUNK = 1000

POINTS = [
    # (algorithm id, name, primary, secondary, qber)
    (2, "NMSA", 0.8, 1.0, 0.025),
    (2, "NMSA", 0.8, 1.0, 0.03),
    (5, "AOMSA", 0.5, 1.0, 0.03),
]

# --all: every decoding algorithm at its working point (the first three
# points above stay, so the committed table rows reproduce). OMSA is weak on
# this code (best beta ~0.7, FER ~7% at QBER 0.03 in both implementations);
# it gets a clean below-threshold point at 0.025 and the near-threshold one.
ALL_POINTS = POINTS + [
    (0, "SPA", 1.0, 1.0, 0.03),
    (1, "SPA-LIN", 1.0, 1.0, 0.03),
    (3, "OMSA", 0.7, 1.0, 0.025),
    (3, "OMSA", 0.7, 1.0, 0.03),
    (4, "ANMSA", 0.8, 0.6, 0.03),
    (5, "AOMSA", 0.5, 1.0, 0.035),
]


def run_reference(matrix_path, alg, primary, secondary, alice, bob, qber):
    batch = alice.shape[0]
    lines = [f"{batch} {qber:.10f}"]
    lines += [" ".join(map(str, row)) for row in alice]
    lines += [" ".join(map(str, row)) for row in bob]
    out = subprocess.run(
        [str(HARNESS), str(matrix_path), "1", str(alg), "100",
         str(primary), str(secondary), "0"],
        input="\n".join(lines) + "\n",
        capture_output=True, text=True, check=True,
    )
    conv, keys, iters = [], [], []
    for line in out.stdout.strip().splitlines():
        toks = line.split()
        iters.append(int(toks[0]))
        conv.append(toks[1] == "1")
        keys.append(toks[2] == "1")
    return np.array(conv), np.array(keys), np.array(iters)


def wilson_ci(k, n, z=1.96):
    if n == 0:
        return (0.0, 1.0)
    p = k / n
    d = 1 + z * z / n
    c = (p + z * z / (2 * n)) / d
    h = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / d
    return (max(0.0, c - h), min(1.0, c + h))


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    trials = int(args[0]) if args else 10000
    force_cpu = "--cpu" in sys.argv
    points = ALL_POINTS if "--all" in sys.argv else POINTS
    only = [a.split("=", 1)[1] for a in sys.argv if a.startswith("--only=")]
    if only:
        names = set(only[0].split(","))
        points = [p for p in points if p[1] in names]
    opts = dict(
        a.lstrip("-").split("=", 1)
        for a in sys.argv[1:]
        if a.startswith("--") and "=" in a
    )
    matrix_path = Path(opts.get("matrix", MATRIX))
    chunk = int(opts.get("chunk", CHUNK))
    if "points" in opts:
        # NAME:QBER[:primary[:secondary]] — algorithm ids from the
        # reference's enum order.
        ids = {"SPA": 0, "SPA-LIN": 1, "NMSA": 2, "OMSA": 3,
               "ANMSA": 4, "AOMSA": 5}
        defaults = {"SPA": (1.0, 1.0), "SPA-LIN": (1.0, 1.0),
                    "NMSA": (0.8, 1.0), "OMSA": (0.5, 1.0),
                    "ANMSA": (0.8, 0.6), "AOMSA": (0.5, 1.0)}
        points = []
        for spec in opts["points"].split(","):
            parts = spec.split(":")
            name = parts[0]
            qber = float(parts[1])
            prim = float(parts[2]) if len(parts) > 2 else defaults[name][0]
            sec = float(parts[3]) if len(parts) > 3 else defaults[name][1]
            points.append((ids[name], name, prim, sec, qber))
    if force_cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    if not HARNESS.exists():
        subprocess.run(["make", "-C", str(HARNESS.parent)], check=True)

    import jax

    from qkd_ldpc_v_tpu.utils import enable_compilation_cache
    enable_compilation_cache()

    import jax.numpy as jnp

    from qkd_ldpc_v_tpu.config import Config, DecodingAlgorithm
    from qkd_ldpc_v_tpu.models.hmatrix import read_sparse_matrix_alist
    from qkd_ldpc_v_tpu.ops.channel import (
        exact_error_count, generate_keys, inject_errors, trial_keys,
    )
    from qkd_ldpc_v_tpu.rate_adapt import HMatrixParams
    from qkd_ldpc_v_tpu.simulation import get_step, make_frame_plan

    use_qc = "--qc" in sys.argv
    schedules = opts.get("schedule", "flooding").split(",")
    if use_qc:
        import tempfile

        from qkd_ldpc_v_tpu.config import MatrixFormat
        from qkd_ldpc_v_tpu.models.hmatrix import read_matrix, write_alist

        matrix = read_matrix(matrix_path, MatrixFormat.QC)
        # The reference reads alist, not QC shifts: expand for the C++ side.
        tmp = tempfile.NamedTemporaryFile(
            suffix=".mtrx", prefix="qc_expanded_", delete=False
        )
        tmp.close()
        write_alist(matrix, tmp.name)
        matrix_path = Path(tmp.name)
    else:
        matrix = read_sparse_matrix_alist(matrix_path)
        schedules = ["flooding"]
    n = matrix.num_bit_nodes
    frame_plan = [jnp.asarray(a) for a in make_frame_plan(n, HMatrixParams())]
    print(f"device: {jax.devices()[0]}  trials/point: {trials}  "
          f"N={n}  schedules={'+'.join(schedules)}",
          file=sys.stderr, flush=True)

    rows = ["| alg | QBER | FER ref (95% CI) | FER jax (95% CI) | "
            "frame agreement | iters ref/jax |",
            "|---|---|---|---|---|---|"]
    for alg, name, primary, secondary, qber in points:
        # One compiled driver step per schedule; the C++ side runs once per
        # chunk and every step scores against it on the identical channels.
        paths = []
        for schedule in schedules:
            cfg = Config(
                trials_number=trials,
                decoding_algorithm=DecodingAlgorithm(alg),
                decoding_alg_max_iterations=100,
                batch_size=chunk,
                schedule=schedule,
            )
            paths.append({
                "label": schedule if use_qc else "",
                "step": get_step(matrix, cfg, chunk),
                "oc": 0, "ok": 0, "agree": 0, "oi_sum": 0,
            })
        ne = exact_error_count(n, qber)
        q = ne / n
        scalars = (jnp.float32(q), jnp.int32(ne), jnp.float32(primary),
                   jnp.float32(secondary), jnp.float32(0.0), *frame_plan)
        rc = rk = n_done = 0
        ri_sum = 0
        chunk_index = 0
        t0 = time.perf_counter()
        while n_done < trials:
            take = min(chunk, trials - n_done)
            ka, ke, kp = trial_keys(977 + alg, 0, chunk_index)
            alice = generate_keys(ka, chunk, n)
            bob = inject_errors(ke, alice, ne)
            conv_r, keys_r, iters_r = run_reference(
                matrix_path, alg, primary, secondary,
                np.asarray(alice)[:take], np.asarray(bob)[:take], q,
            )
            ok_r = conv_r & keys_r
            rc += conv_r.sum(); rk += ok_r.sum()
            ri_sum += iters_r[conv_r].sum()
            for p in paths:
                conv_o, keys_o, iters_o = (
                    np.asarray(x)[:take]
                    for x in p["step"](ka, ke, kp, *scalars)
                )
                ok_o = conv_o & keys_o
                p["oc"] += conv_o.sum(); p["ok"] += ok_o.sum()
                p["agree"] += (ok_r == ok_o).sum()
                p["oi_sum"] += iters_o[conv_o].sum()
            n_done += take
            chunk_index += 1
            print(f"  {name} q={qber}: {n_done}/{trials} "
                  f"({time.perf_counter()-t0:.0f}s)",
                  file=sys.stderr, flush=True)
        fer_r = 1 - rk / n_done
        lo_r, hi_r = wilson_ci(n_done - rk, n_done)
        for p in paths:
            fer_o = 1 - p["ok"] / n_done
            lo_o, hi_o = wilson_ci(n_done - p["ok"], n_done)
            overlap = not (hi_r < lo_o or hi_o < lo_r)
            label = f" {p['label']}" if p["label"] else ""
            rows.append(
                f"| {name}({primary}"
                + (f",{secondary}" if alg >= 4 else "")
                + f"){label} | {qber} | {fer_r:.4f} [{lo_r:.4f},{hi_r:.4f}] "
                f"| {fer_o:.4f} [{lo_o:.4f},{hi_o:.4f}] "
                f"| {p['agree']/n_done:.4f} | {ri_sum/max(rc,1):.1f}/"
                f"{p['oi_sum']/max(p['oc'],1):.1f} |"
            )
            record = {
                "alg": name, "qber": qber, "trials": n_done,
                "schedule": p["label"] or None,
                "fer_ref": round(fer_r, 5),
                "fer_jax": round(fer_o, 5),
                "ci_overlap": overlap,
                "frame_agreement": round(p["agree"] / n_done, 5),
            }
            print(json.dumps(record), flush=True)
    print("\n".join(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
