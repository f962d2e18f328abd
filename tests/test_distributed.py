"""Two-process ``jax.distributed`` smoke test (SURVEY.md §5 distributed
backend; round-3 verdict item 5).

Everything else in the multi-device story — sharded_step tests, the
dryrun, the CPU-mesh scaling ladder — runs single-process ``shard_map``;
this test covers the one remaining seam, ``initialize_distributed``
(parallel/driver.py), by spawning two CPU-backend processes against a
localhost coordinator and running the reduce-mode ``sharded_step`` over
the resulting 2-process x 2-device global mesh. The six psum scalars
each worker reports must equal the single-process run on an identical
4-device mesh: same SPMD program, same per-device PRNG folding, so the
statistics are invariant to how the mesh is carved into processes.

The reference's closest analogue is its intra-process thread pool
(src/simulation.cpp:693-768); multi-host bring-up is surface
beyond it.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qkd_ldpc_v_tpu.config import Config, DecodingAlgorithm, RQBERRange
from qkd_ldpc_v_tpu.models.generator import generate_regular_ldpc
from qkd_ldpc_v_tpu.ops.channel import trial_keys
from qkd_ldpc_v_tpu.parallel.driver import make_data_mesh, sharded_step
from qkd_ldpc_v_tpu.rate_adapt import HMatrixParams
from qkd_ldpc_v_tpu.simulation import make_frame_plan

WORKER = Path(__file__).resolve().parent / "distributed_worker.py"


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _single_process_reference():
    """The same program on a single-process 4-device mesh (the parent's
    8 virtual devices carry it; fold indices 0..3 match the fleet's)."""
    matrix = generate_regular_ldpc(
        num_bits=512, num_checks=256, column_weight=3, seed=3
    )
    cfg = Config(
        trials_number=16,
        simulation_seed=9,
        decoding_algorithm=DecodingAlgorithm.SPA,
        decoding_alg_max_iterations=40,
        r_qber_ranges=(RQBERRange(0.99, 0.02, 0.02, 0.01),),
    )
    mesh = make_data_mesh(n_devices=4)
    step = sharded_step(matrix, cfg, global_batch=16, mesh=mesh,
                        reduce_stats=True)
    ka, ke, kp = trial_keys(9, 0, 0)
    pos_class, gather = make_frame_plan(512, HMatrixParams())
    out = step(
        ka, ke, kp,
        jnp.float32(0.02), jnp.int32(10),
        jnp.float32(1.0), jnp.float32(1.0), jnp.float32(0.0),
        jnp.asarray(pos_class), jnp.asarray(gather),
        jnp.int32(13),
    )
    return [float(x) for x in jax.device_get(out)]


def test_two_process_reduce_matches_single_process(tmp_path):
    try:
        port = _free_port()
    except OSError as e:  # pragma: no cover - sandboxed CI without sockets
        pytest.skip(f"no local sockets available: {e}")
    addr = f"127.0.0.1:{port}"

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_ENABLE_X64"] = "1"
    # The workers pick their own local device count via jax_num_cpu_devices;
    # scrub the parent's 8-device XLA flag so it doesn't override them.
    env.pop("XLA_FLAGS", None)
    procs = []
    outs = []
    try:
        for pid in range(2):
            out = tmp_path / f"worker{pid}.json"
            outs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), addr, "2", str(pid), str(out)],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
                cwd=str(WORKER.parent.parent),
            ))
    except OSError as e:  # pragma: no cover - subprocess forbidden
        for p in procs:
            p.kill()
        pytest.skip(f"cannot spawn worker processes: {e}")

    failures = []
    for pid, p in enumerate(procs):
        try:
            stdout, stderr = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, stderr = p.communicate()
            failures.append(f"worker {pid} timed out\n{stderr[-2000:]}")
            continue
        if p.returncode != 0:
            failures.append(
                f"worker {pid} rc={p.returncode}\n{stderr[-2000:]}"
            )
    assert not failures, "\n".join(failures)

    expected = _single_process_reference()
    for pid, out in enumerate(outs):
        got = json.loads(out.read_text())
        assert got["pid"] == pid
        # Counts and min/max are exact; the f64 iteration sums tolerate
        # collective-order differences between gloo and the local ring.
        np.testing.assert_allclose(
            got["stats"], expected, rtol=1e-12, atol=0.0,
            err_msg=f"worker {pid} psum scalars diverge",
        )
    # Sanity: the masked 13-trial chunk actually decoded something.
    assert expected[0] > 0
