"""Subprocess worker for tests/test_distributed.py.

Each worker process is one "host" of a two-process CPU fleet: it calls
``initialize_distributed`` (the multi-host bring-up wrapper,
parallel/driver.py) against a localhost coordinator, joins the global
4-device mesh (2 processes x 2 local CPU devices), runs the reduce-mode
``sharded_step`` — the fully-distributed aggregation path whose per-chunk
host traffic is six psum scalars — and writes those scalars to a JSON
file for the parent test to compare against the single-process run.

Not a test module (no ``test_`` prefix); invoked as
``python distributed_worker.py <coordinator> <num_processes> <pid> <out>``.
"""

import json
import os
import sys


def main() -> int:
    addr, nproc, pid, outfile = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )
    # Override both the env var and the live config (as tests/conftest.py).
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_num_cpu_devices", 2)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    from qkd_ldpc_v_tpu.parallel.driver import (
        initialize_distributed, make_data_mesh, sharded_step,
    )

    initialize_distributed(addr, nproc, pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 2 * nproc, jax.devices()

    import jax.numpy as jnp

    from qkd_ldpc_v_tpu.config import Config, DecodingAlgorithm, RQBERRange
    from qkd_ldpc_v_tpu.models.generator import generate_regular_ldpc
    from qkd_ldpc_v_tpu.ops.channel import trial_keys
    from qkd_ldpc_v_tpu.rate_adapt import HMatrixParams
    from qkd_ldpc_v_tpu.simulation import make_frame_plan

    # Same matrix / trial inputs as the parent's single-process reference
    # run (tests/test_distributed.py keeps these literals in sync).
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
    mesh = make_data_mesh()
    step = sharded_step(matrix, cfg, global_batch=16, mesh=mesh,
                        reduce_stats=True)
    ka, ke, kp = trial_keys(9, 0, 0)
    pos_class, gather = make_frame_plan(512, HMatrixParams())
    out = step(
        ka, ke, kp,
        jnp.float32(0.02), jnp.int32(10),
        jnp.float32(1.0), jnp.float32(1.0), jnp.float32(0.0),
        jnp.asarray(pos_class), jnp.asarray(gather),
        jnp.int32(13),  # mask the 3-frame surplus on device
    )
    scalars = [float(x) for x in jax.device_get(out)]
    with open(outfile, "w") as f:
        json.dump({"pid": pid, "stats": scalars}, f)
    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
