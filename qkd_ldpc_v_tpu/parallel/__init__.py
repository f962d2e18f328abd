"""Distribution layer: data-mesh sharding of the Monte-Carlo frame batch.

The reference's only parallelism is a shared-memory thread pool over trials
(reference: src/simulation.cpp:721, 740-746). The device equivalent is a
``jax.sharding.Mesh`` over a ``data`` axis: each device decodes its shard of
the frame batch, and statistics are reduced with XLA collectives.
"""

from qkd_ldpc_v_tpu.parallel.driver import (  # noqa: F401
    initialize_distributed,
    make_data_mesh,
    mesh_step_factory,
    sharded_step,
)
