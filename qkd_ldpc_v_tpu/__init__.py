"""qkd_ldpc_v_tpu — batched QKD LDPC information-reconciliation framework.

A ground-up JAX/XLA re-design of the capabilities of the reference C++
simulator (ColdCloudd/QKD_LDPC_V): LDPC-based information reconciliation
for Quantum Key Distribution, with six belief-propagation decoder variants,
code-rate adaptation by puncturing/shortening, privacy maintenance, and a
Monte-Carlo sweep driver.

Design principles (accelerator-first, not a port):
  * Decode a *batch* of frames simultaneously: the parity-check matrix is
    compiled once into padded, static-shape edge-index tables; every decoder
    becomes gathers + masked reductions inside one ``lax.while_loop`` with
    per-frame convergence masks.
  * All host-side combinatorics (sweep building, rate adaptation, untainted
    puncturing, privacy-maintenance matching) stay on the host as NumPy;
    only static index vectors cross to the device.
  * Scaling is data-parallel over the frame batch on a ``jax.sharding.Mesh``
    with XLA collectives for statistics aggregation.
"""

__version__ = "0.2.0"

from qkd_ldpc_v_tpu.config import (  # noqa: F401
    Config,
    DecodingAlgorithm,
    MatrixFormat,
    parse_config_data,
)
from qkd_ldpc_v_tpu.models.hmatrix import HMatrix, read_matrix  # noqa: F401
from qkd_ldpc_v_tpu.models.layout import EdgeLayout, compile_layout  # noqa: F401
from qkd_ldpc_v_tpu.models.qc import (  # noqa: F401
    QCMatrix,
    generate_qc_ldpc,
    generate_qc_peg,
    read_qc_matrix,
    write_qc_matrix,
)
from qkd_ldpc_v_tpu.protocol import (  # noqa: F401
    ProtocolResult,
    ProtocolSpec,
    make_protocol_spec,
    qkd_ldpc,
    qkd_ldpc_rate_adapt,
)
from qkd_ldpc_v_tpu.simulation import (  # noqa: F401
    SimResult,
    prepare_sim_inputs,
    qkd_ldpc_batch_simulation,
    run_combination,
    write_file,
)
