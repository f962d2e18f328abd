"""Test-side alias of the packaged reference oracles (they live in
qkd_ldpc_v_tpu.oracle so the tracing subsystem, users' verification mode
and chip_smoke.py can share them)."""

from qkd_ldpc_v_tpu.oracle import (  # noqa: F401
    DBL_MAX,
    calculate_syndrome,
    decode_oracle,
    layered_oracle,
)
