"""Test configuration: force an 8-device CPU mesh and enable x64.

Tests run on a virtual CPU mesh (``xla_force_host_platform_device_count=8``)
so sharding paths are exercised without a GPU; f64 is enabled for the
oracle-parity tests (the reference decodes in double precision).
"""

import os

# Override both the env var and the live config, in case jax was imported
# before this file with another platform.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from qkd_ldpc_v_tpu.models.generator import generate_regular_ldpc  # noqa: E402


REFERENCE_DIR = "/root/reference"


def reference_available() -> bool:
    return os.path.isdir(REFERENCE_DIR)


@pytest.fixture(scope="session")
def small_matrix():
    """A small random regular code for decoder tests."""
    return generate_regular_ldpc(num_bits=96, num_checks=48, column_weight=3, seed=7)


@pytest.fixture(scope="session")
def medium_matrix():
    return generate_regular_ldpc(num_bits=512, num_checks=256, column_weight=3, seed=3)


@pytest.fixture(scope="session")
def johnson_matrix():
    """The 4x6 parity-check matrix of Johnson, *Introducing LDPC Codes*,
    example 2.5 (the reference uses it as its textbook oracle:
    example/qkd_ldpc_example.cpp:28-33 and the asset
    sparse_matrices/matrices_uncompressed/(N=6,K=2,M=4,R=0.34).mtrx)."""
    from qkd_ldpc_v_tpu.models.hmatrix import from_dense

    dense = np.array(
        [
            [1, 1, 0, 1, 0, 0],
            [0, 1, 1, 0, 1, 0],
            [1, 0, 0, 0, 1, 1],
            [0, 0, 1, 1, 0, 1],
        ],
        dtype=np.int8,
    )
    return from_dense(dense)
