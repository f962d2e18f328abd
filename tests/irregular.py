"""A small irregular code shared by several test files: mixed column
weights 2..5 and mixed row weights, so degree-grouped layouts get several
groups on both sides."""

import numpy as np

from qkd_ldpc_v_tpu.models.hmatrix import from_dense


def irregular_matrix(seed: int = 11, n: int = 288, m: int = 144):
    rng = np.random.default_rng(seed)
    dense = np.zeros((m, n), dtype=np.int8)
    for col in range(n):
        w = 2 + (col % 4)
        rows = rng.choice(m, size=w, replace=False)
        dense[rows, col] = 1
    for row in range(m):
        if dense[row].sum() == 0:
            dense[row, rng.integers(0, n)] = 1
    return from_dense(dense)
