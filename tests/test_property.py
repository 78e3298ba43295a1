"""Property-style randomized cross-format consistency tests.

Every format's SpMV must agree with the host COO golden and with every
other format on the same matrix — the assertion-based version of the
reference's cross-format checksum eyeballing (SURVEY §4 pattern 3,
``hellPerf.cpp:234,297,359``).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from spgpu_tpu import convert, ops
from spgpu_tpu.formats.coo import CooMatrix


def _random_coo(rng, n_rows, n_cols, density, dtype):
    m = max(int(n_rows * n_cols * density), 1)
    rows = rng.integers(0, n_rows, m)
    cols = rng.integers(0, n_cols, m)
    vals = rng.standard_normal(m).astype(dtype)
    return CooMatrix(rows.astype(np.int64), cols.astype(np.int64), vals,
                     n_rows, n_cols)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_all_formats_agree_random(seed):
    rng = np.random.default_rng(seed)
    n_rows = int(rng.integers(5, 400))
    n_cols = int(rng.integers(5, 400))
    coo = _random_coo(rng, n_rows, n_cols, 0.05, np.float32)
    dedup = coo.sum_duplicates()  # DIA-family plain-stores duplicates
    x = rng.standard_normal(n_cols).astype(np.float32)
    alpha = float(rng.standard_normal())
    beta = float(rng.standard_normal())
    y = rng.standard_normal(n_rows).astype(np.float32)
    ref = alpha * dedup.spmv(x) + beta * y

    converters = [
        convert.coo_to_ell, convert.coo_to_hell,
        convert.coo_to_dia, convert.coo_to_hdia, convert.coo_to_sdia,
        lambda c: convert.coo_to_bcoo(c, 8, 8),
    ]
    for conv in converters:
        a = conv(dedup)
        z = ops.spmv(a, jnp.asarray(x), alpha=alpha, beta=beta,
                     y=jnp.asarray(y))
        np.testing.assert_allclose(
            np.asarray(z), ref, rtol=1e-4, atol=1e-4,
            err_msg=f"format {type(a).__name__}",
        )


@pytest.mark.parametrize("seed", [7, 8])
def test_multi_rhs_consistency(seed):
    rng = np.random.default_rng(seed)
    coo = _random_coo(rng, 300, 300, 0.03, np.float32).sum_duplicates()
    X = rng.standard_normal((4, 300)).astype(np.float32)
    hell = convert.coo_to_hell(coo)
    z_hell = ops.hell_spmv(hell, jnp.asarray(X))
    for a in (convert.coo_to_ell(coo), convert.coo_to_hdia(coo),
              convert.coo_to_sdia(coo)):
        z = ops.spmv(a, jnp.asarray(X))
        np.testing.assert_allclose(np.asarray(z_hell), np.asarray(z),
                                   rtol=1e-4, atol=1e-4)


def test_base_index_parity():
    """Fortran 1-based triples (the PSBLAS baseIndex contract)."""
    rows1 = np.asarray([1, 2, 3, 3])
    cols1 = np.asarray([1, 3, 2, 3])
    vals = np.asarray([1.0, 2.0, 3.0, 4.0], np.float32)
    a1 = CooMatrix.from_arrays(rows1, cols1, vals, 3, 3, base_index=1)
    a0 = CooMatrix.from_arrays(rows1 - 1, cols1 - 1, vals, 3, 3)
    np.testing.assert_array_equal(a1.to_dense(), a0.to_dense())
