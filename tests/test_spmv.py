"""SpMV/SpMM correctness for every format vs the COO golden host SpMV
(SURVEY §4 pattern 1), across dtypes, alpha/beta, OELL permutation,
multi-RHS, and cross-format checksum consistency (§4 pattern 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spgpu_tpu import convert, ops
from spgpu_tpu.utils import ctest_fixture, laplacian_2d, random_banded, random_irregular

FIX = {
    "laplacian": laplacian_2d(11, 9),
    "irregular": random_irregular(257, 201, avg_nnz_per_row=6.0, seed=11),
    "banded": random_banded(300, bands=7, wander=2, seed=12),
}


def _mk(coo, dtype, rng):
    coo = type(coo)(coo.rows, coo.cols, coo.values.astype(dtype), coo.n_rows, coo.n_cols)
    x = rng.standard_normal(coo.n_cols)
    y = rng.standard_normal(coo.n_rows)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        x = x + 1j * rng.standard_normal(coo.n_cols)
        y = y + 1j * rng.standard_normal(coo.n_rows)
    return coo, x.astype(dtype), y.astype(dtype)


def _sdia(coo):
    return convert.coo_to_sdia(coo.sum_duplicates())


#: every SpMV format: converter and op (DIA-class layouts plain-store
#: duplicates, so the SDIA row converts a coalesced COO like solve() does)
FORMATS = {
    "ell": (convert.coo_to_ell, ops.ell_spmv),
    "oell": (lambda c: convert.ell_to_oell(convert.coo_to_ell(c)),
             ops.ell_spmv),
    "hell": (convert.coo_to_hell, ops.hell_spmv),
    "hacked_oell": (lambda c: convert.coo_to_hell(
        c, row_perm=np.asarray(
            convert.ell_to_oell(convert.coo_to_ell(c)).row_perm)),
        ops.hell_spmv),
    "dia": (convert.coo_to_dia, ops.dia_spmv),
    "hdia": (convert.coo_to_hdia, ops.hdia_spmv),
    "sdia": (_sdia, ops.sdia_spmv),
    "bcoo": (lambda c: convert.coo_to_bcoo(c, 8, 8), ops.bcoo_spmv),
}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("name", sorted(FIX))
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64, np.complex128])
def test_all_formats_match_golden(fmt, name, dtype, rng):
    coo, x, y = _mk(FIX[name], dtype, rng)
    alpha, beta = 1.7, -0.3
    ref = alpha * coo.spmv(x) + beta * y
    if np.dtype(dtype) in (np.dtype(np.float32), np.dtype(np.complex64)):
        tol = dict(rtol=2e-5, atol=2e-5)
    else:
        tol = dict(rtol=1e-12, atol=1e-12)
    conv, op = FORMATS[fmt]
    a = conv(coo)
    assert a.dtype == np.dtype(dtype)  # built in its own dtype, no planes
    got = op(a, jnp.asarray(x), alpha, beta, jnp.asarray(y))
    assert got.dtype == np.dtype(dtype)
    np.testing.assert_allclose(np.asarray(got), ref, **tol)


def test_beta_zero_never_reads_y(rng):
    """β==0 must not read y (reference _krn_b0 semantics): y full of NaNs."""
    coo, x, _ = _mk(FIX["laplacian"], np.float64, rng)
    ref = 2.0 * coo.spmv(x)
    y_nan = jnp.full(coo.n_rows, np.nan)
    for a, op in [
        (convert.coo_to_ell(coo), ops.ell_spmv),
        (convert.coo_to_hell(coo), ops.hell_spmv),
        (convert.coo_to_dia(coo), ops.dia_spmv),
        (convert.coo_to_sdia(coo), ops.sdia_spmv),
        (convert.coo_to_hdia(coo), ops.hdia_spmv),
    ]:
        got = op(a, jnp.asarray(x), 2.0, 0.0, y_nan)
        np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-12)


def test_oell_permuted_output(rng):
    coo, x, y = _mk(FIX["irregular"], np.float64, rng)
    oell = convert.ell_to_oell(convert.coo_to_ell(coo))
    ref = 1.5 * coo.spmv(x) + 0.5 * y
    got = ops.ell_spmv(oell, jnp.asarray(x), 1.5, 0.5, jnp.asarray(y))
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-12)


def test_hacked_oell_spmv(rng):
    coo, x, y = _mk(FIX["irregular"], np.float64, rng)
    oell = convert.ell_to_oell(convert.coo_to_ell(coo))
    hell = convert.coo_to_hell(coo, row_perm=np.asarray(oell.row_perm))
    ref = coo.spmv(x)
    got = ops.hell_spmv(hell, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-12)


def test_nors_mode_spmv(rng):
    coo, x, _ = _mk(FIX["laplacian"], np.float64, rng)
    ell = convert.coo_to_ell(coo, store_row_lengths=False)
    np.testing.assert_allclose(
        np.asarray(ops.ell_spmv(ell, jnp.asarray(x))), coo.spmv(x), rtol=1e-12
    )


def test_spmm_multirhs(rng):
    """Fused multi-RHS (the reference loops kernels on the host; SURVEY
    §2.5).  8 RHS per BASELINE config."""
    coo, _, _ = _mk(FIX["irregular"], np.float64, rng)
    X = rng.standard_normal((8, coo.n_cols))
    ref = coo.spmv(X)
    for a, op in [
        (convert.coo_to_ell(coo), ops.ell_spmv),
        (convert.coo_to_hell(coo), ops.hell_spmv),
        (convert.coo_to_dia(coo), ops.dia_spmv),
        (convert.coo_to_sdia(coo), ops.sdia_spmv),
        (convert.coo_to_hdia(coo), ops.hdia_spmv),
        (convert.coo_to_bcoo(coo, 8, 8), ops.bcoo_spmv),
    ]:
        got = op(a, jnp.asarray(X))
        assert got.shape == (8, coo.n_rows)
        np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-12)


def test_cross_format_checksum(rng):
    """§4 pattern 3: dot(z,z) equal across formats — as an assertion, not
    an eyeball (hellPerf.cpp:234,297,359)."""
    coo, x, _ = _mk(FIX["banded"], np.float64, rng)
    xs = jnp.asarray(x)
    sums = []
    for a, op in [
        (convert.coo_to_ell(coo), ops.ell_spmv),
        (convert.coo_to_hell(coo), ops.hell_spmv),
        (convert.coo_to_dia(coo), ops.dia_spmv),
        (convert.coo_to_hdia(coo), ops.hdia_spmv),
    ]:
        z = op(a, xs)
        sums.append(float(ops.dot(z, z)))
    np.testing.assert_allclose(sums, sums[0], rtol=1e-12)


def test_ctest_duplicate_semantics():
    """ctest.c semantics: duplicated diagonal entries both contribute."""
    coo = ctest_fixture(np.float64)
    x = jnp.ones(100)
    for a, op in [
        (convert.coo_to_ell(coo), ops.ell_spmv),
        (convert.coo_to_hell(coo), ops.hell_spmv),
    ]:
        z = op(a, x)
        np.testing.assert_allclose(np.asarray(z), 2.0)


def test_spmv_under_jit(rng):
    """Formats are pytrees: jit over the dataclass must work."""
    coo, x, _ = _mk(FIX["laplacian"], np.float64, rng)
    hell = convert.coo_to_hell(coo)

    @jax.jit
    def f(a, xv):
        return ops.hell_spmv(a, xv)

    np.testing.assert_allclose(np.asarray(f(hell, jnp.asarray(x))), coo.spmv(x), rtol=1e-12)


def test_csput(rng):
    coo, _, _ = _mk(FIX["irregular"], np.float64, rng)
    ell = convert.coo_to_ell(coo)
    hell = convert.coo_to_hell(coo)
    # update 10 existing coordinates
    sel = rng.choice(coo.nnz, size=10, replace=False)
    r, c = coo.rows[sel], coo.cols[sel]
    newv = rng.standard_normal(10)
    dense = coo.sum_duplicates().to_dense()
    dense[r, c] = 2.0 * newv  # alpha honoured (reference bug not replicated)

    ell2 = ops.ell_csput(ell, r, c, newv, alpha=2.0)
    hell2 = ops.hell_csput(hell, r, c, newv, alpha=2.0)
    # the fixture has no duplicates → dense comparison is exact
    np.testing.assert_allclose(ell2.to_dense(), dense)
    np.testing.assert_allclose(hell2.to_dense(), dense)
    # absent coordinates are skipped
    ell3 = ops.ell_csput(ell2, np.array([0]), np.array([coo.n_cols - 1]), np.array([9.9]))
    has = dense[0, coo.n_cols - 1] != 0
    if not has:
        np.testing.assert_allclose(ell3.to_dense(), dense)


def test_generic_spmv_dispatch():
    import jax.numpy as jnp

    from spgpu_tpu import convert, ops
    from spgpu_tpu.utils.fixtures import laplacian_2d

    coo = laplacian_2d(16, 16, np.float32)
    x = np.random.default_rng(0).standard_normal(coo.n_cols).astype(np.float32)
    ref = coo.spmv(x)
    for conv in (convert.coo_to_ell, convert.coo_to_hell, convert.coo_to_dia,
                 convert.coo_to_sdia, convert.coo_to_hdia,
                 lambda c: convert.coo_to_bcoo(c, 4, 4)):
        a = conv(coo)
        z = ops.spmv(a, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(z), ref, rtol=2e-5, atol=2e-5)
