"""SDIA (static-offset DIA) — conversion + static-slice SpMV.

Parity target: ``spgpu?diaspmv`` (``dia_spmv_base_template.cuh``); the
golden is the host COO SpMV, as in the reference's ctest pattern.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from spgpu_tpu import convert, ops
from spgpu_tpu.formats import SdiaMatrix
from spgpu_tpu.utils.fixtures import laplacian_2d, random_banded, random_irregular


def _check(coo, rtol=5e-6):
    a = convert.coo_to_sdia(coo)
    x = np.random.default_rng(0).standard_normal(coo.n_cols).astype(coo.dtype)
    gold = coo.spmv(x)
    z = np.asarray(ops.sdia_spmv(a, jnp.asarray(x)))
    scale = max(np.abs(gold).max(), 1e-30)
    np.testing.assert_allclose(z, gold, rtol=0, atol=rtol * scale)
    return a


def test_laplacian():
    a = _check(laplacian_2d(40, 40, dtype=np.float32))
    assert a.n_diags == 5
    assert a.offsets == (-40, -1, 0, 1, 40)


def test_banded():
    _check(random_banded(3000, bands=9, seed=1, dtype=np.float32))


def test_banded_wide_band():
    _check(random_banded(2000, bands=31, seed=2, dtype=np.float32))


def test_tall_rectangular():
    coo = random_irregular(700, 90, avg_nnz_per_row=4.0, seed=3,
                           dtype=np.float32)
    _check(coo)


def test_wide_rectangular():
    coo = random_irregular(90, 700, avg_nnz_per_row=12.0, seed=4,
                           dtype=np.float32)
    _check(coo)


def test_alpha_beta():
    coo = laplacian_2d(24, 24, dtype=np.float32)
    a = convert.coo_to_sdia(coo)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(coo.n_cols).astype(np.float32)
    y = rng.standard_normal(coo.n_rows).astype(np.float32)
    gold = 2.5 * coo.spmv(x) - 0.5 * y
    z = np.asarray(ops.sdia_spmv(a, jnp.asarray(x), alpha=2.5, beta=-0.5,
                                 y=jnp.asarray(y)))
    np.testing.assert_allclose(z, gold, rtol=0,
                               atol=5e-6 * np.abs(gold).max())


def test_empty():
    from spgpu_tpu.formats.coo import CooMatrix

    coo = CooMatrix(rows=np.zeros(0, np.int64), cols=np.zeros(0, np.int64),
                    values=np.zeros(0, np.float32), n_rows=64, n_cols=64)
    a = convert.coo_to_sdia(coo)
    assert a.n_diags == 0
    z = np.asarray(ops.sdia_spmv(a, jnp.ones(64, jnp.float32)))
    assert np.all(z == 0)


def test_dia_to_sdia_matches():
    coo = random_banded(1500, bands=7, seed=6, dtype=np.float32)
    d = convert.coo_to_dia(coo)
    a = convert.dia_to_sdia(d)
    b = convert.coo_to_sdia(coo)
    assert a.offsets == b.offsets
    assert a.values.shape == (7, 1500)
    np.testing.assert_array_equal(np.asarray(a.values), np.asarray(b.values))


def test_spmm_and_generic_dispatch():
    coo = random_banded(1200, bands=5, seed=7, dtype=np.float32)
    a = convert.coo_to_sdia(coo)
    x = np.random.default_rng(8).standard_normal((3, coo.n_cols)).astype(
        np.float32)
    gold = np.stack([coo.spmv(x[r]) for r in range(3)])
    z = np.asarray(ops.sdia_spmv(a, jnp.asarray(x)))
    np.testing.assert_allclose(z, gold, rtol=0,
                               atol=5e-6 * np.abs(gold).max())
    z1 = np.asarray(ops.spmv(a, jnp.asarray(x[0])))
    np.testing.assert_allclose(z1, gold[0], rtol=0,
                               atol=5e-6 * np.abs(gold).max())


def test_sdia_is_pytree_leaf_static_offsets():
    import jax

    coo = laplacian_2d(16, 16, dtype=np.float32)
    a = convert.coo_to_sdia(coo)
    leaves, treedef = jax.tree_util.tree_flatten(a)
    assert len(leaves) == 1  # only values; offsets/shape are static
    b = jax.tree_util.tree_unflatten(treedef, leaves)
    assert b.offsets == a.offsets


def test_fp64_native():
    coo = laplacian_2d(30, 30, dtype=np.float64)
    a = convert.coo_to_sdia(coo)
    assert a.values.dtype == np.float64
    x = np.random.default_rng(9).standard_normal(coo.n_cols)
    gold = coo.spmv(x)
    z = np.asarray(ops.sdia_spmv(a, jnp.asarray(x)))
    np.testing.assert_allclose(z, gold, rtol=0,
                               atol=1e-13 * np.abs(gold).max())


def test_solve_auto_picks_sdia():
    from spgpu_tpu.solvers import solve

    coo = laplacian_2d(24, 24, dtype=np.float32)
    b = np.ones(coo.n_rows, np.float32)
    res = solve(coo, b, tol=1e-5, fmt="sdia")
    r = b - coo.spmv(np.asarray(res.x))
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-4
    # auto selection routes the stencil class to sdia
    from spgpu_tpu.convert import suggest_format

    assert suggest_format(coo) == "sdia"


def test_solve_fp64_sdia():
    from spgpu_tpu.solvers import solve

    coo = laplacian_2d(16, 16, dtype=np.float64)
    b = np.ones(coo.n_rows, np.float64)
    res = solve(coo, b, tol=1e-11, fmt="sdia")
    r = b - coo.spmv(np.asarray(res.x))
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-10


def _check_complex_sdia(rng, dt):
    """C/Z precision run the complex values natively (one complex plane,
    ``dia_cspmv.cu``/``dia_zspmv.cu`` parity) with complex alpha/beta."""
    from spgpu_tpu.formats.coo import CooMatrix

    base = laplacian_2d(40, 40, np.float64)
    cm = CooMatrix(base.rows, base.cols,
                   (base.values + 1j * rng.standard_normal(base.nnz))
                   .astype(dt), base.n_rows, base.n_cols)
    a = convert.coo_to_sdia(cm)
    assert a.values.dtype == dt
    xc = (rng.standard_normal(cm.n_cols)
          + 1j * rng.standard_normal(cm.n_cols)).astype(dt)
    yc = (rng.standard_normal(cm.n_rows)
          + 1j * rng.standard_normal(cm.n_rows)).astype(dt)
    al, be = 2 - 1j, 0.5 + 2j
    z = np.asarray(ops.sdia_spmv(a, jnp.asarray(xc), al, be, jnp.asarray(yc)))
    assert z.dtype == dt
    g = al * cm.spmv(xc.astype(np.complex128)) + be * yc
    err = np.linalg.norm(z - g) / np.linalg.norm(g)
    assert err < (2e-6 if dt == np.complex64 else 1e-14), err


def test_complex_fused_one_pass_sdia(rng):
    """complex64 SDIA runs the complex values in one pass (``dia_cspmv.cu``
    parity)."""
    _check_complex_sdia(rng, np.complex64)


def test_z_fused_one_pass_sdia(rng):
    """complex128 SDIA likewise (``dia_zspmv.cu`` parity)."""
    _check_complex_sdia(rng, np.complex128)
