"""Single-device CG/BiCGSTAB on the BASELINE Laplacian config — the
minimum end-to-end slice of SURVEY §7 M1: format → SpMV → device-resident
Krylov loop matches the dense solve within fp64 tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spgpu_tpu import convert, ops, solvers
from spgpu_tpu.utils import laplacian_2d, random_banded, random_fem_like


def test_cg_laplacian_ell():
    coo = laplacian_2d(16, 16)
    ell = convert.coo_to_ell(coo)
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(coo.n_rows)
    b = jnp.asarray(coo.spmv(x_true))

    res = solvers.cg(lambda v: ops.ell_spmv(ell, v), b, tol=1e-12, maxiter=2000)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), x_true, rtol=1e-7, atol=1e-8)


def test_cg_jacobi_preconditioned_hell():
    coo = laplacian_2d(20, 12)
    hell = convert.coo_to_hell(coo)
    m_inv = solvers.jacobi_preconditioner(coo)
    rng = np.random.default_rng(1)
    x_true = rng.standard_normal(coo.n_rows)
    b = jnp.asarray(coo.spmv(x_true))

    plain = solvers.cg(lambda v: ops.hell_spmv(hell, v), b, tol=1e-12, maxiter=2000)
    prec = solvers.cg(
        lambda v: ops.hell_spmv(hell, v), b, tol=1e-12, maxiter=2000, m_inv=m_inv
    )
    assert bool(prec.converged)
    np.testing.assert_allclose(np.asarray(prec.x), x_true, rtol=1e-7, atol=1e-8)
    assert int(prec.iterations) <= int(plain.iterations) + 5


def test_cg_fully_jitted_hdia():
    coo = laplacian_2d(12, 12)
    hdia = convert.coo_to_hdia(coo)
    b = jnp.ones(coo.n_rows)

    @jax.jit
    def solve(a, b):
        return solvers.cg(lambda v: ops.hdia_spmv(a, v), b, tol=1e-11, maxiter=1000)

    res = solve(hdia, b)
    assert bool(res.converged)
    ref = np.linalg.solve(coo.to_dense(), np.asarray(b))
    np.testing.assert_allclose(np.asarray(res.x), ref, rtol=1e-6, atol=1e-8)


def test_bicgstab_nonsymmetric():
    coo = random_banded(400, bands=5, wander=0, seed=9)  # diag-dominant, nonsym
    dia = convert.coo_to_dia(coo)
    rng = np.random.default_rng(2)
    x_true = rng.standard_normal(coo.n_rows)
    b = jnp.asarray(coo.spmv(x_true))
    res = solvers.bicgstab(lambda v: ops.dia_spmv(dia, v), b, tol=1e-12, maxiter=4000)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), x_true, rtol=1e-6, atol=1e-7)


def test_cg_complex_hermitian():
    """Complex hermitian positive-definite solve — the Z-precision CG
    workload (the reference's C/Z kernels fed PSBLAS complex solvers)."""
    import jax.numpy as jnp

    from spgpu_tpu.formats.coo import CooMatrix
    from spgpu_tpu.ops import spmv
    from spgpu_tpu.convert import coo_to_hell
    from spgpu_tpu.solvers import cg

    rng = np.random.default_rng(5)
    n = 60
    b_mat = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    dense = b_mat @ b_mat.conj().T + n * np.eye(n)  # HPD
    rows, cols = np.nonzero(dense)
    coo = CooMatrix(rows, cols, dense[rows, cols].astype(np.complex128), n, n)
    a = coo_to_hell(coo)
    b = (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    res = cg(lambda v: spmv(a, v), jnp.asarray(b), tol=1e-10, maxiter=500)
    assert bool(res.converged)
    np.testing.assert_allclose(dense @ np.asarray(res.x), b, atol=1e-7)


def test_high_level_solve_auto():
    """solve(): format auto-selection + relabel + CG, original numbering."""
    import jax.numpy as jnp

    from spgpu_tpu.solvers import solve
    from spgpu_tpu.utils.fixtures import laplacian_2d, random_banded

    lap = laplacian_2d(24, 26, np.float32)
    b = np.random.default_rng(9).standard_normal(lap.n_rows).astype(np.float32)
    res = solve(lap, b, tol=1e-5, maxiter=4000)
    assert bool(res.converged)
    np.testing.assert_allclose(lap.spmv(np.asarray(res.x)), b, atol=1e-3)

    band = random_banded(700, bands=5, wander=0, seed=3, dtype=np.float32)
    b2 = np.random.default_rng(10).standard_normal(700).astype(np.float32)
    res2 = solve(band, b2, symmetric=False, tol=1e-6, maxiter=4000)
    assert bool(res2.converged)
    np.testing.assert_allclose(band.sum_duplicates().spmv(np.asarray(res2.x)),
                               b2, atol=1e-2)


def _dominant(coo, dt, rng):
    """``coo`` plus a per-row diagonal shift (row abs sum + 1), in ``dt``
    (complex: random imaginary parts) — strictly diagonally dominant."""
    from spgpu_tpu.formats.coo import CooMatrix

    v = coo.values.astype(np.float64)
    if np.issubdtype(dt, np.complexfloating):
        v = v + 0.5j * rng.standard_normal(coo.nnz)
    n = coo.n_rows
    shift = np.bincount(coo.rows, np.abs(v), minlength=n) + 1.0
    idx = np.arange(n)
    return CooMatrix(np.concatenate([coo.rows, idx]),
                     np.concatenate([coo.cols, idx]),
                     np.concatenate([v, shift]).astype(dt), n, n
                     ).sum_duplicates()


_CLASSES = {
    # class: (fixture, layout solve() must pick)
    "stencil": (lambda: laplacian_2d(30, 20), "sdia"),
    "banded": (lambda: random_banded(1500, bands=7, wander=13, seed=4),
               "hdia"),
    "irregular": (lambda: random_fem_like(1500, 8.0, span=200,
                                          far_frac=0.02, seed=6), "hell"),
}


@pytest.mark.parametrize("dt", [np.float32, np.float64, np.complex64,
                                np.complex128],
                         ids=["fp32", "fp64", "c64", "c128"])
@pytest.mark.parametrize("cls", sorted(_CLASSES))
def test_solve_routes_by_class(cls, dt):
    """solve(): the layout comes from the matrix's structure (never the
    platform), the Krylov loop runs in the system's own dtype, and the
    true residual meets the tolerance."""
    from spgpu_tpu.convert import suggest_format
    from spgpu_tpu.solvers import solve

    rng = np.random.default_rng(21)
    make, expect = _CLASSES[cls]
    coo = _dominant(make(), dt, rng)
    assert suggest_format(coo) == expect
    b = rng.standard_normal(coo.n_rows)
    if np.issubdtype(dt, np.complexfloating):
        b = b + 1j * rng.standard_normal(coo.n_rows)
    b = b.astype(dt)
    single = dt in (np.float32, np.complex64)
    tol = 1e-5 if single else 1e-11
    res = solve(coo, b, symmetric=False, tol=tol, maxiter=2000)
    x = np.asarray(res.x)
    assert x.dtype == dt
    assert bool(res.converged)
    r = np.linalg.norm(b - coo.spmv(x.astype(np.complex128)))
    assert r / np.linalg.norm(b) < 10 * tol


@pytest.mark.parametrize("fmt", ["sdia", "dia", "hdia", "hell", "ell"])
def test_solve_fmt_override(fmt):
    """Every layout solve() can build gives the same CG solution."""
    from spgpu_tpu.solvers import solve

    lap = laplacian_2d(14, 17)
    b = np.random.default_rng(3).standard_normal(lap.n_rows)
    res = solve(lap, b, tol=1e-11, fmt=fmt)
    np.testing.assert_allclose(lap.spmv(np.asarray(res.x)), b, atol=1e-9)


def test_solve_rejects_unknown_fmt():
    from spgpu_tpu.solvers import solve

    lap = laplacian_2d(4, 4)
    with pytest.raises(ValueError, match="unknown fmt"):
        solve(lap, np.ones(16), fmt="whell")
