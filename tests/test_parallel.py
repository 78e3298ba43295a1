"""Distributed layer tests — 8 virtual CPU devices (conftest forces
``xla_force_host_platform_device_count=8``), the CPU-runnable multi-host
strategy of SURVEY §4.  Golden reference: host COO SpMV / scipy-style
dense solves."""

import numpy as np
import pytest

import jax

from spgpu_tpu.parallel.partition import (
    PartitionedMatrix,
    make_row_mesh,
    partition_coo_rows,
)
from spgpu_tpu.parallel.dist_spmv import dist_spmv
from spgpu_tpu.parallel.dist_solve import dist_bicgstab, dist_cg
from spgpu_tpu.solvers.cg import jacobi_preconditioner
from spgpu_tpu.utils.fixtures import laplacian_2d, random_banded, random_irregular


requires_8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.mark.parametrize("n_shards", [1, 2, 8])
@pytest.mark.parametrize(
    "make",
    [
        lambda: laplacian_2d(37, 41),
        lambda: random_irregular(1000, 1000, avg_nnz_per_row=9.0, seed=3),
        lambda: random_banded(900, bands=7, wander=13, seed=4),
    ],
    ids=["laplace", "irregular", "banded"],
)
def test_dist_spmv_matches_golden(n_shards, make):
    if n_shards > len(jax.devices()):
        pytest.skip("not enough devices")
    coo = make()
    pm = partition_coo_rows(coo, n_shards)
    mesh = make_row_mesh(n_shards)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(coo.n_rows)
    z = dist_spmv(pm, x, mesh)
    np.testing.assert_allclose(np.asarray(z), coo.spmv(x), rtol=1e-12, atol=1e-12)


@requires_8
def test_dist_spmv_fp32():
    coo = laplacian_2d(32, 32, dtype=np.float32)
    pm = partition_coo_rows(coo, 8)
    mesh = make_row_mesh(8)
    x = np.random.default_rng(1).standard_normal(coo.n_rows).astype(np.float32)
    z = dist_spmv(pm, x, mesh)
    np.testing.assert_allclose(np.asarray(z), coo.spmv(x), rtol=1e-5, atol=1e-5)


@requires_8
def test_partition_shapes_and_plan():
    coo = laplacian_2d(20, 20)  # n=400, not a multiple of 8*128
    pm = partition_coo_rows(coo, 8)
    assert pm.chunk % pm.hack_size == 0
    assert pm.padded_rows >= coo.n_rows
    assert pm.send_idx.shape[:2] == (8, 8)
    # interior slab columns stay inside the shard
    assert int(np.asarray(pm.int_cols).max()) < pm.chunk
    # exterior columns index the (S*K,) halo buffer
    assert int(np.asarray(pm.ext_cols).max()) < 8 * pm.halo_width


@requires_8
def test_dist_cg_laplacian():
    coo = laplacian_2d(31, 37)
    pm = partition_coo_rows(coo, 8)
    mesh = make_row_mesh(8)
    b = np.random.default_rng(2).standard_normal(coo.n_rows)
    res = dist_cg(pm, b, mesh, tol=1e-10, maxiter=3000)
    assert bool(res.converged)
    np.testing.assert_allclose(coo.spmv(np.asarray(res.x)), b, atol=1e-8)


@requires_8
def test_dist_cg_jacobi_preconditioned():
    coo = random_banded(700, bands=5, wander=0, seed=7)  # diag-dominant
    coo_sym_b = coo  # not symmetric; use normal-equations-free bicgstab below
    pm = partition_coo_rows(laplacian_2d(25, 28), 8)
    lap = laplacian_2d(25, 28)
    mesh = make_row_mesh(8)
    b = np.random.default_rng(3).standard_normal(lap.n_rows)
    res = dist_cg(pm, b, mesh, tol=1e-10, maxiter=3000,
                  m_inv=jacobi_preconditioner(lap))
    assert bool(res.converged)
    np.testing.assert_allclose(lap.spmv(np.asarray(res.x)), b, atol=1e-8)


@requires_8
def test_dist_bicgstab_nonsymmetric():
    coo = random_banded(640, bands=5, wander=0, seed=9)  # diag-dominant
    pm = partition_coo_rows(coo, 8)
    mesh = make_row_mesh(8)
    b = np.random.default_rng(4).standard_normal(coo.n_rows)
    res = dist_bicgstab(pm, b, mesh, tol=1e-9, maxiter=4000)
    assert bool(res.converged)
    np.testing.assert_allclose(coo.spmv(np.asarray(res.x)), b, atol=1e-6)


@requires_8
def test_dist_matches_single_device_cg():
    """N-shard CG and 1-shard CG agree (same math, different partition)."""
    coo = laplacian_2d(24, 24)
    b = np.random.default_rng(5).standard_normal(coo.n_rows)
    r1 = dist_cg(partition_coo_rows(coo, 1), b, make_row_mesh(1),
                 tol=1e-10, maxiter=2000)
    r8 = dist_cg(partition_coo_rows(coo, 8), b, make_row_mesh(8),
                 tol=1e-10, maxiter=2000)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r8.x), atol=1e-7)


def _herm_banded(n, dt, rng):
    """Hermitian positive definite tridiagonal band (diagonal 4, off
    diagonals 0.3·(complex normal) in conjugate pairs)."""
    from spgpu_tpu.formats.coo import CooMatrix

    r = np.arange(n)
    off = (rng.standard_normal(n - 1) + 1j * rng.standard_normal(n - 1)) * 0.3
    vals = np.concatenate([np.full(n, 4.0 + 0j), off, np.conj(off)])
    if not np.issubdtype(dt, np.complexfloating):
        vals = vals.real
    return CooMatrix(np.concatenate([r, r[:-1], r[1:]]),
                     np.concatenate([r, r[1:], r[:-1]]), vals.astype(dt),
                     n, n)


_DIST_TOL = {np.float64: (1e-12, 1e-10), np.complex64: (1e-5, 1e-5),
             np.complex128: (1e-12, 1e-10)}


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("dt", [np.float64, np.complex64, np.complex128],
                         ids=["fp64", "c64", "c128"])
def test_dist_spmv_dtypes(dt, n_shards):
    """Native float64/complex distributed SpMV on the HELL partition."""
    rng = np.random.default_rng(11)
    coo = _herm_banded(900, dt, rng)
    pm = partition_coo_rows(coo, n_shards)
    assert pm.dtype == dt
    x = rng.standard_normal(900)
    if np.issubdtype(dt, np.complexfloating):
        x = x + 1j * rng.standard_normal(900)
    x = x.astype(dt)
    z = np.asarray(dist_spmv(pm, x, make_row_mesh(n_shards)))
    assert z.dtype == dt
    g = coo.spmv(x)
    assert np.linalg.norm(z - g) / np.linalg.norm(g) < _DIST_TOL[dt][0]


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("dt", [np.float64, np.complex64, np.complex128],
                         ids=["fp64", "c64", "c128"])
def test_dist_cg_dtypes(dt, n_shards):
    """dist_cg on hermitian-PD systems in native float64/complex dtypes
    (conjugated inner products, psum across the mesh)."""
    rng = np.random.default_rng(12)
    coo = _herm_banded(700, dt, rng)
    b = rng.standard_normal(700)
    if np.issubdtype(dt, np.complexfloating):
        b = b + 1j * rng.standard_normal(700)
    b = b.astype(dt)
    tol = _DIST_TOL[dt][1]
    res = dist_cg(partition_coo_rows(coo, n_shards), b,
                  make_row_mesh(n_shards), tol=tol, maxiter=2000)
    assert bool(res.converged)
    r = np.linalg.norm(b - coo.spmv(np.asarray(res.x))) / np.linalg.norm(b)
    assert r < 10 * tol


@pytest.mark.parametrize("dt", [np.float32, np.complex128])
def test_dist_bicgstab_dtypes(dt):
    """dist_bicgstab on a non-hermitian system (upper band perturbed)."""
    from spgpu_tpu.formats.coo import CooMatrix

    rng = np.random.default_rng(13)
    base = _herm_banded(512, dt, rng)
    vals = base.values + (0.1 + (0.05j if np.iscomplexobj(base.values)
                                 else 0)) * (base.rows < base.cols)
    coo = CooMatrix(base.rows, base.cols, vals.astype(dt), 512, 512)
    b = rng.standard_normal(512).astype(dt)
    res = dist_bicgstab(partition_coo_rows(coo, 2), b, make_row_mesh(2),
                        tol=1e-5 if dt == np.float32 else 1e-11,
                        maxiter=3000)
    r = np.linalg.norm(b - coo.spmv(np.asarray(res.x))) / np.linalg.norm(b)
    assert r < (1e-4 if dt == np.float32 else 1e-10)


def test_dist_solve_handle_compile_once():
    """DistSolveHandle traces each (symmetric, tol, maxiter) program ONCE
    — a second solve with a new b reuses the executable (the reference's
    one-handle-many-calls contract, core.h:60-82)."""
    from spgpu_tpu.parallel.dist_solve import DistSolveHandle

    coo = laplacian_2d(64, 64, np.float32)
    pm = partition_coo_rows(coo, 4)
    mesh = make_row_mesh(4)
    h = DistSolveHandle(pm, mesh)
    rng = np.random.default_rng(0)
    b1 = rng.standard_normal(coo.n_rows).astype(np.float32)
    b2 = rng.standard_normal(coo.n_rows).astype(np.float32)
    r1 = h.solve(b1, tol=1e-6, maxiter=500)
    r2 = h.solve(b2, tol=1e-6, maxiter=500)
    key = (True, 1e-6, 500)
    assert h.trace_counts[key] == 1, h.trace_counts
    for b, r in ((b1, r1), (b2, r2)):
        resid = np.linalg.norm(b - coo.spmv(np.asarray(r.x, np.float64))) \
            / np.linalg.norm(b)
        assert resid < 1e-4


def test_sharded_handle_complex():
    """ShardedHandle on a complex64 partition: device-resident matvec
    loop with no per-call retrace."""
    from spgpu_tpu.formats.coo import CooMatrix
    from spgpu_tpu.parallel.dist_spmv import ShardedHandle

    rng = np.random.default_rng(4)
    base = random_banded(2048, bands=7, wander=3, seed=1,
                         dtype=np.float64).sum_duplicates()
    cm = CooMatrix(base.rows, base.cols,
                   (base.values + 1j * rng.standard_normal(base.nnz))
                   .astype(np.complex64), base.n_rows, base.n_cols)
    pm = partition_coo_rows(cm, 2)
    mesh = make_row_mesh(2)
    h = ShardedHandle(pm, mesh)
    xc = (rng.standard_normal(cm.n_cols)
          + 1j * rng.standard_normal(cm.n_cols)).astype(np.complex64)
    st = h.embed(xc)
    z = np.asarray(h.extract(h.matvec(st)))
    g = cm.spmv(xc.astype(np.complex128))
    assert np.linalg.norm(z - g) / np.linalg.norm(g) < 1e-5
