"""Halo/compute overlap on the distributed path: the interior/exterior
slab split must be exact against the host golden and the single-device
product, in float32 and float64, and the weak-scaling instrumentation
must report its rows."""

import numpy as np
import pytest

import jax.numpy as jnp

from spgpu_tpu import convert, ops
from spgpu_tpu.parallel.dist_solve import dist_cg
from spgpu_tpu.parallel.dist_spmv import dist_spmv
from spgpu_tpu.parallel.partition import make_row_mesh, partition_coo_rows
from spgpu_tpu.utils.fixtures import laplacian_2d, random_irregular


@pytest.mark.parametrize("n_shards", [2, 4])
def test_overlap_matches_plain_and_golden(n_shards):
    coo = random_irregular(2048, 2048, avg_nnz_per_row=8.0, seed=11,
                           dtype=np.float32)
    pm = partition_coo_rows(coo, n_shards)
    x = np.random.default_rng(2).standard_normal(coo.n_cols).astype(
        np.float32)
    g = coo.spmv(x)
    z = np.asarray(dist_spmv(pm, x, mesh=make_row_mesh(n_shards)))
    z0 = np.asarray(ops.hell_spmv(convert.coo_to_hell(coo), jnp.asarray(x)))
    np.testing.assert_allclose(z, g, rtol=2e-5, atol=2e-5 * np.abs(g).max())
    np.testing.assert_allclose(z, z0, rtol=2e-5, atol=2e-5 * np.abs(g).max())


def test_overlap_fp64_spmv_and_cg():
    lap = laplacian_2d(24, 24)  # float64
    mesh = make_row_mesh(4)
    pm = partition_coo_rows(lap, 4)
    assert pm.dtype == np.float64
    rng = np.random.default_rng(5)
    xt = rng.standard_normal(lap.n_rows)
    b = lap.spmv(xt)
    z = np.asarray(dist_spmv(pm, b, mesh=mesh))
    g = lap.spmv(b)
    np.testing.assert_allclose(z, g, rtol=1e-12, atol=1e-12 * np.abs(g).max())
    res = dist_cg(pm, b, mesh, tol=1e-11, maxiter=4000)
    np.testing.assert_allclose(np.asarray(res.x), xt, rtol=1e-7, atol=1e-7)


def test_halo_counts_and_interior_split():
    # banded matrix: each shard needs only its neighbours' boundary rows
    from spgpu_tpu.utils.fixtures import random_banded

    coo = random_banded(1024, bands=5, wander=2, seed=3,
                        dtype=np.float32).sum_duplicates()
    pm = partition_coo_rows(coo, 4)
    send = np.asarray(pm.send_idx)
    assert send.shape == (4, 4, pm.halo_width)
    assert pm.halo_width > 0  # a banded matrix does have halos
    # interior + exterior slabs hold every entry exactly once
    nz = int((np.asarray(pm.int_values) != 0).sum()
             + (np.asarray(pm.ext_values) != 0).sum())
    assert nz == int((coo.values != 0).sum())
    # the exterior slab (halo columns only) is smaller than the interior
    assert pm.ext_values.shape[1] < pm.int_values.shape[1]
    assert int(np.asarray(pm.ext_cols).max()) < 4 * pm.halo_width


def test_sharded_handle_device_resident_loop():
    from spgpu_tpu.parallel.dist_spmv import ShardedHandle

    coo = random_irregular(1024, 1024, avg_nnz_per_row=6.0, seed=9,
                           dtype=np.float32)
    pm = partition_coo_rows(coo, 4)
    h = ShardedHandle(pm, make_row_mesh(4))
    x = np.random.default_rng(2).standard_normal(coo.n_cols).astype(
        np.float32)
    xs = h.embed(x)
    zs = h.matvec(xs)
    z2 = h.matvec(zs)  # chained, device-resident
    g = coo.spmv(x)
    np.testing.assert_allclose(np.asarray(h.extract(zs)), g, rtol=2e-5,
                               atol=2e-5 * np.abs(g).max())
    g2 = coo.spmv(g)
    np.testing.assert_allclose(np.asarray(h.extract(z2)), g2, rtol=2e-5,
                               atol=2e-5 * np.abs(g2).max())


@pytest.mark.parametrize("n_shards", [4, 8])
def test_halo_exchange_golden(n_shards):
    """A 2-D Laplacian split into thin row blocks: every shard's halo
    comes from both neighbours, and shards at the ends receive nothing
    from one side."""
    coo = laplacian_2d(48, 48, np.float32)
    x = np.random.default_rng(7).standard_normal(coo.n_rows).astype(
        np.float32)
    g = coo.spmv(x)
    pm = partition_coo_rows(coo, n_shards)
    z = np.asarray(dist_spmv(pm, x, make_row_mesh(n_shards)))
    assert np.abs(z - g).max() / np.abs(g).max() < 1e-5


def test_weak_scaling_rows():
    from spgpu_tpu.bench.harness import run_weak_scaling

    rows = run_weak_scaling(rows_per_shard=2048, shards=(1, 2), iters=3,
                            out=None)
    assert len(rows) == 2
    for r in rows:
        for key in ("t_avg_s", "nnz_per_s", "efficiency",
                    "halo_bytes_per_product", "device"):
            assert key in r, key
    assert rows[1]["halo_bytes_per_product"] > 0
