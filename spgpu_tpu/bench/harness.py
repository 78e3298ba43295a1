"""Benchmark harness implementation.

``run_config`` measures one (matrix, format) pair; ``run_suite`` covers
the BASELINE.json config classes:

* ELL on a 2-D 5-point Laplacian;
* HELL on irregular FEM-profile matrices;
* HDIA on banded matrices, SDIA on stencils;
* float64 and complex64 rows, an 8-RHS HELL SpMM;
* BLAS-1 rows, conversion time and vendor anchors (scipy CSR on the
  host, ``jax.experimental.sparse`` BCOO).

Times are device times per product from :func:`~spgpu_tpu.utils.timing.
chained_time`; every row names the device it ran on.  Sizes come from the
``size`` argument, never from the platform.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Optional

import numpy as np


def _device() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


@dataclasses.dataclass
class BenchResult:
    config: str
    fmt: str
    n_rows: int
    nnz: int
    storage_bytes: int
    pad_factor: float
    t_avg_s: float
    gflops: float
    eff_bandwidth_gbs: float
    checksum: float
    device: dict

    def json(self) -> str:
        d = dataclasses.asdict(self)
        d["t_avg_s"] = round(self.t_avg_s, 9)
        for k in ("gflops", "eff_bandwidth_gbs", "pad_factor"):
            d[k] = round(d[k], 3)
        return json.dumps(d)


def _time_chained(spmv: Callable, a, x, iters: int) -> float:
    """Device time per SpMV: ``iters`` products chained in one program
    (``x ← spmv(a, x) * scale``; square matrices only)."""
    import jax.numpy as jnp

    from spgpu_tpu.utils.timing import chained_time

    scale = jnp.asarray(1e-3, x.dtype)
    return chained_time(lambda c, a: spmv(a, c) * scale, x, a, iters=iters)


def run_config(
    config: str,
    fmt: str,
    coo,
    convert: Callable,
    spmv: Callable,
    traffic_bytes: Callable,
    iters: int = 20,
    seed: int = 1,
    flops_factor: float = 1.0,
    make_x: Optional[Callable] = None,
) -> BenchResult:
    """Measure one (matrix, format) pair with the §3.5 protocol: warm-up,
    ``dot(z, z)`` checksum, timed loop."""
    import jax.numpy as jnp

    from spgpu_tpu.ops.blas1 import dot

    a = convert(coo)
    if make_x is not None:
        x = make_x(a, coo, np.random.default_rng(seed))
    else:
        x = jnp.asarray(
            np.random.default_rng(seed).standard_normal(coo.n_cols),
            coo.values.dtype,
        )
    z = spmv(a, x)  # warm-up
    checksum = float(np.abs(np.asarray(dot(z, z, conjugate=True))).sum())
    t = _time_chained(spmv, a, x, iters)
    nnz = coo.nnz
    pad = getattr(a, "values", None)
    return BenchResult(
        config=config,
        fmt=fmt,
        n_rows=coo.n_rows,
        nnz=nnz,
        storage_bytes=int(getattr(a, "storage_bytes", 0)),
        pad_factor=float(pad.size / max(nnz, 1)) if pad is not None else 0.0,
        t_avg_s=t,
        gflops=flops_factor * (2.0 * nnz - 1.0) / t * 1e-9,
        eff_bandwidth_gbs=traffic_bytes(a, coo) / t / 1e9,
        checksum=checksum,
        device=_device(),
    )


def run_suite(size: str = "small", out=print):
    """Run the BASELINE config classes; emits one JSON line per result.

    ``size``: "small" (CPU/CI-friendly) or "full" (sizes whose working
    set exceeds a GPU's L2 several times).  Returns the list of results.
    """
    import jax.numpy as jnp

    from spgpu_tpu.convert import (
        coo_to_ell, coo_to_hdia, coo_to_hell, coo_to_sdia)
    from spgpu_tpu.formats.coo import CooMatrix
    from spgpu_tpu.ops import ell_spmv, hdia_spmv, hell_spmv, sdia_spmv
    from spgpu_tpu.utils.fixtures import (
        laplacian_2d, random_banded, random_fem_like)

    big = size == "full"
    results = []

    def emit(r):
        results.append(r)
        out(r.json())

    def vec_bytes(coo, isz):
        return (coo.n_rows + coo.n_cols) * isz

    # -- ELL on the Laplacian (float64, the reference's primary precision)
    lap = laplacian_2d(2048 if big else 48, 2048 if big else 48, np.float64)
    emit(run_config(
        "laplacian_2d", "ell", lap, coo_to_ell, ell_spmv,
        lambda a, coo: a.storage_bytes + vec_bytes(coo, 8),
        iters=50 if big else 5,
    ))

    # -- HELL on FEM-profile irregular rows (the HELL-class config) --------
    fem = random_fem_like((1 << 22) if big else 20000, 10.0,
                          span=1200 if big else 768,
                          far_frac=0.005 if big else 0.01, seed=5,
                          dtype=np.float32)
    emit(run_config(
        "fem_irregular", "hell", fem, coo_to_hell, hell_spmv,
        lambda a, coo: a.storage_bytes + vec_bytes(coo, 4),
        iters=50 if big else 5,
    ))

    # -- HDIA on a wandering band (the HDIA-class config) ------------------
    band = random_banded((1 << 22) if big else 20000, bands=11, wander=7,
                         seed=2, dtype=np.float32).sum_duplicates()
    emit(run_config(
        "banded", "hdia", band, coo_to_hdia, hdia_spmv,
        lambda a, coo: a.storage_bytes + vec_bytes(coo, 4),
        iters=50 if big else 5,
    ))

    # -- SDIA on a straight band and on the Laplacian (static offsets) -----
    band_s = random_banded((1 << 22) if big else 20000, bands=11, wander=0,
                           seed=2, dtype=np.float32).sum_duplicates()
    for name, coo in (("banded_straight", band_s), ("laplacian_2d", lap)):
        isz = coo.values.dtype.itemsize
        emit(run_config(
            name, "sdia", coo, coo_to_sdia, sdia_spmv,
            lambda a, coo, isz=isz: a.storage_bytes + vec_bytes(coo, isz),
            iters=50 if big else 5,
        ))

    # -- complex64 HELL (hell_cspmv parity) and HDIA (hdia_cspmv) ----------
    rng_c = np.random.default_rng(6)
    for name, base, conv, op in (("fem_irregular_c64", fem, coo_to_hell,
                                  hell_spmv),
                                 ("banded_c64", band, coo_to_hdia,
                                  hdia_spmv)):
        cm = CooMatrix(base.rows, base.cols,
                       (base.values + 1j * rng_c.standard_normal(base.nnz))
                       .astype(np.complex64), base.n_rows, base.n_cols)
        emit(run_config(
            name, conv.__name__[len("coo_to_"):], cm, conv, op,
            lambda a, coo: a.storage_bytes + vec_bytes(coo, 8),
            iters=50 if big else 3, flops_factor=4.0,
            make_x=lambda a, coo, rng: jnp.asarray(
                (rng.standard_normal(coo.n_cols)
                 + 1j * rng.standard_normal(coo.n_cols)).astype(
                     np.complex64)),
        ))

    # -- 8-RHS SpMM: HELL with a (8, n) block of vectors -------------------
    emit(run_config(
        "fem_irregular", "hell_spmm8", fem, coo_to_hell, hell_spmv,
        lambda a, coo: a.storage_bytes + 8 * vec_bytes(coo, 4),
        iters=20 if big else 3, flops_factor=8.0,
        make_x=lambda a, coo, rng: jnp.asarray(
            rng.standard_normal((8, coo.n_cols)), jnp.float32),
    ))

    # -- BLAS-1 rows (the reference measures dot in every harness,
    # hellPerf.cpp:234)
    for r in run_blas1_suite(n=(1 << 26) if big else (1 << 16),
                             iters=50 if big else 5):
        results.append(r)
        out(json.dumps(r))

    # -- conversion-time + vendor/CPU baselines --------------------------
    for r in run_baseline_rows(fem):
        results.append(r)
        out(json.dumps(r))

    return results


def run_weak_scaling(rows_per_shard: int = 65536, shards=(1, 2, 4),
                     iters: int = 20, out=print):
    """Weak-scaling nnz/s efficiency of the distributed SpMV
    (:mod:`spgpu_tpu.parallel`): matrix rows grow with the shard count,
    efficiency = (nnz/s at S shards) / (S x nnz/s at 1 shard).  On the
    CPU virtual-device mesh this is a machinery check only (virtual
    devices share one memory system).  Returns one JSON-able dict per
    shard count, with the halo bytes each product moves."""
    import jax

    from spgpu_tpu.parallel import (
        ShardedHandle, make_row_mesh, partition_coo_rows)
    from spgpu_tpu.utils.fixtures import random_banded
    from spgpu_tpu.utils.timing import chained_time

    ndev = len(jax.devices())
    rows = []
    base_rate = None
    for S in shards:
        if S > ndev:
            continue
        n = rows_per_shard * S
        coo = random_banded(n, bands=11, wander=3, seed=2,
                            dtype=np.float32).sum_duplicates()
        pm = partition_coo_rows(coo, S)
        h = ShardedHandle(pm, make_row_mesh(S))
        x0 = h.embed(np.random.default_rng(0).standard_normal(n)
                     .astype(np.float32))
        t = chained_time(lambda c, p: h._f(p, c) * np.float32(1e-3), x0,
                         h.pm_s, iters=iters)
        rate = coo.nnz / t
        if base_rate is None:
            base_rate = rate / S  # per-shard rate at the smallest mesh
        row = {
            "config": "weak_scaling", "fmt": "dist_hell",
            "shards": S, "n_rows": n, "nnz": coo.nnz,
            "t_avg_s": round(t, 9), "nnz_per_s": round(rate, 0),
            "efficiency": round(rate / (S * base_rate), 4),
            "halo_bytes_per_product": S * S * pm.halo_width * 4,
            "device": _device(),
        }
        rows.append(row)
        if out:
            out(json.dumps(row))
    return rows


def run_blas1_suite(n: int, iters: int = 200):
    """Device-resident BLAS-1 rows.

    Reductions (dot/nrm2/asum/amax) chain through a SCALAR carry fused
    into an operand read (``op(a, b + s*tiny)``), so each iteration
    depends on the previous one without adding a vector pass.
    Elementwise ops keep the vector carry (it IS the output)."""
    import jax.numpy as jnp

    from spgpu_tpu.ops import blas1
    from spgpu_tpu.utils.timing import chained_time

    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal(n), jnp.float32)
    y = jnp.asarray(rng.standard_normal(n), jnp.float32)
    rows = []
    tiny = jnp.float32(1e-30)
    red_cases = {
        "dot": (lambda u, v, s: blas1.dot(u, v + s * tiny), 2 * n * 4),
        "nrm2": (lambda u, v, s: blas1.nrm2(u + s * tiny), n * 4),
        "asum": (lambda u, v, s: blas1.asum(u + s * tiny), n * 4),
        "amax": (lambda u, v, s: blas1.amax(u + s * tiny), n * 4),
    }
    for name, (op, bytes_per) in red_cases.items():
        t = chained_time(lambda s, u, v: op(u, v, s) * jnp.float32(1e-20),
                         jnp.float32(0.0), x, y, iters=iters)
        rows.append({
            "config": "blas1", "op": name, "n": n,
            "t_avg_s": round(t, 9),
            "eff_bandwidth_gbs": round(bytes_per / t / 1e9, 3),
            "device": _device(),
        })
    t = chained_time(lambda c, v: blas1.axpby(1.000001, c, 0.999999, v), x,
                     y, iters=iters)
    rows.append({
        "config": "blas1", "op": "axpby", "n": n,
        "t_avg_s": round(t, 9),
        "eff_bandwidth_gbs": round(3 * n * 4 / t / 1e9, 3),
        "device": _device(),
    })
    return rows


def run_baseline_rows(fem):
    """Anchoring rows: HELL conversion time, scipy-CPU SpMV, and a
    ``jax.experimental.sparse`` BCOO SpMV (cusparsePerf is the
    reference's analogous vendor harness)."""
    import jax.numpy as jnp

    from spgpu_tpu.convert import coo_to_hell
    from spgpu_tpu.utils.timing import chained_time

    rows = []
    t0 = time.perf_counter()
    coo_to_hell(fem)
    t_conv = time.perf_counter() - t0
    # steady-state: the first call in a process additionally pays the
    # soft-page-fault cost of faulting in the working set
    # (utils/hostmem.py keeps those pages resident for later conversions)
    t0 = time.perf_counter()
    coo_to_hell(fem)
    t_warm = time.perf_counter() - t0
    rows.append({
        "config": "conversion", "op": "coo_to_hell",
        "nnz": fem.nnz, "t_cold_s": round(t_conv, 3),
        "t_s": round(t_warm, 3),
        "nnz_per_s": round(fem.nnz / t_warm, 0),
    })

    # scipy CPU SpMV (CSR) — the host-library anchor
    import scipy.sparse as sp

    A = sp.coo_matrix((fem.values, (fem.rows, fem.cols)),
                      shape=fem.shape).tocsr()
    xh = np.random.default_rng(1).standard_normal(fem.n_cols).astype(
        fem.values.dtype)
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        A @ xh
    t = (time.perf_counter() - t0) / reps
    rows.append({
        "config": "vendor", "op": "scipy_csr_cpu", "nnz": fem.nnz,
        "t_avg_s": round(t, 6), "gflops": round(2 * fem.nnz / t / 1e9, 3),
    })

    # jax.experimental.sparse BCOO on the same matrix
    from jax.experimental import sparse as jsparse

    idx = jnp.asarray(np.stack([fem.rows, fem.cols], axis=1))
    Ab = jsparse.BCOO((jnp.asarray(fem.values), idx), shape=fem.shape)
    xv = jnp.asarray(xh)
    t = chained_time(lambda c, A: (A @ c) * jnp.asarray(1e-3, c.dtype), xv,
                     Ab, iters=5)
    rows.append({
        "config": "vendor", "op": "jax_sparse_bcoo", "nnz": fem.nnz,
        "t_avg_s": round(t, 6), "gflops": round(2 * fem.nnz / t / 1e9, 3),
        "device": _device(),
    })
    return rows


if __name__ == "__main__":
    import sys

    run_suite("full" if "--full" in sys.argv else "small")
