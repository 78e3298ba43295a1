"""Benchmark entry point.

``python bench.py``           — the harness suite (:func:`spgpu_tpu.bench.
                                run_suite`) at full size, one JSON line per
                                row; ``--small`` runs the CPU-sized suite.
``python bench.py --mtx FILE [--fmt F] [--iters N] [--cg TOL]``
                              — the ``hellPerf``/``diaPerf`` protocol on a
                                Matrix Market file: load → symmetric
                                unfold → auto-layout → SpMV [→ solve], one
                                JSON line per stage.

Every SpMV line names the device it ran on.  A failing row is an error:
the run stops with a non-zero exit.
"""

import json
import os
import sys
import time

import numpy as np


def main_mtx(argv):
    """Matrix-Market-driven bench (``hellPerf.cpp:47-130``,
    ``diaPerf.cpp:160-292``)."""
    import jax.numpy as jnp

    from spgpu_tpu.bench.harness import _device, _time_chained
    from spgpu_tpu.convert import suggest_format
    from spgpu_tpu.io.mm import read_mm, read_mm_properties
    from spgpu_tpu.ops import spmv
    from spgpu_tpu.ops.blas1 import dot
    from spgpu_tpu.solvers.auto import _converters

    path = argv[argv.index("--mtx") + 1]
    fmt = argv[argv.index("--fmt") + 1] if "--fmt" in argv else None
    iters = int(argv[argv.index("--iters") + 1]) if "--iters" in argv else 50
    cg_tol = float(argv[argv.index("--cg") + 1]) if "--cg" in argv else None

    props = read_mm_properties(path)
    t0 = time.perf_counter()
    coo = read_mm(path).sum_duplicates()
    t_load = time.perf_counter() - t0
    print(json.dumps({
        "stage": "load", "file": os.path.basename(path),
        "symmetry": props.symmetry, "field": props.field,
        "n_rows": coo.n_rows, "n_cols": coo.n_cols, "nnz": coo.nnz,
        "t_s": round(t_load, 3)}))

    if fmt is None:
        fmt = suggest_format(coo)
    t0 = time.perf_counter()
    a = _converters()[fmt](coo)
    t_conv = time.perf_counter() - t0
    print(json.dumps({
        "stage": "convert", "fmt": fmt, "t_s": round(t_conv, 3),
        "pad_factor": round(a.values.size / max(coo.nnz, 1), 3),
        "storage_bytes": int(a.storage_bytes)}))

    rng = np.random.default_rng(1)
    is_cplx = np.issubdtype(coo.values.dtype, np.complexfloating)
    flops_per = 8.0 if is_cplx else 2.0  # complex mul-add = 8 real flops
    xv = rng.standard_normal(coo.n_cols)
    if is_cplx:
        xv = xv + 1j * rng.standard_normal(coo.n_cols)
    x = jnp.asarray(xv.astype(coo.values.dtype))
    z = spmv(a, x)  # warm-up
    checksum = float(np.abs(np.asarray(dot(z, z, conjugate=True))))
    t = _time_chained(spmv, a, x, iters)
    print(json.dumps({
        "stage": "spmv", "fmt": fmt, "t_avg_s": round(t, 9),
        "gflops": round(flops_per * coo.nnz / t * 1e-9, 3),
        "eff_bandwidth_gbs": round(
            (a.storage_bytes + (coo.n_rows + coo.n_cols)
             * coo.values.dtype.itemsize) / t / 1e9, 3),
        "checksum": checksum, "device": _device()}))

    if cg_tol is not None:
        from spgpu_tpu import solvers

        b = rng.standard_normal(coo.n_rows)
        if is_cplx:
            b = b + 1j * rng.standard_normal(coo.n_rows)
        b = b.astype(coo.values.dtype)
        t0 = time.perf_counter()
        res = solvers.solve(coo, b, symmetric=props.is_symmetric,
                            tol=cg_tol, maxiter=5000, fmt=fmt)
        xs = np.asarray(res.x)
        t_solve = time.perf_counter() - t0
        resid = float(np.linalg.norm(b - coo.spmv(xs)) / np.linalg.norm(b))
        print(json.dumps({
            "stage": "solve", "solver": "cg" if props.is_symmetric
            else "bicgstab", "iterations": int(res.iterations),
            "true_resid": resid, "t_s": round(t_solve, 3)}))


def main(argv):
    from spgpu_tpu.bench import run_suite

    run_suite("small" if "--small" in argv else "full")


if __name__ == "__main__":
    from spgpu_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    import jax

    jax.config.update("jax_enable_x64", True)
    if "--mtx" in sys.argv:
        main_mtx(sys.argv)
    else:
        main(sys.argv)
