"""Smoke run of the solve path on one NVIDIA GPU (or four with ``--multi``).

Drives the library's normal entry points, compiled for the card, at
sizes its users would call real, and checks every result against the
host golden ``CooMatrix.spmv`` (float64/complex128 on the host):

1. ``spmv``  — every format through ``ops.spmv``: HELL on the irregular
   class (FEM-profile, 4.2M rows), SDIA/DIA/HDIA and ELL on the stencil
   class (3-D Laplacian 160³, 4.1M rows; ELL here because the FEM
   matrix's ~2,400-entry longest row would pad ELL past the card's
   memory), HDIA on the banded class (4.2M rows, 11 wandering
   diagonals), BCOO on a 2-D Laplacian, in float32/float64/complex64/
   complex128;
2. ``solve`` — ``solvers.solve`` with automatic routing: CG on the
   Laplacian (float64), BiCGSTAB on the diagonally dominant FEM matrix
   (float32), CG on a hermitian complex128 system;
3. ``blas1`` — ``dot``, ``nrm2``, ``axpby`` on 64M-element vectors;
4. ``--multi`` (only with that option, and then alone) — ``dist_spmv``
   and ``dist_cg`` over ``make_row_mesh(4)`` on a 16.4M-row Laplacian,
   against the host golden and the single-card ``solve``.

Each result prints as one JSON line: sizes, compile seconds, steady
milliseconds (a stream of calls ended by ``block_until_ready``),
``compiled.memory_analysis()`` and the relative error against the golden.
SpMV lines also time a device copy moving the same number of bytes, in
the same process.  Any failure ends the run with a non-zero exit.  The
last line is ``{"ok": true, "device": {...}}``.

    python chip_smoke.py            # one card
    python chip_smoke.py --multi    # four cards
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

#: tolerances on ‖z − golden‖₂ / ‖golden‖₂: HELL/HDIA reduce through a
#: scatter-add whose summation order differs from the host's (and between
#: runs), so the bound is a few thousand ulps of the working precision
_TOL = {np.dtype(np.float32): 1e-5, np.dtype(np.complex64): 1e-5,
        np.dtype(np.float64): 1e-12, np.dtype(np.complex128): 1e-12}


@dataclasses.dataclass(frozen=True)
class Sizes:
    fem_rows: int          # random_fem_like rows (irregular class)
    fem_span: int
    lap3: tuple            # laplacian_3d grid (stencil class)
    banded_rows: int       # random_banded rows (banded class)
    bcoo_grid: int         # laplacian_2d side for BCOO
    blas_n: int
    multi_lap3: tuple      # laplacian_3d grid for --multi
    reps: int              # calls per timed stream


FULL = Sizes(fem_rows=1 << 22, fem_span=1200, lap3=(160, 160, 160),
             banded_rows=1 << 22, bcoo_grid=1024, blas_n=1 << 26,
             multi_lap3=(256, 256, 250), reps=20)
TINY = Sizes(fem_rows=3000, fem_span=100, lap3=(12, 12, 12),
             banded_rows=3000, bcoo_grid=24, blas_n=1 << 12,
             multi_lap3=(12, 12, 16), reps=2)


def _emit(**row):
    print(json.dumps(row), flush=True)


def _rel_err(z, golden) -> float:
    z = np.asarray(z).astype(golden.dtype)
    return float(np.linalg.norm(z - golden) / max(np.linalg.norm(golden),
                                                   1e-300))


def _mem(compiled) -> dict:
    ma = compiled.memory_analysis()
    if ma is None:
        return {}
    return {"argument_bytes": int(ma.argument_size_in_bytes),
            "output_bytes": int(ma.output_size_in_bytes),
            "temp_bytes": int(ma.temp_size_in_bytes)}


def _compile(fn, *args):
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def _steady(compiled, args, reps: int) -> float:
    """Seconds per call of a stream of ``reps`` calls ended by one
    ``block_until_ready`` (best of three streams)."""
    import jax

    jax.block_until_ready(compiled(*args))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = compiled(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / reps)
    return best


def _copy_time(nbytes: int, reps: int) -> float:
    """Seconds per device copy that reads and writes ``nbytes`` in all:
    ``b ← b * s`` on a donated buffer, so no call allocates."""
    import jax
    import jax.numpy as jnp

    buf = jnp.ones(max(nbytes // 8, 1), jnp.float32)
    scale = jnp.float32(1.0)
    step = jax.jit(lambda b, s: b * s, donate_argnums=0)
    buf = jax.block_until_ready(step(buf, scale))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            buf = step(buf, scale)
        jax.block_until_ready(buf)
        best = min(best, (time.perf_counter() - t0) / reps)
    return best


def _nbytes(tree) -> int:
    import jax

    return sum(int(l.size) * l.dtype.itemsize for l in jax.tree.leaves(tree))


def _with_dtype(coo, dtype, rng=None):
    """``coo`` in ``dtype``; complex dtypes get random imaginary parts."""
    from spgpu_tpu.formats.coo import CooMatrix

    v = coo.values
    if np.issubdtype(dtype, np.complexfloating):
        v = v + 0.5j * rng.standard_normal(coo.nnz)
    return CooMatrix(coo.rows, coo.cols, v.astype(dtype), coo.n_rows,
                     coo.n_cols)


def _random_vec(rng, n, dtype):
    v = rng.standard_normal(n)
    if np.issubdtype(dtype, np.complexfloating):
        v = v + 1j * rng.standard_normal(n)
    return v.astype(dtype)


def _spmv_row(matrix, fmt, a, x, golden, sizes: Sizes):
    """Compile ``ops.spmv`` for ``a``, check it against ``golden`` and time
    it beside a copy of the same bytes; raises on a tolerance miss."""
    import jax.numpy as jnp

    from spgpu_tpu.ops import spmv

    xd = jnp.asarray(x)
    compiled, t_compile = _compile(spmv, a, xd)
    z = compiled(a, xd)
    err = _rel_err(z, golden)
    dt = np.dtype(a.dtype)
    traffic = _nbytes(a) + 2 * golden.size * dt.itemsize
    t = _steady(compiled, (a, xd), sizes.reps)
    t_copy = _copy_time(traffic, sizes.reps)
    _emit(phase="spmv", matrix=matrix, fmt=fmt, dtype=dt.name,
          n_rows=int(golden.size), matrix_bytes=_nbytes(a),
          compile_s=round(t_compile, 3), steady_ms=t * 1e3,
          gbs=traffic / t / 1e9, copy_ms=t_copy * 1e3,
          copy_gbs=traffic / t_copy / 1e9, rel_err=err, tol=_TOL[dt],
          **_mem(compiled))
    if not err <= _TOL[dt]:
        raise AssertionError(f"{matrix}/{fmt}/{dt.name}: rel err {err:.3e} "
                             f"> {_TOL[dt]:.0e}")


def phase_spmv(sizes: Sizes, seed: int = 0):
    import jax.numpy as jnp

    from spgpu_tpu import convert
    from spgpu_tpu.utils.fixtures import (
        laplacian_2d, laplacian_3d, random_banded, random_fem_like)

    rng = np.random.default_rng(seed)

    # irregular class: HELL in float32 and float64 (one conversion; the
    # float32 matrix is the float64 one with its values cast)
    fem = random_fem_like(sizes.fem_rows, avg_nnz_per_row=10,
                          span=sizes.fem_span, far_frac=0.005, seed=5)
    hell64 = convert.coo_to_hell(fem)
    x = rng.standard_normal(fem.n_cols)
    for dt, a in ((np.float64, hell64),
                  (np.float32, dataclasses.replace(
                      hell64, values=hell64.values.astype(jnp.float32)))):
        xt = x.astype(dt)
        golden = _with_dtype(fem, dt).spmv(xt.astype(np.float64))
        _spmv_row("fem", "hell", a, xt, golden, sizes)
    del hell64, a

    # stencil class: SDIA, DIA, HDIA in float64 and complex128; ELL (the
    # regular-row format) in float32 and float64
    lap = laplacian_3d(*sizes.lap3)
    for dt in (np.float64, np.complex128):
        coo = _with_dtype(lap, dt, rng)
        xt = _random_vec(rng, lap.n_cols, dt)
        golden = coo.spmv(xt)
        for fmt, conv in (("sdia", convert.coo_to_sdia),
                          ("dia", convert.coo_to_dia),
                          ("hdia", convert.coo_to_hdia)):
            _spmv_row("laplacian_3d", fmt, conv(coo), xt, golden, sizes)
    for dt in (np.float32, np.float64):
        coo = _with_dtype(lap, dt)
        xt = _random_vec(rng, lap.n_cols, dt)
        golden = coo.spmv(xt.astype(np.float64))
        _spmv_row("laplacian_3d", "ell", convert.coo_to_ell(coo), xt,
                  golden, sizes)

    # banded class: HDIA in complex64
    band = _with_dtype(random_banded(sizes.banded_rows, bands=11, wander=7,
                                     seed=2).sum_duplicates(),
                       np.complex64, rng)
    xt = _random_vec(rng, band.n_cols, np.complex64)
    golden = band.spmv(xt.astype(np.complex128))
    _spmv_row("banded11", "hdia", convert.coo_to_hdia(band), xt, golden,
              sizes)

    # BCOO (8x8 dense blocks) in float32: the block product must not run
    # in TF32
    lap2 = laplacian_2d(sizes.bcoo_grid, sizes.bcoo_grid, np.float32)
    xt = _random_vec(rng, lap2.n_cols, np.float32)
    golden = lap2.spmv(xt.astype(np.float64))
    _spmv_row("laplacian_2d", "bcoo", convert.coo_to_bcoo(lap2, 8, 8), xt,
              golden, sizes)


def _solve_row(name, coo, b, tol, symmetric, bound):
    """``solvers.solve`` with automatic routing, twice (cold, then with
    the program cached); checks the true residual on the host."""
    from spgpu_tpu.convert import suggest_format
    from spgpu_tpu.solvers import solve

    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        res = solve(coo, b, symmetric=symmetric, tol=tol, maxiter=20000)
        x = np.asarray(res.x)  # waits for the device
        times.append(time.perf_counter() - t0)
    x64 = x.astype(np.complex128 if np.iscomplexobj(x) else np.float64)
    resid = float(np.linalg.norm(b - coo.spmv(x64)) / np.linalg.norm(b))
    _emit(phase="solve", system=name, dtype=np.dtype(coo.dtype).name,
          n_rows=coo.n_rows, nnz=coo.nnz, fmt=suggest_format(coo),
          solver="cg" if symmetric else "bicgstab", tol=tol,
          iterations=int(res.iterations), converged=bool(res.converged),
          true_resid=resid, bound=bound, first_s=round(times[0], 3),
          second_s=round(times[1], 3))
    if not (bool(res.converged) and resid <= bound):
        raise AssertionError(f"{name}: converged={bool(res.converged)} "
                             f"true residual {resid:.3e} > {bound:.0e}")


def phase_solve(sizes: Sizes, seed: int = 1):
    from spgpu_tpu.formats.coo import CooMatrix
    from spgpu_tpu.utils.fixtures import laplacian_3d, random_fem_like

    rng = np.random.default_rng(seed)

    # SPD stencil, float64 CG
    lap = laplacian_3d(*sizes.lap3)
    _solve_row("laplacian_3d", lap, rng.standard_normal(lap.n_rows),
               1e-8, True, 1e-7)

    # FEM profile made strictly diagonally dominant by a per-row diagonal
    # shift (the row's absolute sum + 1), float32 BiCGSTAB
    fem = random_fem_like(sizes.fem_rows, avg_nnz_per_row=10,
                          span=sizes.fem_span, far_frac=0.005, seed=5)
    n = fem.n_rows
    shift = np.bincount(fem.rows, np.abs(fem.values), minlength=n) + 1.0
    idx = np.arange(n)
    dd = CooMatrix(np.concatenate([fem.rows, idx]),
                   np.concatenate([fem.cols, idx]),
                   np.concatenate([fem.values, shift]).astype(np.float32),
                   n, n).sum_duplicates()
    _solve_row("fem_diag_dominant", dd,
               rng.standard_normal(n).astype(np.float32), 1e-5, False, 1e-4)

    # hermitian positive definite complex128 stencil: off-diagonals
    # -1 ± 0.3i (conjugate pairs), diagonal 8 > the Gershgorin radius 6.27
    off = np.where(lap.rows < lap.cols, -1 + 0.3j, -1 - 0.3j)
    vals = np.where(lap.rows == lap.cols, 8.0 + 0j, off)
    herm = CooMatrix(lap.rows, lap.cols, vals.astype(np.complex128),
                     lap.n_rows, lap.n_cols)
    _solve_row("hermitian_laplacian_3d", herm,
               _random_vec(rng, lap.n_rows, np.complex128), 1e-10, True,
               1e-9)


def phase_blas1(sizes: Sizes, seed: int = 2):
    import jax.numpy as jnp

    from spgpu_tpu.ops import blas1

    rng = np.random.default_rng(seed)
    n = sizes.blas_n
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    xd, yd = jnp.asarray(x), jnp.asarray(y)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    scale = float(np.linalg.norm(x64) * np.linalg.norm(y64))
    cases = (
        ("dot", blas1.dot, (xd, yd), float(x64 @ y64), 2 * n * 4),
        ("nrm2", blas1.nrm2, (xd,), float(np.linalg.norm(x64)), n * 4),
        ("axpby", lambda u, v: blas1.axpby(1.5, u, -0.25, v), (xd, yd),
         1.5 * x64 - 0.25 * y64, 3 * n * 4),
    )
    for name, fn, args, ref, traffic in cases:
        compiled, t_compile = _compile(fn, *args)
        got = np.asarray(compiled(*args), np.float64)
        if name == "axpby":
            err = float(np.abs(got - ref).max() / np.abs(ref).max())
        elif name == "dot":
            err = abs(float(got) - ref) / scale
        else:
            err = abs(float(got) - ref) / ref
        t = _steady(compiled, args, sizes.reps)
        _emit(phase="blas1", op=name, n=n, dtype="float32",
              compile_s=round(t_compile, 3), steady_ms=t * 1e3,
              gbs=traffic / t / 1e9, rel_err=err, tol=1e-5,
              **_mem(compiled))
        if not err <= 1e-5:
            raise AssertionError(f"{name}: rel err {err:.3e} > 1e-5")


def phase_multi(sizes: Sizes, n_devices: int = 4, seed: int = 3):
    """``dist_spmv`` and ``dist_cg`` on the HELL row partition over a
    flat ``n_devices`` mesh, against the host golden and the single-card
    ``solve`` of the same system."""
    from spgpu_tpu.parallel import (
        DistSolveHandle, dist_spmv, make_row_mesh, partition_coo_rows)
    from spgpu_tpu.solvers import solve
    from spgpu_tpu.utils.fixtures import laplacian_3d

    rng = np.random.default_rng(seed)
    lap = laplacian_3d(*sizes.multi_lap3)
    mesh = make_row_mesh(n_devices)
    t0 = time.perf_counter()
    pm = partition_coo_rows(lap, n_devices)
    t_part = time.perf_counter() - t0

    x = rng.standard_normal(lap.n_cols)
    z = np.asarray(dist_spmv(pm, x, mesh))
    err = _rel_err(z, lap.spmv(x))
    _emit(phase="multi", op="dist_spmv", n_rows=lap.n_rows, nnz=lap.nnz,
          shards=n_devices, halo_width=pm.halo_width,
          partition_s=round(t_part, 3), rel_err=err, tol=1e-12)
    if not err <= 1e-12:
        raise AssertionError(f"dist_spmv: rel err {err:.3e} > 1e-12")

    b = rng.standard_normal(lap.n_rows)
    tol = 1e-10
    h = DistSolveHandle(pm, mesh)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        res = h.solve(b, tol=tol, maxiter=20000)
        xd = np.asarray(res.x)
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    single = solve(lap, b, tol=tol, maxiter=20000)
    xs = np.asarray(single.x)
    t_single = time.perf_counter() - t0
    bn = np.linalg.norm(b)
    resid_d = float(np.linalg.norm(b - lap.spmv(xd)) / bn)
    resid_s = float(np.linalg.norm(b - lap.spmv(xs)) / bn)
    diff = float(np.linalg.norm(xd - xs) / np.linalg.norm(xs))
    _emit(phase="multi", op="dist_cg", n_rows=lap.n_rows, shards=n_devices,
          tol=tol, iterations=int(res.iterations),
          converged=bool(res.converged), bound=10 * tol,
          single_iterations=int(single.iterations), true_resid=resid_d,
          single_true_resid=resid_s, rel_diff_vs_single=diff,
          first_s=round(times[0], 3), second_s=round(times[1], 3),
          single_s=round(t_single, 3))
    if not (bool(res.converged) and resid_d <= 10 * tol
            and resid_s <= 10 * tol and diff <= 1e-6):
        raise AssertionError(
            f"dist_cg: converged={bool(res.converged)} resid {resid_d:.3e} "
            f"single {resid_s:.3e} diff vs single {diff:.3e}")


def _gpu_lines() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card dist_spmv/dist_cg phase")
    args = ap.parse_args(argv)

    try:
        from spgpu_tpu.utils.compile_cache import use_compile_cache
    except ImportError:
        print("chip_smoke: the spgpu_tpu package is not beside this script",
              file=sys.stderr)
        return 2
    use_compile_cache()
    import jax

    jax.config.update("jax_enable_x64", True)
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform "
              f"{devices[0].platform!r}); this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    n_devices = 4 if args.multi else 1
    if len(devices) < n_devices:
        print(f"chip_smoke: --multi needs {n_devices} GPUs, found "
              f"{len(devices)}", file=sys.stderr)
        return 2
    for line in _gpu_lines():
        print(line, flush=True)

    if args.multi:
        phase_multi(FULL, n_devices)
    else:
        phase_spmv(FULL)
        phase_solve(FULL)
        phase_blas1(FULL)
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
