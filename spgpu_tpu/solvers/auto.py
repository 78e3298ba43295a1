"""High-level solve entry point: format selection + layout + Krylov.

The reference left this whole pipeline to its PSBLAS callers (load COO,
pick a format, convert, iterate).  ``solve`` packages it: pick the layout
with the least per-product traffic (:func:`~spgpu_tpu.convert.select.
suggest_format`), build it in the system's own dtype, and run CG or
BiCGSTAB device-resident.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from spgpu_tpu.formats.coo import CooMatrix

__all__ = ["solve"]


def _converters():
    from spgpu_tpu import convert

    return {
        "sdia": convert.coo_to_sdia,
        "dia": convert.coo_to_dia,
        "hdia": convert.coo_to_hdia,
        "hell": convert.coo_to_hell,
        "ell": convert.coo_to_ell,
    }


def solve(
    coo: CooMatrix,
    b,
    symmetric: bool = True,
    tol: float = 1e-8,
    maxiter: int = 5000,
    jacobi: bool = False,
    fmt: Optional[str] = None,
    x0=None,
):
    """Solve ``A x = b`` for a square host COO.

    ``symmetric=True`` runs CG (SPD or hermitian positive definite
    systems), else BiCGSTAB; both work in the dtype of the matrix and
    ``b`` (float32, float64, complex64, complex128).  ``fmt`` overrides the automatic
    layout choice (``"sdia" | "dia" | "hdia" | "hell" | "ell"``).
    Returns a :class:`~spgpu_tpu.solvers.cg.CgResult`.
    """
    import jax.numpy as jnp

    from spgpu_tpu.convert import suggest_format
    from spgpu_tpu.core import require_x64
    from spgpu_tpu.ops import spmv
    from spgpu_tpu.solvers.cg import bicgstab, cg, jacobi_preconditioner

    if coo.n_rows != coo.n_cols:
        raise ValueError("solve requires a square system")
    require_x64(coo.dtype)
    # Coalesce duplicates once, up front: the ELL family keeps duplicates
    # additive while the DIA family plain-stores (last-write-wins, like
    # coo2dia) — without this, a duplicated COO would solve a different
    # matrix depending on which layout the selector picks.
    coo = coo.sum_duplicates()
    if fmt is None:
        fmt = suggest_format(coo)
    conv = _converters()
    if fmt not in conv:
        raise ValueError(f"unknown fmt {fmt!r}; expected one of {sorted(conv)}")
    a = conv[fmt](coo)
    m_inv = jacobi_preconditioner(coo) if jacobi else None
    solver = cg if symmetric else bicgstab
    dt = np.result_type(coo.dtype, np.asarray(b).dtype)
    return solver(lambda v: spmv(a, v), jnp.asarray(b, dt),
                  x0=None if x0 is None else jnp.asarray(x0, dt),
                  tol=tol, maxiter=maxiter, m_inv=m_inv)
