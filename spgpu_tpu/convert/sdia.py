"""COO/DIA → SDIA (static-offset DIA, the stencil-matrix layout).

The reference reaches peak DIA throughput by staging the offset list in
shared memory per block (``dia_spmv_base_template.cuh:35-49``); SDIA
compiles the offsets *into* the program instead (they become static slice
starts), so the conversion's job is only to lay out the diagonal planes
``(n_diags, n_rows)`` and to surface the offsets as Python ints.
"""

from __future__ import annotations

import numpy as np

from spgpu_tpu.core import require_x64
from spgpu_tpu.formats.coo import CooMatrix
from spgpu_tpu.formats.dia import DiaMatrix, SdiaMatrix

__all__ = ["coo_to_sdia", "dia_to_sdia"]


def _planes_to_sdia(vals, offsets, n_rows, n_cols) -> SdiaMatrix:
    import jax.numpy as jnp

    return SdiaMatrix(
        values=jnp.asarray(vals),
        offsets=tuple(int(o) for o in offsets),
        n_rows=n_rows,
        n_cols=n_cols,
    )


def coo_to_sdia(coo: CooMatrix) -> SdiaMatrix:
    """COO → SDIA.  Same diagonal discovery as ``coo_to_dia``
    (``dia.c:40-104``): diagonals ascending by offset id, duplicate
    coordinates last-write-wins (coalesce with ``sum_duplicates()``
    first if duplicates should add)."""
    require_x64(coo.dtype)
    offs_all = coo.cols - coo.rows
    uniq = np.unique(offs_all)
    planes = np.zeros((uniq.size, coo.n_rows), dtype=coo.dtype)
    planes[np.searchsorted(uniq, offs_all), coo.rows] = coo.values
    return _planes_to_sdia(planes, uniq, coo.n_rows, coo.n_cols)


def dia_to_sdia(a: DiaMatrix) -> SdiaMatrix:
    """DIA → SDIA: drop the padding diagonals (offset ``n_cols``,
    zero-valued) and the row padding."""
    vals = np.asarray(a.values)[: a.n_diags, : a.n_rows]
    offs = np.asarray(a.offsets)[: a.n_diags]
    return _planes_to_sdia(vals, offs, a.n_rows, a.n_cols)
