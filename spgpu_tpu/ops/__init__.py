"""Compute ops: SpMV dispatch, BLAS-1 suite, csput.

Every SpMV is a plain ``jnp`` program (:mod:`spgpu_tpu.ops.spmv_xla`) that
XLA compiles for the device at hand, in every dtype.  Each accepts
multi-RHS ``x`` with leading batch dims ``(..., n_cols) → (..., n_rows)``
(the reference's "m" host loop, fused).

Public names follow the reference (``spgpu{S,D,C,Z}<fmt>spmv`` →
``<fmt>_spmv``, dtype taken from the values); :func:`spmv` dispatches on
the matrix type.
"""

from __future__ import annotations

import jax

from spgpu_tpu.formats import (
    BcooMatrix, DiaMatrix, EllMatrix, HdiaMatrix, HellMatrix, SdiaMatrix)
from spgpu_tpu.ops import blas1
from spgpu_tpu.ops.blas1 import *  # noqa: F401,F403  (re-export BLAS-1 suite)
from spgpu_tpu.ops.csput import ell_csput, hell_csput
from spgpu_tpu.ops.spmv_xla import (
    dia_spmv_xla as dia_spmv,
    ell_spmv_xla as ell_spmv,
    hdia_spmv_xla as hdia_spmv,
    hell_spmv_xla as hell_spmv,
    sdia_spmv_xla as sdia_spmv,
)

__all__ = [
    "spmv",
    "ell_spmv", "hell_spmv", "dia_spmv", "sdia_spmv", "hdia_spmv",
    "bcoo_spmv",
    "ell_csput", "hell_csput",
] + blas1.__all__


def bcoo_spmv(a: BcooMatrix, x, alpha=1.0, beta=0.0, y=None):
    """Block-COO SpMV (an extension: the reference ships BCOO conversion
    but no kernel — SURVEY §2.2).  One batched dense block product plus a
    scatter-add over block rows.  ``precision=HIGHEST`` keeps float32
    blocks out of TF32 on GPUs with tensor cores."""
    import jax.numpy as jnp

    bc, br = a.block_cols, a.block_rows
    nbc = -(-a.n_cols // bc)
    nbr = -(-a.n_rows // br)
    pad_c = nbc * bc - a.n_cols
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad_c)]) if pad_c else x
    xb = xp.reshape(xp.shape[:-1] + (nbc, bc))
    xg = xb[..., a.block_col_idx, :]  # (..., n_blocks, bc)
    prod = jnp.einsum("brc,...bc->...br", a.blocks, xg,
                      precision=jax.lax.Precision.HIGHEST)
    prod = jnp.moveaxis(prod, -2, 0)  # (n_blocks, ..., br)
    zb = jax.ops.segment_sum(prod, a.block_row_idx, num_segments=nbr)
    acc = jnp.moveaxis(zb, 0, -2).reshape(x.shape[:-1] + (nbr * br,))[..., : a.n_rows]
    if isinstance(beta, (int, float)) and beta == 0 or y is None:
        return alpha * acc
    return alpha * acc + beta * y


_SPMV = {
    EllMatrix: ell_spmv,
    HellMatrix: hell_spmv,
    DiaMatrix: dia_spmv,
    SdiaMatrix: sdia_spmv,
    HdiaMatrix: hdia_spmv,
    BcooMatrix: bcoo_spmv,
}


def spmv(a, x, alpha=1.0, beta=0.0, y=None):
    """Format-generic ``z = beta*y + alpha*(A @ x)``: dispatches on the
    matrix type."""
    try:
        fn = _SPMV[type(a)]
    except KeyError:
        raise TypeError(f"no SpMV for {type(a).__name__}") from None
    return fn(a, x, alpha, beta, y)
