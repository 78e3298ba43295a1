"""ELLpack (ELL) and ordered-ELL (OELL) — slot-major layout.

Reference definition: ``/root/reference/src/core/ell.h:26-61`` — values
``cM`` column-major with pitch, column indices ``rP``, per-row lengths
``rS`` (optional: ``rS == NULL`` means every row is ``max_nnz_per_row``
long with zero padding, the "noRs" mode of ``ell_spmv_base_nors.cuh``),
and an optional row permutation ``rIdx`` that makes the matrix an OELL
(rows stored sorted by descending length, kernel scatters to
``z[rIdx[i]]`` — ``ell_spmv_base_template.cuh:274-282``).

Layout (see ``formats/__init__.py``): ``values``/``col_indices`` have
shape ``(width, rows_padded)`` — slot-major, rows on the contiguous last
axis.  Element ``(row i, slot k)`` lives at ``values[k, i]``; the
reference's ``cM[i + k*cMPitch]``.  Padding entries carry ``col_index == 0`` and ``value == 0`` so a
full-width multiply contributes exactly zero (the reference instead stops
the per-row loop at ``rS[i]``; we keep ``row_lengths`` for the masked
kernels and for conversions).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class EllMatrix:
    # data (device arrays)
    values: jax.Array  # (width_p, rows_p) slot-major
    col_indices: jax.Array  # (width_p, rows_p) int32, 0-based, padding=0
    row_lengths: Optional[jax.Array]  # (rows_p,) int32 or None ("noRs" mode)
    row_perm: Optional[jax.Array]  # (rows_p,) int32 or None (OELL rIdx)
    # metadata (static)
    n_rows: int = dataclasses.field(metadata=dict(static=True))
    n_cols: int = dataclasses.field(metadata=dict(static=True))
    max_nnz_per_row: int = dataclasses.field(metadata=dict(static=True))
    #: rounded average nnz/row, the kernel-variant selector of the reference
    #: dispatcher (``ell_spmv_base.cuh:122-143``).
    avg_nnz_per_row: float = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def rows_padded(self) -> int:
        return self.values.shape[1]

    @property
    def width_padded(self) -> int:
        return self.values.shape[0]

    @property
    def is_ordered(self) -> bool:
        """True for OELL (row permutation present)."""
        return self.row_perm is not None

    @property
    def storage_bytes(self) -> int:
        """Device footprint; parity with the perf harness's storage report
        (``hellPerf.cpp:140``)."""
        n = self.values.size * self.values.dtype.itemsize
        n += self.col_indices.size * self.col_indices.dtype.itemsize
        if self.row_lengths is not None:
            n += self.row_lengths.size * self.row_lengths.dtype.itemsize
        if self.row_perm is not None:
            n += self.row_perm.size * self.row_perm.dtype.itemsize
        return int(n)

    def to_dense(self) -> np.ndarray:
        """Host densification (testing helper; duplicates add)."""
        vals = np.asarray(self.values)
        cols = np.asarray(self.col_indices)
        out = np.zeros((self.n_rows, self.n_cols), dtype=vals.dtype)
        rows_p = vals.shape[1]
        if self.row_lengths is not None:
            lens = np.asarray(self.row_lengths)
        else:
            lens = np.full((rows_p,), self.max_nnz_per_row, dtype=np.int32)
        slot = np.arange(vals.shape[0])[:, None]
        mask = slot < lens[None, :]
        stored_row = np.broadcast_to(np.arange(rows_p)[None, :], vals.shape)
        if self.row_perm is not None:
            perm = np.asarray(self.row_perm)
            out_row = perm[stored_row]
        else:
            out_row = stored_row
        valid = mask & (out_row < self.n_rows)
        np.add.at(out, (out_row[valid], cols[valid]), vals[valid])
        return out
