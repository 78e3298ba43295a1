"""DIA (diagonal) format.

Reference definition: ``/root/reference/src/core/dia.h:26-53`` — values
``dM`` column-major with pitch, ``offsets[diags]`` holding each stored
diagonal's offset ``col - row`` ordered ascending (``dia.c:76-85``), and
an in-kernel column bound check for out-of-range ends of off-diagonals
(``dia_spmv_base_template.cuh:133-135``).

Layout: ``values`` has shape ``(diags_padded, rows_padded)`` —
diagonal-major with rows on the contiguous last axis, so element
``(row i, diag j)`` = ``A[i, i + offsets[j]]`` lives at ``values[j, i]``.
Diagonal ``j``'s x-operand is the shifted range ``x[i + offsets[j]]``.
Padding diagonals (the one an empty matrix keeps) carry
``offset = n_cols`` (always out of range, masked to zero in-kernel).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DiaMatrix:
    values: jax.Array  # (diags_p, rows_p)
    offsets: jax.Array  # (diags_p,) int32, ascending; padding = n_cols
    n_rows: int = dataclasses.field(metadata=dict(static=True))
    n_cols: int = dataclasses.field(metadata=dict(static=True))
    n_diags: int = dataclasses.field(metadata=dict(static=True))

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
    def diags_padded(self) -> int:
        return self.values.shape[0]

    @property
    def storage_bytes(self) -> int:
        return int(
            self.values.size * self.values.dtype.itemsize + self.offsets.size * 4
        )

    def to_dense(self) -> np.ndarray:
        vals = np.asarray(self.values)
        offs = np.asarray(self.offsets)
        out = np.zeros((self.n_rows, self.n_cols), dtype=vals.dtype)
        rows = np.arange(self.n_rows)
        for j in range(self.n_diags):
            cols = rows + offs[j]
            sel = (cols >= 0) & (cols < self.n_cols)
            out[rows[sel], cols[sel]] = vals[j, : self.n_rows][sel]
        return out


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SdiaMatrix:
    """Static-offset DIA — DIA with the offsets in the compiled program.

    The reference's DIA kernel stages the offset list in shared memory
    per block and bound-checks every column
    (``dia_spmv_base_template.cuh:35-49,133-135``).  Here the offsets are
    static Python ints, so each diagonal's x operand is a static slice of
    a zero-padded x: no offset table, no index stream, no gather and no
    bound check (out-of-range cells are zero in ``values`` by
    construction).  Recompilation happens per offset *tuple*, which for
    the stencil matrices this format targets is fixed across a solve.

    ``values`` has shape ``(n_diags, n_rows)`` in the matrix's own dtype:
    row ``i`` of diagonal ``j`` (``A[i, i + offsets[j]]``) at
    ``values[j, i]``.
    """

    values: jax.Array  # (n_diags, n_rows)
    offsets: tuple = dataclasses.field(metadata=dict(static=True))
    n_rows: int = dataclasses.field(metadata=dict(static=True))
    n_cols: int = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def n_diags(self) -> int:
        return len(self.offsets)

    @property
    def storage_bytes(self) -> int:
        return int(self.values.size * self.values.dtype.itemsize)

    def to_dense(self) -> np.ndarray:
        vals = np.asarray(self.values)
        out = np.zeros((self.n_rows, self.n_cols), dtype=vals.dtype)
        rows = np.arange(self.n_rows)
        for j, off in enumerate(self.offsets):
            cols = rows + off
            sel = (cols >= 0) & (cols < self.n_cols)
            out[rows[sel], cols[sel]] = vals[j][sel]
        return out
