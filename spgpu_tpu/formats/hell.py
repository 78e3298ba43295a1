"""HELL ("Hacked ELLpack") — the reference library's signature format.

Reference definition: ``/root/reference/src/core/hell.h:26-59`` with the
layout built in ``hell.c:46-104``: rows are grouped into "hacks" of
``hackSize`` rows; each hack is stored as its own mini-ELL padded only to
*its own* max row length, killing ELL's global-width padding blow-up.

Layout: ``values``/``col_indices`` have shape ``(total_slots,
hack_size)``; hack ``h`` owns slot rows ``hack_offsets[h] :
hack_offsets[h+1]``, as many as its longest row.  Element ``(row i, slot
k)`` lives at
``values[hack_offsets[i // hack_size] + k, i % hack_size]`` — the direct
analogue of the reference's
``cM[hackOffsets[i/hackSize] + i%hackSize + k*hackSize]``.

Deviations from the reference, by design:

* ``hack_offsets`` is a ``(num_hacks + 1,)`` prefix sum (last entry =
  ``total_slots``), where the reference stores per-hack start offsets in
  units of elements/hackSize without the sentinel.  The sentinel removes a
  branch from every kernel.
* ``slot_to_hack`` (``(total_slots,)`` int32) is precomputed at conversion
  time: it lets the XLA SpMV path reduce products to rows with one
  ``segment_sum`` instead of a ragged loop, and costs 4 bytes/slot.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class HellMatrix:
    # data
    values: jax.Array  # (total_slots, hack_size)
    col_indices: jax.Array  # (total_slots, hack_size) int32, padding=0
    hack_offsets: jax.Array  # (num_hacks + 1,) int32 prefix sum of slot counts
    slot_to_hack: jax.Array  # (total_slots,) int32
    row_lengths: Optional[jax.Array]  # (rows_p,) int32
    row_perm: Optional[jax.Array]  # (rows_p,) int32 (hacked-OELL)
    # metadata
    n_rows: int = dataclasses.field(metadata=dict(static=True))
    n_cols: int = dataclasses.field(metadata=dict(static=True))
    hack_size: int = dataclasses.field(metadata=dict(static=True))
    total_slots: int = dataclasses.field(metadata=dict(static=True))
    max_hack_width: int = dataclasses.field(metadata=dict(static=True))
    avg_nnz_per_row: float = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def num_hacks(self) -> int:
        return int(self.hack_offsets.shape[0]) - 1

    @property
    def rows_padded(self) -> int:
        return self.num_hacks * self.hack_size

    @property
    def storage_bytes(self) -> int:
        n = self.values.size * self.values.dtype.itemsize
        n += self.col_indices.size * self.col_indices.dtype.itemsize
        n += self.hack_offsets.size * 4 + self.slot_to_hack.size * 4
        if self.row_lengths is not None:
            n += self.row_lengths.size * 4
        if self.row_perm is not None:
            n += self.row_perm.size * 4
        return int(n)

    def to_dense(self) -> np.ndarray:
        vals = np.asarray(self.values)
        cols = np.asarray(self.col_indices)
        s2h = np.asarray(self.slot_to_hack)
        out = np.zeros((self.n_rows, self.n_cols), dtype=vals.dtype)
        lane = np.arange(self.hack_size)[None, :]
        stored_row = s2h[:, None] * self.hack_size + lane
        if self.row_perm is not None:
            perm = np.asarray(self.row_perm)
            out_row = perm[stored_row]
        else:
            out_row = stored_row
        valid = (vals != 0) | (cols != 0)
        # padding slots carry (value=0, col=0): they'd add 0 anyway, but the
        # mask also guards rows >= n_rows in the last hack.
        valid &= out_row < self.n_rows
        np.add.at(out, (out_row[valid], cols[valid]), vals[valid])
        return out
