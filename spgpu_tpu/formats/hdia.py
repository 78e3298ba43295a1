"""HDIA ("Hacked DIA") — the reference's second signature format.

Reference definition: ``/root/reference/src/core/hdia.h:21-49`` with the
layout built in ``hdia.cpp:68-153``: rows are grouped into hacks of
``hackSize`` rows, and each hack stores only *its own* occupied diagonals
(``hackOffsets`` is a prefix sum of per-hack diagonal counts,
``hdia.h:33-40``), killing DIA's empty-diagonal padding for banded
matrices whose band wanders.

Layout: ``values`` has shape ``(total_slots, hack_size)``; hack ``h`` owns slot
rows ``hack_offsets[h] : hack_offsets[h+1]``; slot ``s`` stores the
diagonal with *global* offset ``offsets[s] = col - row`` restricted to
hack ``h``'s rows, i.e. value ``A[i, i + offsets[s]]`` lives at
``values[s, i % hack_size]``.

Deviation: the reference keys per-hack diagonals *relative to the hack's
first row* (``(col-base) - ((row-base) % hackSize)``,
``hdia.cpp:210-211,280-281``); we store the plain global ``col - row``.
Within one hack the two keys differ by the constant ``hack_start``, so the
grouping of entries into diagonals is identical — only the stored integer
differs, and the global form lets the kernel compute the x slice start as
``hack_start + offset`` with no re-basing.

Like HELL we add a conversion-time ``slot_to_hack`` map so the XLA SpMV
path is a single gather + multiply + ``segment_sum``.  Padding slots
(the one an empty matrix keeps) carry ``offset = n_cols`` and zero values.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class HdiaMatrix:
    values: jax.Array  # (total_slots, hack_size)
    offsets: jax.Array  # (total_slots,) int32 global col-row; padding=n_cols
    hack_offsets: jax.Array  # (num_hacks + 1,) int32 prefix sum
    slot_to_hack: jax.Array  # (total_slots,) int32
    n_rows: int = dataclasses.field(metadata=dict(static=True))
    n_cols: int = dataclasses.field(metadata=dict(static=True))
    hack_size: int = dataclasses.field(metadata=dict(static=True))
    total_slots: int = dataclasses.field(metadata=dict(static=True))
    max_hack_diags: int = dataclasses.field(metadata=dict(static=True))

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
        return int(
            self.values.size * self.values.dtype.itemsize
            + self.offsets.size * 4
            + self.hack_offsets.size * 4
            + self.slot_to_hack.size * 4
        )

    def to_dense(self) -> np.ndarray:
        vals = np.asarray(self.values)
        offs = np.asarray(self.offsets)
        s2h = np.asarray(self.slot_to_hack)
        out = np.zeros((self.n_rows, self.n_cols), dtype=vals.dtype)
        lane = np.arange(self.hack_size)
        for s in range(vals.shape[0]):
            if offs[s] >= self.n_cols and offs[s] == self.n_cols:
                # padding slot sentinel; genuine offsets can never equal
                # n_cols (max valid is n_cols - 1 - 0).
                continue
            rows = s2h[s] * self.hack_size + lane
            cols = rows + offs[s]
            sel = (rows < self.n_rows) & (cols >= 0) & (cols < self.n_cols)
            out[rows[sel], cols[sel]] = vals[s][sel]
        return out
