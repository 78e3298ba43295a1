"""BCOO / BHDIA block formats (conversion-only parity).

The reference ships conversions for these but **no SpMV kernel**
(``computeBcooSize``/``cooToBcoo`` in ``/root/reference/src/core/coo.cpp:7-96``,
``bcooToBhdia`` in ``hdia.cpp:351-373``; the planned ``bhdia_dspmv.cu``
exists only as a line in the unused ``src/CMakeLists.txt.new`` — SURVEY
§2.2).  We mirror that scope: block formats + conversions + dense
round-trip tests; block SpMV is provided via densified per-block matmul in
``ops.bcoo_spmv`` as an extension (one batched dense block product).

Layout: blocks are stored row-major as ``(n_blocks, block_rows,
block_cols)`` (the reference stores column-major dense blocks,
``coo.cpp:63-96``; row-major is the natural jnp layout and the conversion
tests fix the semantics, not the byte order).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BcooMatrix:
    block_row_idx: jax.Array  # (n_blocks,) int32
    block_col_idx: jax.Array  # (n_blocks,) int32
    blocks: jax.Array  # (n_blocks, block_rows, block_cols)
    n_rows: int = dataclasses.field(metadata=dict(static=True))
    n_cols: int = dataclasses.field(metadata=dict(static=True))
    block_rows: int = dataclasses.field(metadata=dict(static=True))
    block_cols: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_blocks(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def storage_bytes(self) -> int:
        return int(
            self.blocks.size * self.blocks.dtype.itemsize
            + self.block_row_idx.size * 4
            + self.block_col_idx.size * 4
        )

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n_rows, self.n_cols), dtype=np.asarray(self.blocks).dtype)
        br, bc = self.block_rows, self.block_cols
        bri = np.asarray(self.block_row_idx)
        bci = np.asarray(self.block_col_idx)
        blocks = np.asarray(self.blocks)
        for b in range(self.n_blocks):
            r0, c0 = bri[b] * br, bci[b] * bc
            r1, c1 = min(r0 + br, self.n_rows), min(c0 + bc, self.n_cols)
            out[r0:r1, c0:c1] += blocks[b, : r1 - r0, : c1 - c0]
        return out


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BhdiaMatrix:
    """HDIA over blocks: each slot stores one *block diagonal* of one hack
    of block-rows (``bcooToBhdia``, ``hdia.cpp:351-373``)."""

    values: jax.Array  # (total_slots, hack_size, block_rows, block_cols)
    offsets: jax.Array  # (total_slots,) int32 block-col − block-row; pad = n_block_cols
    hack_offsets: jax.Array  # (num_hacks + 1,) int32
    slot_to_hack: jax.Array  # (total_slots,) int32
    n_rows: int = dataclasses.field(metadata=dict(static=True))
    n_cols: int = dataclasses.field(metadata=dict(static=True))
    block_rows: int = dataclasses.field(metadata=dict(static=True))
    block_cols: int = dataclasses.field(metadata=dict(static=True))
    hack_size: int = dataclasses.field(metadata=dict(static=True))  # block-rows/hack

    @property
    def n_block_rows(self) -> int:
        return -(-self.n_rows // self.block_rows)

    @property
    def n_block_cols(self) -> int:
        return -(-self.n_cols // self.block_cols)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

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
        br, bc = self.block_rows, self.block_cols
        nbr, nbc = self.n_block_rows, self.n_block_cols
        for s in range(vals.shape[0]):
            if offs[s] == nbc:
                continue
            for lane in range(self.hack_size):
                brow = s2h[s] * self.hack_size + lane
                bcol = brow + offs[s]
                if brow >= nbr or bcol < 0 or bcol >= nbc:
                    continue
                r0, c0 = brow * br, bcol * bc
                r1, c1 = min(r0 + br, self.n_rows), min(c0 + bc, self.n_cols)
                out[r0:r1, c0:c1] += vals[s, lane, : r1 - r0, : c1 - c0]
        return out
