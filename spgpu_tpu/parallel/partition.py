"""Row partitioning + halo plan construction (host-side, NumPy).

The reference has no distributed layer at all (SURVEY §2.6): halo
exchange for multi-GPU SpMV was delegated to the caller (PSBLAS + MPI),
which used the device-side ``gath``/``scat`` kernels
(``/root/reference/src/core/kernels/{gath,scat}_base.cuh``) plus the OELL
row permutation (``ell.c:161-202``) to pack/unpack halo entries of ``x``.

This module is the first-class replacement.  At conversion
time we build a :class:`PartitionedMatrix`:

* rows are split into ``n_shards`` contiguous blocks of ``chunk`` rows
  (``chunk`` a multiple of ``hack_size`` so every shard is whole hacks);
  square matrices shard ``x`` identically, so column ownership == row
  ownership;
* each shard's nonzeros are split into an **interior** slab (columns the
  shard owns — remapped to shard-local x positions) and an **exterior**
  slab (columns owned by peers — remapped to positions in the shard's
  received-halo buffer).  This is the distributed analogue of the OELL
  reorder trick: it lets the interior SpMV run while the halo collective
  is still in flight (XLA schedules them concurrently because the
  interior product has no data dependency on the all-to-all);
* the **halo plan** is a pair of stacked index arrays:
  ``send_idx[s, p, k]`` = the k-th local-x position shard ``s`` must send
  to peer ``p``; the matching receive layout places peer ``p``'s k-th
  entry at halo position ``p*K + k`` on the requesting shard.  One
  ``jax.lax.all_to_all`` of shape ``(P, K)`` per SpMV moves every halo —
  the equivalent of the MPI_Alltoallv the PSBLAS layer performed, carried
  by the device interconnect (NCCL over NVLink on GPUs).

Both slabs use the HELL layout (values ``(slots, hack_size)``, prefix-sum
``hack_offsets``, ``slot_to_hack``) stacked across shards with per-shard
padding to the common maximum, so the whole structure is one pytree of
rectangular arrays shardable along axis 0 of every leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np

from spgpu_tpu.core import HELL_HACK_SIZE, require_x64, round_up
from spgpu_tpu.formats import CooMatrix, HellMatrix


def make_row_mesh(n_shards: Optional[int] = None, axis: str = "rows") -> jax.sharding.Mesh:
    """1-D device mesh over which rows (and x blocks) are sharded."""
    devs = jax.devices()
    if n_shards is None:
        n_shards = len(devs)
    return jax.sharding.Mesh(np.array(devs[:n_shards]), (axis,))


def _hell_arrays_from_entries(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_local_rows: int,
    hack_size: int,
    dtype,
) -> tuple:
    """Build HELL slab arrays (values, col_indices, hack_offsets,
    slot_to_hack) for one shard's entry list (local row ids)."""
    counts = np.bincount(rows, minlength=n_local_rows).astype(np.int64)
    num_hacks = max(n_local_rows // hack_size, 1)
    w = np.maximum(counts.reshape(num_hacks, hack_size).max(axis=1), 1)
    ho = np.zeros(num_hacks + 1, dtype=np.int64)
    np.cumsum(w, out=ho[1:])
    total = int(ho[-1])
    v = np.zeros((total, hack_size), dtype=dtype)
    c = np.zeros((total, hack_size), dtype=np.int32)
    if rows.size:
        order = np.argsort(rows, kind="stable")
        starts = np.zeros(n_local_rows + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        k = np.arange(rows.size, dtype=np.int64) - starts[rows[order]]
        r = rows[order]
        slot = ho[r // hack_size] + k
        lane = r % hack_size
        v[slot, lane] = vals[order]
        c[slot, lane] = cols[order]
    s2h = np.repeat(np.arange(num_hacks, dtype=np.int32), w)
    return v, c, ho.astype(np.int32), s2h


def _pad_slots(arr: np.ndarray, total: int) -> np.ndarray:
    if arr.shape[0] == total:
        return arr
    pad = np.zeros((total - arr.shape[0],) + arr.shape[1:], dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PartitionedMatrix:
    """Row-partitioned square sparse matrix with a halo plan.

    Every array leaf has a leading shard axis of size ``n_shards`` and is
    meant to be sharded along it (``NamedSharding(mesh, P('rows', ...))``).
    """

    # interior slab (HELL, shard-local columns)
    int_values: jax.Array  # (S, T_int, hack)
    int_cols: jax.Array  # (S, T_int, hack) int32 in [0, chunk)
    int_hack_offsets: jax.Array  # (S, H+1) int32
    int_slot_to_hack: jax.Array  # (S, T_int) int32
    # exterior slab (HELL, halo-buffer columns)
    ext_values: jax.Array  # (S, T_ext, hack)
    ext_cols: jax.Array  # (S, T_ext, hack) int32 in [0, S*K)
    ext_hack_offsets: jax.Array  # (S, H+1) int32
    ext_slot_to_hack: jax.Array  # (S, T_ext) int32
    # halo plan
    send_idx: jax.Array  # (S, S, K) int32: local x positions to send to peer p
    # static metadata
    n_rows: int = dataclasses.field(metadata=dict(static=True))
    n_shards: int = dataclasses.field(metadata=dict(static=True))
    chunk: int = dataclasses.field(metadata=dict(static=True))
    hack_size: int = dataclasses.field(metadata=dict(static=True))
    halo_width: int = dataclasses.field(metadata=dict(static=True))  # K
    nnz: int = dataclasses.field(metadata=dict(static=True))
    # true slab invariants (max over shards), computed at build time so the
    # shard-local HellMatrix views carry honest metadata
    int_max_hack_width: int = dataclasses.field(default=0, metadata=dict(static=True))
    ext_max_hack_width: int = dataclasses.field(default=0, metadata=dict(static=True))

    @property
    def dtype(self):
        return self.int_values.dtype

    @property
    def padded_rows(self) -> int:
        return self.n_shards * self.chunk

    @property
    def storage_bytes(self) -> int:
        tot = 0
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if hasattr(v, "size") and hasattr(v, "dtype"):
                tot += int(v.size) * np.dtype(v.dtype).itemsize
        return tot

    # -- shard-local views (used inside shard_map; block-sliced leaves) -----

    def local_interior(self, vals, cols, ho, s2h) -> HellMatrix:
        """Wrap one shard's interior slab as a HellMatrix over local x."""
        return HellMatrix(
            values=vals, col_indices=cols, hack_offsets=ho, slot_to_hack=s2h,
            row_lengths=None, row_perm=None,
            n_rows=self.chunk, n_cols=self.chunk, hack_size=self.hack_size,
            total_slots=vals.shape[0],
            max_hack_width=self.int_max_hack_width,
            avg_nnz_per_row=self.nnz / max(self.padded_rows, 1),
        )

    def local_exterior(self, vals, cols, ho, s2h) -> HellMatrix:
        """Wrap one shard's exterior slab as a HellMatrix over the halo."""
        return HellMatrix(
            values=vals, col_indices=cols, hack_offsets=ho, slot_to_hack=s2h,
            row_lengths=None, row_perm=None,
            n_rows=self.chunk, n_cols=self.n_shards * self.halo_width,
            hack_size=self.hack_size, total_slots=vals.shape[0],
            max_hack_width=self.ext_max_hack_width,
            avg_nnz_per_row=self.nnz / max(self.padded_rows, 1),
        )


def partition_coo_rows(
    coo: CooMatrix,
    n_shards: int,
    hack_size: int = HELL_HACK_SIZE,
) -> PartitionedMatrix:
    """Build a :class:`PartitionedMatrix` from a square host COO.

    Duplicate coordinates are kept as separate slots (both contribute to
    SpMV), matching the single-device conversions (``ell.c:65-78``).
    """
    if coo.n_rows != coo.n_cols:
        raise ValueError("halo-partitioned SpMV requires a square matrix")
    require_x64(coo.dtype)
    n = coo.n_rows
    chunk = round_up(-(-n // n_shards), hack_size)
    dtype = coo.dtype

    owner_r = coo.rows // chunk
    per_shard = []  # (local_rows, cols_global, vals) per shard
    for s in range(n_shards):
        sel = owner_r == s
        per_shard.append(
            (coo.rows[sel] - s * chunk, coo.cols[sel], coo.values[sel])
        )

    # --- halo plan: which external columns does each shard need? ----------
    # ext_cols_needed[s] = sorted unique global columns not owned by s
    ext_needed = []
    for s in range(n_shards):
        _, cols_g, _ = per_shard[s]
        owner_c = cols_g // chunk
        ext = np.unique(cols_g[owner_c != s]) if cols_g.size else np.array([], np.int64)
        ext_needed.append(ext)

    # send lists: send_list[p][s] = local positions on p that s needs
    send_list = [[None] * n_shards for _ in range(n_shards)]
    K = 1
    for s in range(n_shards):
        ext = ext_needed[s]
        owners = ext // chunk
        for p in range(n_shards):
            lst = (ext[owners == p] - p * chunk).astype(np.int64)
            send_list[p][s] = lst
            K = max(K, lst.size)

    send_idx = np.zeros((n_shards, n_shards, K), dtype=np.int32)
    # halo position of global col c on requester s: owner*K + rank-in-list
    halo_pos = []  # per shard: dict built as arrays
    for s in range(n_shards):
        ext = ext_needed[s]
        owners = ext // chunk
        pos = np.empty(ext.size, dtype=np.int64)
        for p in range(n_shards):
            sel = owners == p
            lst = send_list[p][s]
            send_idx[p, s, : lst.size] = lst
            pos[sel] = p * K + np.arange(lst.size)
        halo_pos.append((ext, pos))

    # --- per-shard slabs --------------------------------------------------
    int_slabs, ext_slabs = [], []
    for s in range(n_shards):
        lrows, cols_g, vals = per_shard[s]
        owner_c = cols_g // chunk
        is_int = owner_c == s
        # interior: local column = col - s*chunk
        int_slabs.append(
            _hell_arrays_from_entries(
                lrows[is_int], (cols_g[is_int] - s * chunk).astype(np.int64),
                vals[is_int], chunk, hack_size, dtype,
            )
        )
        # exterior: halo position via searchsorted into this shard's plan
        ext, pos = halo_pos[s]
        ec = cols_g[~is_int]
        hp = pos[np.searchsorted(ext, ec)] if ec.size else ec
        ext_slabs.append(
            _hell_arrays_from_entries(
                lrows[~is_int], hp.astype(np.int64), vals[~is_int],
                chunk, hack_size, dtype,
            )
        )

    def stack(slabs):
        t = max(sl[0].shape[0] for sl in slabs)
        v = np.stack([_pad_slots(sl[0], t) for sl in slabs])
        c = np.stack([_pad_slots(sl[1], t) for sl in slabs])
        ho = np.stack([sl[2] for sl in slabs])
        s2h = np.stack([_pad_slots(sl[3], t) for sl in slabs])
        return v, c, ho, s2h

    iv, ic, iho, is2h = stack(int_slabs)
    ev, ec_, eho, es2h = stack(ext_slabs)
    import jax.numpy as jnp

    def max_hw(slabs):
        return max(int(np.diff(sl[2]).max()) for sl in slabs)

    return PartitionedMatrix(
        int_values=jnp.asarray(iv), int_cols=jnp.asarray(ic),
        int_hack_offsets=jnp.asarray(iho), int_slot_to_hack=jnp.asarray(is2h),
        ext_values=jnp.asarray(ev), ext_cols=jnp.asarray(ec_),
        ext_hack_offsets=jnp.asarray(eho), ext_slot_to_hack=jnp.asarray(es2h),
        send_idx=jnp.asarray(send_idx),
        n_rows=n, n_shards=n_shards, chunk=chunk, hack_size=hack_size,
        halo_width=K, nnz=coo.nnz,
        int_max_hack_width=max_hw(int_slabs),
        ext_max_hack_width=max_hw(ext_slabs),
    )


def pad_vector(x, padded_rows: int):
    """Zero-pad a global vector to the partition's padded length."""
    import jax.numpy as jnp

    x = jnp.asarray(x)
    pad = padded_rows - x.shape[-1]
    if pad:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    return x
