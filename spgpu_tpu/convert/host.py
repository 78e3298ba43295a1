"""Host-side format conversions (COO → ELL/OELL/HELL/DIA/HDIA/BCOO/BHDIA).

Re-design of the reference's single-threaded C/C++ conversion
routines (SURVEY §2.3; ``/root/reference/src/core/{ell.c,hell.c,dia.c,
hdia.cpp,coo.cpp}``).  Where the reference walks elements one at a time
with per-row cursors and ``std::map`` buckets, we vectorise everything
with NumPy (sort + prefix-sum + scatter); an optional C++ inner-loop
acceleration lives in ``spgpu_tpu.native``.

Semantics preserved from the reference:

* **Duplicates**: ``cooToEll`` keeps duplicate coordinates as *separate
  ELL slots* (both contribute to SpMV, ``ell.c:65-78``); ``coo2dia`` and
  ``cooToHdia`` plain-store into the (row, diag) cell so the *last* entry
  in file order wins (``dia.c:95-100``).  We match both behaviours and
  test them.
* **baseIndex**: handled once at :class:`CooMatrix` construction; all
  internal indices are 0-based.
* **Explicit zeros**: kept by COO→{ELL, HELL, DIA, HDIA} scatters;
  ``diaToHdia`` drops all-zero (hack, diagonal) blocks exactly like the
  reference's byte-occupancy scan (``hdia.cpp:44-52``).
* **OELL ordering**: rows sorted by descending length with a *stable*
  order (the reference uses merge sort, ``ell.c:85-157``).

Deviations (documented per function): row axes padded to
:data:`~spgpu_tpu.core.ROW_PITCH` elements (vs 32), ``hack_offsets``
carries a prefix-sum sentinel, and HELL/HDIA gain a ``slot_to_hack`` map
for segment-sum SpMV.  float64/complex128 values need 64-bit JAX
(:func:`~spgpu_tpu.core.require_x64`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from spgpu_tpu.core import (
    HDIA_HACK_SIZE, HELL_HACK_SIZE, ROW_PITCH, require_x64, round_up)
from spgpu_tpu.formats import (
    BcooMatrix,
    BhdiaMatrix,
    CooMatrix,
    DiaMatrix,
    EllMatrix,
    HdiaMatrix,
    HellMatrix,
)

__all__ = [
    "coo_to_ell",
    "ell_to_oell",
    "ell_to_hell",
    "coo_to_hell",
    "coo_to_dia",
    "dia_to_hdia",
    "coo_to_hdia",
    "coo_to_bcoo",
    "bcoo_to_bhdia",
    "compute_ell_row_lengths",
    "compute_ell_alloc_pitch",
    "compute_hell_alloc_size",
    "compute_dia_diagonals_count",
    "compute_dia_alloc_pitch",
    "get_hdia_hacks_count",
    "compute_hdia_hack_offsets",
    "compute_hdia_hack_offsets_from_coo",
    "coo_to_hdia_size",
    "compute_bcoo_size",
]


# ---------------------------------------------------------------------------
# Small parity helpers (reference: ell.c / hell.c / dia.c / hdia.cpp)
# ---------------------------------------------------------------------------


def compute_ell_row_lengths(coo: CooMatrix) -> np.ndarray:
    """Per-row nnz + implicit max; mirrors ``computeEllRowLenghts``
    (``ell.c:5-31``)."""
    return coo.row_lengths()


def compute_ell_alloc_pitch(n_rows: int) -> int:
    """Row-axis padding; mirrors ``computeEllAllocPitch`` (``ell.c:33-37``)
    — the reference rounds to 32 elements, we round to ``ROW_PITCH``."""
    return round_up(max(n_rows, 1), ROW_PITCH)


def compute_dia_diagonals_count(coo: CooMatrix) -> int:
    """Number of occupied diagonals; mirrors ``computeDiaDiagonalsCount``
    (``dia.c:11-38``)."""
    if coo.nnz == 0:
        return 0
    return int(np.unique(coo.cols - coo.rows).size)


def get_hdia_hacks_count(n_rows: int, hack_size: int = HDIA_HACK_SIZE) -> int:
    """Mirrors ``getHdiaHacksCount`` (``hdia.cpp:8-11``)."""
    return -(-n_rows // hack_size)


def compute_dia_alloc_pitch(n_rows: int) -> int:
    """Row-axis padding for DIA; mirrors ``computeDiaAllocPitch``
    (``dia.c:5-9``) — the reference rounds to 32, we round to ``ROW_PITCH``."""
    return round_up(max(n_rows, 1), ROW_PITCH)


def compute_hdia_hack_offsets_from_coo(
    coo: CooMatrix, hack_size: int = HDIA_HACK_SIZE
) -> np.ndarray:
    """Per-hack occupied-diagonal-count prefix sum; mirrors
    ``computeHdiaHackOffsetsFromCoo`` (``hdia.cpp:161-228``).  Returns a
    ``(hacks + 1,)`` array whose last entry is the total stored diagonal
    count (the HDIA allocation size in hack-width units)."""
    hacks = max(get_hdia_hacks_count(coo.n_rows, hack_size), 1)
    off = np.zeros(hacks + 1, dtype=np.int64)
    if coo.nnz:
        h = coo.rows.astype(np.int64) // hack_size
        d = coo.cols.astype(np.int64) - coo.rows
        # diagonal range is [-(n_rows-1), n_cols-1]; bias by n_rows and use
        # a span covering both so keys stay non-negative and collision-free
        # for rectangular (tall or wide) shapes — the reference handles
        # these via per-hack std::map buckets (hdia.cpp:161-228).
        span = coo.n_rows + coo.n_cols
        per_hack = np.unique(h * span + (d + coo.n_rows))
        counts = np.bincount(per_hack // span, minlength=hacks)
        np.cumsum(counts, out=off[1:])
    return off


def compute_hdia_hack_offsets(
    dia: DiaMatrix, hack_size: int = HDIA_HACK_SIZE
) -> np.ndarray:
    """Per-hack occupied-diagonal prefix sum from a DIA matrix; mirrors
    ``computeHdiaHackOffsets`` (``hdia.cpp:13-61``) — a diagonal counts
    for a hack iff any of its values in that hack's rows is nonzero (the
    reference's byte-occupancy scan)."""
    vals = np.asarray(dia.values)[:, : dia.n_rows]
    hacks = max(get_hdia_hacks_count(dia.n_rows, hack_size), 1)
    off = np.zeros(hacks + 1, dtype=np.int64)
    for hk in range(hacks):
        blk = vals[: dia.n_diags, hk * hack_size:(hk + 1) * hack_size]
        off[hk + 1] = off[hk] + int((blk != 0).any(axis=1).sum())
    return off


def coo_to_hdia_size(coo: CooMatrix, hack_size: int = HDIA_HACK_SIZE) -> int:
    """Stored-element count of the HDIA conversion; mirrors
    ``cooToHdiaSize`` (``hdia.cpp:230-249``)."""
    return int(compute_hdia_hack_offsets_from_coo(coo, hack_size)[-1]) * hack_size


def compute_bcoo_size(coo: CooMatrix, block_rows: int, block_cols: int) -> int:
    """Number of occupied dense blocks; mirrors ``computeBcooSize``
    (``coo.cpp:7-28``)."""
    if coo.nnz == 0:
        return 0
    br = coo.rows // block_rows
    bc = coo.cols // block_cols
    nbc = -(-coo.n_cols // block_cols)
    return int(np.unique(br * nbc + bc).size)


def _per_row_positions(rows: np.ndarray, counts: np.ndarray) -> tuple:
    """Stable sort entries by row; return (order, k) where ``k`` is each
    entry's 0-based slot within its row in original file order — the
    vectorised version of the reference's per-row cursor walk
    (``ell.c:55-78``)."""
    order = np.argsort(rows, kind="stable")
    starts = np.zeros(counts.size + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    k = np.arange(rows.size, dtype=np.int64) - starts[rows[order]]
    return order, k


# ---------------------------------------------------------------------------
# ELL / OELL
# ---------------------------------------------------------------------------


def coo_to_ell(
    coo: CooMatrix,
    store_row_lengths: bool = True,
) -> EllMatrix:
    """COO → ELL; mirrors ``cooToEll`` (``ell.c:39-80``).

    ``store_row_lengths=False`` yields the "noRs" variant exercised by the
    reference's ``hellperf_norowsize`` builds (``ell_spmv_base_nors.cuh``):
    ``row_lengths is None`` and every row is taken to be
    ``max_nnz_per_row`` long with zero padding — which our zero-padded
    layout satisfies by construction.
    """
    require_x64(coo.dtype)
    counts = coo.row_lengths()
    max_nnz = int(counts.max()) if counts.size and coo.nnz else 0
    width_p = max(max_nnz, 1)
    rows_p = compute_ell_alloc_pitch(coo.n_rows)

    vals = np.zeros((width_p, rows_p), dtype=coo.dtype)
    cols = np.zeros((width_p, rows_p), dtype=np.int32)
    if coo.nnz:
        order, k = _per_row_positions(coo.rows, counts)
        r = coo.rows[order]
        vals[k, r] = coo.values[order]
        cols[k, r] = coo.cols[order]

    lens = None
    if store_row_lengths:
        lens = np.zeros(rows_p, dtype=np.int32)
        lens[: coo.n_rows] = counts

    avg = float(coo.nnz) / max(coo.n_rows, 1)
    import jax.numpy as jnp

    return EllMatrix(
        values=jnp.asarray(vals),
        col_indices=jnp.asarray(cols),
        row_lengths=None if lens is None else jnp.asarray(lens),
        row_perm=None,
        n_rows=coo.n_rows,
        n_cols=coo.n_cols,
        max_nnz_per_row=max_nnz,
        avg_nnz_per_row=avg,
    )


def ell_to_oell(ell: EllMatrix) -> EllMatrix:
    """ELL → OELL: stable sort of rows by **descending** length, storing the
    stored-row → original-row permutation; mirrors ``ellToOell``
    (``ell.c:161-202``, SpMV scatters to ``z[rIdx[i]]``).

    Padding rows (length 0, index ≥ n_rows) sort after every genuine row of
    equal length thanks to stability, so ``row_perm[i] >= n_rows`` exactly
    for stored padding rows.
    """
    if ell.row_lengths is None:
        raise ValueError("OELL requires row_lengths (not available in noRs mode)")
    lens = np.asarray(ell.row_lengths)
    perm = np.argsort(-lens.astype(np.int64), kind="stable").astype(np.int32)
    import jax.numpy as jnp

    return EllMatrix(
        values=jnp.asarray(np.asarray(ell.values)[:, perm]),
        col_indices=jnp.asarray(np.asarray(ell.col_indices)[:, perm]),
        row_lengths=jnp.asarray(lens[perm]),
        row_perm=jnp.asarray(perm),
        n_rows=ell.n_rows,
        n_cols=ell.n_cols,
        max_nnz_per_row=ell.max_nnz_per_row,
        avg_nnz_per_row=ell.avg_nnz_per_row,
    )


# ---------------------------------------------------------------------------
# HELL
# ---------------------------------------------------------------------------


def compute_hell_alloc_size(
    counts: np.ndarray, n_rows: int, hack_size: int = HELL_HACK_SIZE
) -> int:
    """Σ per-hack max row length; mirrors ``computeHellAllocSize``
    (``hell.c:4-44``)."""
    w = _hack_widths(counts, n_rows, hack_size)
    return int(w.sum())


def _hack_widths(counts, n_rows, hack_size) -> np.ndarray:
    rows_p = round_up(max(n_rows, 1), hack_size)
    lens = np.zeros(rows_p, dtype=np.int64)
    lens[:n_rows] = counts[:n_rows]
    w = lens.reshape(-1, hack_size).max(axis=1)
    if w.sum() == 0:
        w[0] = 1  # avoid zero-sized device arrays for empty matrices
    return w


def coo_to_hell(
    coo: CooMatrix,
    hack_size: int = HELL_HACK_SIZE,
    row_perm: Optional[np.ndarray] = None,
) -> HellMatrix:
    """COO → HELL directly (the reference route is COO→ELL→HELL,
    ``hellPerf.cpp:254-280``; going direct avoids materialising the
    global-width ELL, whose padding blow-up is the very thing HELL kills).

    ``row_perm`` (stored-row → original-row, as produced by
    :func:`ell_to_oell`'s ordering) yields a hacked-OELL: rows are permuted
    *before* hacking so each hack holds similar-length rows — the
    reference's ``hellperf`` OELL+HELL leg.
    """
    require_x64(coo.dtype)
    if row_perm is not None:
        # invert stored→original into original→stored, route entries to
        # their stored row before hacking (hacked-OELL).
        row_perm = np.asarray(row_perm, dtype=np.int32)
        stored_of_orig = np.full(coo.n_rows, -1, dtype=np.int64)
        valid = row_perm < coo.n_rows
        stored_of_orig[row_perm[valid]] = np.nonzero(valid)[0]
        eff_rows = stored_of_orig[coo.rows]
        n_stored_rows = int(row_perm.size)
        counts = np.bincount(eff_rows, minlength=n_stored_rows).astype(np.int32)
    else:
        eff_rows = coo.rows
        counts = coo.row_lengths()
        n_stored_rows = coo.n_rows

    w = _hack_widths(counts, n_stored_rows, hack_size)
    num_hacks = w.size
    hack_off = np.zeros(num_hacks + 1, dtype=np.int32)
    np.cumsum(w, out=hack_off[1:])
    total = int(hack_off[-1])

    vals = np.zeros((total, hack_size), dtype=coo.dtype)
    cols = np.zeros((total, hack_size), dtype=np.int32)
    if coo.nnz:
        order, k = _per_row_positions(eff_rows, counts)
        r = eff_rows[order]
        h = r // hack_size
        slot = hack_off[h] + k
        lane = r % hack_size
        vals[slot, lane] = coo.values[order]
        cols[slot, lane] = coo.cols[order]

    rows_p = num_hacks * hack_size
    lens = np.zeros(rows_p, dtype=np.int32)
    lens[: min(counts.size, rows_p)] = counts[: min(counts.size, rows_p)]
    s2h = np.repeat(np.arange(num_hacks, dtype=np.int32), w)

    import jax.numpy as jnp

    perm_arr = None
    if row_perm is not None:
        perm_p = np.arange(rows_p, dtype=np.int32)
        perm_p[: row_perm.size] = row_perm
        perm_arr = jnp.asarray(perm_p)

    return HellMatrix(
        values=jnp.asarray(vals),
        col_indices=jnp.asarray(cols),
        hack_offsets=jnp.asarray(hack_off),
        slot_to_hack=jnp.asarray(s2h),
        row_lengths=jnp.asarray(lens),
        row_perm=perm_arr,
        n_rows=coo.n_rows,
        n_cols=coo.n_cols,
        hack_size=hack_size,
        total_slots=total,
        max_hack_width=int(w.max()) if w.size else 0,
        avg_nnz_per_row=float(coo.nnz) / max(coo.n_rows, 1),
    )


def ell_to_hell(ell: EllMatrix, hack_size: int = HELL_HACK_SIZE) -> HellMatrix:
    """ELL → HELL; mirrors ``ellToHell`` (``hell.c:46-104``).

    Carries the ELL's ``row_perm`` through unchanged (OELL → hacked-OELL,
    the reference's ``hellPerf`` ordered leg, ``hellPerf.cpp:323-344``).
    """
    if ell.row_lengths is None:
        raise ValueError("ell_to_hell requires row_lengths")
    lens = np.asarray(ell.row_lengths)
    evals = np.asarray(ell.values)
    ecols = np.asarray(ell.col_indices)
    rows_p0 = evals.shape[1]

    w = _hack_widths(lens, rows_p0, hack_size)
    num_hacks = w.size
    hack_off = np.zeros(num_hacks + 1, dtype=np.int32)
    np.cumsum(w, out=hack_off[1:])
    total = int(hack_off[-1])
    rows_p = num_hacks * hack_size

    vals = np.zeros((total, hack_size), dtype=evals.dtype)
    cols = np.zeros((total, hack_size), dtype=np.int32)
    for h in range(num_hacks):
        wh = int(w[h])
        r0, r1 = h * hack_size, min((h + 1) * hack_size, rows_p0)
        span = r1 - r0
        if span <= 0:
            continue
        take = min(wh, evals.shape[0])
        vals[hack_off[h] : hack_off[h] + take, :span] = evals[:take, r0:r1]
        cols[hack_off[h] : hack_off[h] + take, :span] = ecols[:take, r0:r1]

    lens_p = np.zeros(rows_p, dtype=np.int32)
    lens_p[: min(lens.size, rows_p)] = lens[: min(lens.size, rows_p)]
    s2h = np.repeat(np.arange(num_hacks, dtype=np.int32), w)

    import jax.numpy as jnp

    perm_arr = None
    if ell.row_perm is not None:
        perm0 = np.asarray(ell.row_perm)
        perm_p = np.arange(rows_p, dtype=np.int32)
        perm_p[: perm0.size] = perm0
        perm_arr = jnp.asarray(perm_p)

    return HellMatrix(
        values=jnp.asarray(vals),
        col_indices=jnp.asarray(cols),
        hack_offsets=jnp.asarray(hack_off),
        slot_to_hack=jnp.asarray(s2h),
        row_lengths=jnp.asarray(lens_p),
        row_perm=perm_arr,
        n_rows=ell.n_rows,
        n_cols=ell.n_cols,
        hack_size=hack_size,
        total_slots=total,
        max_hack_width=int(w.max()) if w.size else 0,
        avg_nnz_per_row=ell.avg_nnz_per_row,
    )


# ---------------------------------------------------------------------------
# DIA / HDIA
# ---------------------------------------------------------------------------


def coo_to_dia(coo: CooMatrix) -> DiaMatrix:
    """COO → DIA; mirrors ``coo2dia`` (``dia.c:40-104``): diagonals stored
    ascending by offset id; duplicate coordinates last-write-wins."""
    import jax.numpy as jnp

    require_x64(coo.dtype)
    rows_p = compute_ell_alloc_pitch(coo.n_rows)
    if coo.nnz == 0:
        return DiaMatrix(
            values=jnp.zeros((1, rows_p), dtype=coo.dtype),
            offsets=jnp.full((1,), coo.n_cols, dtype=np.int32),
            n_rows=coo.n_rows,
            n_cols=coo.n_cols,
            n_diags=0,
        )
    offs_all = coo.cols - coo.rows
    uniq = np.unique(offs_all)
    n_diags = int(uniq.size)

    vals = np.zeros((n_diags, rows_p), dtype=coo.dtype)
    j = np.searchsorted(uniq, offs_all)
    vals[j, coo.rows] = coo.values  # duplicates: last write wins (dia.c:95-100)

    return DiaMatrix(
        values=jnp.asarray(vals),
        offsets=jnp.asarray(uniq.astype(np.int32)),
        n_rows=coo.n_rows,
        n_cols=coo.n_cols,
        n_diags=n_diags,
    )


def _build_hdia(
    vals_src_fn,
    hack_of_entry: np.ndarray,
    off_of_entry: np.ndarray,
    num_hacks: int,
    n_cols_sentinel: int,
    hack_size: int,
    dtype,
    block_shape=(),
):
    """Shared HDIA slot construction from per-entry (hack, offset) keys.

    Returns (values, offsets, hack_offsets, slot_to_hack, slot_of_entry,
    total, max_hack_diags).
    """
    # unique (hack, offset) pairs, sorted by hack then offset ascending —
    # the reference's per-hack ascending diagonal order (hdia.cpp:68-153).
    span = int(off_of_entry.max() - off_of_entry.min()) + 1 if off_of_entry.size else 1
    off0 = int(off_of_entry.min()) if off_of_entry.size else 0
    key = hack_of_entry.astype(np.int64) * span + (off_of_entry - off0)
    uniq_keys, inv = np.unique(key, return_inverse=True)
    uh = (uniq_keys // span).astype(np.int64)
    uo = (uniq_keys % span + off0).astype(np.int64)

    counts = np.bincount(uh, minlength=num_hacks)  # diags per hack
    w = counts.copy()
    if w.sum() == 0:
        w[0] = 1
    hack_off = np.zeros(num_hacks + 1, dtype=np.int32)
    np.cumsum(w, out=hack_off[1:])
    total = int(hack_off[-1])

    starts = np.zeros(num_hacks + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    rank_in_hack = np.arange(uniq_keys.size) - starts[uh]
    slot_of_uniq = hack_off[uh] + rank_in_hack
    slot_of_entry = slot_of_uniq[inv]

    vals = np.zeros((total, hack_size) + block_shape, dtype=dtype)
    vals_src_fn(vals, slot_of_entry)

    offsets = np.full(total, n_cols_sentinel, dtype=np.int32)
    offsets[slot_of_uniq] = uo
    s2h = np.repeat(np.arange(num_hacks, dtype=np.int32), w)
    max_diags = int(counts.max()) if counts.size else 0
    return vals, offsets, hack_off, s2h, total, max_diags


def coo_to_hdia(coo: CooMatrix, hack_size: int = HDIA_HACK_SIZE) -> HdiaMatrix:
    """COO → HDIA directly; mirrors ``cooToHdia`` +
    ``computeHdiaHackOffsetsFromCoo`` (``hdia.cpp:161-348``).

    Diagonals are keyed by the global offset ``col − row`` (the reference
    keys them relative to the hack's first row — an equivalent partition,
    see ``formats/hdia.py``).  Duplicates last-write-wins, matching the
    reference's plain store.
    """
    import jax.numpy as jnp

    require_x64(coo.dtype)
    num_hacks = max(get_hdia_hacks_count(coo.n_rows, hack_size), 1)
    if coo.nnz == 0:
        return HdiaMatrix(
            values=jnp.zeros((1, hack_size), dtype=coo.dtype),
            offsets=jnp.full((1,), coo.n_cols, dtype=np.int32),
            hack_offsets=jnp.asarray(
                np.concatenate([[0], np.full(num_hacks, 1)]).astype(np.int32)
            ),
            slot_to_hack=jnp.zeros((1,), dtype=np.int32),
            n_rows=coo.n_rows,
            n_cols=coo.n_cols,
            hack_size=hack_size,
            total_slots=1,
            max_hack_diags=0,
        )

    hack_of_entry = coo.rows // hack_size
    off_of_entry = coo.cols - coo.rows
    lane = coo.rows % hack_size

    def fill(vals, slot_of_entry):
        vals[slot_of_entry, lane] = coo.values

    vals, offsets, hack_off, s2h, total, max_diags = _build_hdia(
        fill, hack_of_entry, off_of_entry, num_hacks, coo.n_cols, hack_size, coo.dtype
    )
    return HdiaMatrix(
        values=jnp.asarray(vals),
        offsets=jnp.asarray(offsets),
        hack_offsets=jnp.asarray(hack_off),
        slot_to_hack=jnp.asarray(s2h),
        n_rows=coo.n_rows,
        n_cols=coo.n_cols,
        hack_size=hack_size,
        total_slots=total,
        max_hack_diags=max_diags,
    )


def dia_to_hdia(dia: DiaMatrix, hack_size: int = HDIA_HACK_SIZE) -> HdiaMatrix:
    """DIA → HDIA; mirrors ``computeHdiaHackOffsets`` + ``diaToHdia``
    (``hdia.cpp:13-153``): a (hack, diagonal) block is kept iff it contains
    any nonzero value (byte-occupancy scan in the reference) — explicit
    stored zeros on an otherwise-empty block are dropped."""
    import jax.numpy as jnp

    vals0 = np.asarray(dia.values)[: dia.n_diags]
    offs0 = np.asarray(dia.offsets)[: dia.n_diags]
    num_hacks = max(get_hdia_hacks_count(dia.n_rows, hack_size), 1)
    rows_hp = num_hacks * hack_size
    if vals0.shape[1] < rows_hp:
        vals0 = np.pad(vals0, ((0, 0), (0, rows_hp - vals0.shape[1])))
    blocks = vals0[:, :rows_hp].reshape(dia.n_diags, num_hacks, hack_size)
    occupied = (blocks != 0).any(axis=2)  # (diags, hacks)

    d_idx, h_idx = np.nonzero(occupied)
    # order by (hack, offset ascending): offsets in DIA are ascending by
    # construction, so sort by (h, d) keeps per-hack ascending order.
    order = np.lexsort((d_idx, h_idx))
    d_idx, h_idx = d_idx[order], h_idx[order]

    def fill(vals, slot_of_entry):
        vals[slot_of_entry] = blocks[d_idx, h_idx]

    # reuse _build_hdia with one "entry" per occupied (hack, diag) block
    vals, offsets, hack_off, s2h, total, max_diags = _build_hdia(
        fill,
        h_idx.astype(np.int64),
        offs0[d_idx].astype(np.int64),
        num_hacks,
        dia.n_cols,
        hack_size,
        vals0.dtype,
        block_shape=(),
    )
    # note: fill wrote whole (hack_size,) rows at once — shapes align since
    # blocks[d,h] is (hack_size,).
    return HdiaMatrix(
        values=jnp.asarray(vals),
        offsets=jnp.asarray(offsets),
        hack_offsets=jnp.asarray(hack_off),
        slot_to_hack=jnp.asarray(s2h),
        n_rows=dia.n_rows,
        n_cols=dia.n_cols,
        hack_size=hack_size,
        total_slots=total,
        max_hack_diags=max_diags,
    )


# ---------------------------------------------------------------------------
# BCOO / BHDIA
# ---------------------------------------------------------------------------


def coo_to_bcoo(coo: CooMatrix, block_rows: int, block_cols: int) -> BcooMatrix:
    """COO → BCOO; mirrors ``computeBcooSize`` + ``cooToBcoo``
    (``coo.cpp:7-96``).  Blocks ordered row-major by (blockRow, blockCol)
    (the reference's ``std::map`` key packs blockCol into the high bits —
    column-major block order; the order is an internal detail and our SpMV
    and tests are order-independent).  Duplicates last-write-wins inside a
    block cell, matching the reference's plain store."""
    import jax.numpy as jnp

    require_x64(coo.dtype)
    brow = coo.rows // block_rows
    bcol = coo.cols // block_cols
    nbc = -(-coo.n_cols // block_cols)
    key = brow * nbc + bcol
    uniq, inv = np.unique(key, return_inverse=True)
    n_blocks = max(int(uniq.size), 1)

    blocks = np.zeros((n_blocks, block_rows, block_cols), dtype=coo.dtype)
    if coo.nnz:
        blocks[inv, coo.rows % block_rows, coo.cols % block_cols] = coo.values
    bri = (uniq // nbc).astype(np.int32) if uniq.size else np.zeros(1, np.int32)
    bci = (uniq % nbc).astype(np.int32) if uniq.size else np.zeros(1, np.int32)
    return BcooMatrix(
        block_row_idx=jnp.asarray(bri),
        block_col_idx=jnp.asarray(bci),
        blocks=jnp.asarray(blocks),
        n_rows=coo.n_rows,
        n_cols=coo.n_cols,
        block_rows=block_rows,
        block_cols=block_cols,
    )


def bcoo_to_bhdia(bcoo: BcooMatrix, hack_size: int = 32) -> BhdiaMatrix:
    """BCOO → BHDIA; mirrors ``bcooToBhdia`` (``hdia.cpp:351-373``): HDIA
    machinery applied to block coordinates, elements being dense blocks."""
    import jax.numpy as jnp

    bri = np.asarray(bcoo.block_row_idx).astype(np.int64)
    bci = np.asarray(bcoo.block_col_idx).astype(np.int64)
    blocks = np.asarray(bcoo.blocks)
    nbr = bcoo.n_block_rows if hasattr(bcoo, "n_block_rows") else -(-bcoo.n_rows // bcoo.block_rows)
    nbc = -(-bcoo.n_cols // bcoo.block_cols)
    num_hacks = max(-(-nbr // hack_size), 1)

    hack_of_entry = bri // hack_size
    off_of_entry = bci - bri
    lane = bri % hack_size

    def fill(vals, slot_of_entry):
        vals[slot_of_entry, lane] = blocks

    vals, offsets, hack_off, s2h, total, max_diags = _build_hdia(
        fill,
        hack_of_entry,
        off_of_entry,
        num_hacks,
        nbc,
        hack_size,
        blocks.dtype,
        block_shape=(bcoo.block_rows, bcoo.block_cols),
    )
    return BhdiaMatrix(
        values=jnp.asarray(vals),
        offsets=jnp.asarray(offsets),
        hack_offsets=jnp.asarray(hack_off),
        slot_to_hack=jnp.asarray(s2h),
        n_rows=bcoo.n_rows,
        n_cols=bcoo.n_cols,
        block_rows=bcoo.block_rows,
        block_cols=bcoo.block_cols,
        hack_size=hack_size,
    )
