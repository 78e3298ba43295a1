"""Format selection heuristics.

The reference leaves format choice to the caller, with one runtime
fallback: ``diaPerf`` checks whether the dense DIA slab fits device
memory and skips to HDIA when it doesn't
(``/root/reference/src/tests/diaPerf.cpp:174-183``).  This module makes
that decision a first-class, testable API: SpMV is bound by memory
traffic, so estimate each format's bytes per product from cheap COO
statistics and pick the layout that moves the fewest.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from spgpu_tpu.core import HDIA_HACK_SIZE, HELL_HACK_SIZE, ROW_PITCH, round_up
from spgpu_tpu.formats.coo import CooMatrix

__all__ = ["FormatEstimate", "estimate_formats", "suggest_format",
           "SDIA_MAX_DIAGS"]

#: SDIA unrolls one static slice per diagonal into the compiled program;
#: past this many diagonals the DIA class runs :class:`DiaMatrix` instead.
SDIA_MAX_DIAGS = 64


@dataclasses.dataclass
class FormatEstimate:
    fmt: str
    bytes_per_product: float  # matrix traffic per SpMV (values + indices)
    pad_factor: float  # stored cells / nnz

    def json(self):
        return dataclasses.asdict(self)


def estimate_formats(coo: CooMatrix) -> Dict[str, FormatEstimate]:
    """Cheap COO-statistics estimates of per-product matrix traffic.

    * DIA: distinct diagonals × padded rows, values only;
    * HDIA: distinct (hack, diagonal) pairs × hack size, values only
      (plus 8 B of offset and hack id per slot);
    * HELL: per-hack max row length × hack size, value + int32 column
      (plus 4 B of hack id per slot);
    * ELL: global max row length × padded rows, value + int32 column.

    Dictionary order breaks ties: the index-free layouts come first.
    """
    n, m = coo.n_rows, coo.nnz
    if m == 0:
        return {"ell": FormatEstimate("ell", 0.0, 1.0)}
    isz = coo.values.dtype.itemsize
    rows_p = round_up(n, ROW_PITCH)
    lens = coo.row_lengths()
    diag = coo.cols - coo.rows

    out: Dict[str, FormatEstimate] = {}

    cells = np.unique(diag).size * rows_p
    out["dia"] = FormatEstimate("dia", cells * isz, cells / m)

    # diag spans [-(n-1), n_cols-1]: bias by n and pack with span n+n_cols
    # so keys stay collision-free for rectangular shapes.
    hs = HDIA_HACK_SIZE
    slots = np.unique((coo.rows // hs).astype(np.int64) * (n + coo.n_cols)
                      + (diag + n)).size
    cells = slots * hs
    out["hdia"] = FormatEstimate("hdia", cells * isz + slots * 8, cells / m)

    hs = HELL_HACK_SIZE
    w = np.zeros(round_up(n, hs), np.int64)
    w[:n] = lens
    slots = int(w.reshape(-1, hs).max(axis=1).sum())
    cells = slots * hs
    out["hell"] = FormatEstimate("hell", cells * (isz + 4) + slots * 4,
                                 cells / m)

    cells = int(lens.max()) * rows_p
    out["ell"] = FormatEstimate("ell", cells * (isz + 4), cells / m)
    return out


def suggest_format(coo: CooMatrix) -> str:
    """The layout :func:`~spgpu_tpu.solvers.solve` builds: the format
    with the least per-product traffic, with the DIA class as SDIA while
    it has at most :data:`SDIA_MAX_DIAGS` diagonals.  Returns one of
    ``"sdia"``, ``"dia"``, ``"hdia"``, ``"hell"``, ``"ell"``."""
    est = estimate_formats(coo)
    fmt = min(est.values(), key=lambda e: e.bytes_per_product).fmt
    if fmt == "dia" and np.unique(coo.cols - coo.rows).size <= SDIA_MAX_DIAGS:
        return "sdia"
    return fmt
