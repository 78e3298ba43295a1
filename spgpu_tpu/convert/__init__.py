"""Format conversion routines (host-side).

See :mod:`spgpu_tpu.convert.host` for the NumPy implementations and the
reference-parity notes (SURVEY §2.3), :mod:`~spgpu_tpu.convert.sdia` for
the static-offset DIA layout and :mod:`~spgpu_tpu.convert.select` for the
automatic format choice.
"""

from spgpu_tpu.convert.sdia import coo_to_sdia, dia_to_sdia
from spgpu_tpu.convert.select import estimate_formats, suggest_format
from spgpu_tpu.convert.host import (
    bcoo_to_bhdia,
    compute_bcoo_size,
    compute_dia_alloc_pitch,
    compute_dia_diagonals_count,
    compute_ell_alloc_pitch,
    compute_hdia_hack_offsets,
    compute_hdia_hack_offsets_from_coo,
    coo_to_hdia_size,
    compute_ell_row_lengths,
    compute_hell_alloc_size,
    coo_to_bcoo,
    coo_to_dia,
    coo_to_ell,
    coo_to_hdia,
    coo_to_hell,
    dia_to_hdia,
    ell_to_hell,
    ell_to_oell,
    get_hdia_hacks_count,
)

__all__ = [
    "coo_to_sdia",
    "dia_to_sdia",
    "estimate_formats",
    "suggest_format",
    "bcoo_to_bhdia",
    "compute_bcoo_size",
    "compute_dia_alloc_pitch",
    "compute_dia_diagonals_count",
    "compute_hdia_hack_offsets",
    "compute_hdia_hack_offsets_from_coo",
    "coo_to_hdia_size",
    "compute_ell_alloc_pitch",
    "compute_ell_row_lengths",
    "compute_hell_alloc_size",
    "coo_to_bcoo",
    "coo_to_dia",
    "coo_to_ell",
    "coo_to_hdia",
    "coo_to_hell",
    "dia_to_hdia",
    "ell_to_hell",
    "ell_to_oell",
    "get_hdia_hacks_count",
]
