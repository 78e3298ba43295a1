"""Format-selection heuristic tests (the diaPerf fallback analogue)."""

import numpy as np
import pytest

from spgpu_tpu.convert import estimate_formats, suggest_format
from spgpu_tpu.formats.coo import CooMatrix
from spgpu_tpu.utils.fixtures import laplacian_2d, random_banded, random_fem_like


def test_banded_prefers_diagonal_formats():
    coo = random_banded(2000, bands=9, wander=0, seed=1, dtype=np.float32)
    assert suggest_format(coo) in ("sdia", "dia", "hdia")


def test_wandering_band_prefers_whdia_over_dia():
    """A wandering band: per-hack diagonals (HDIA) beat global ones."""
    coo = random_banded(4000, bands=9, wander=37, seed=2, dtype=np.float32)
    est = estimate_formats(coo)
    assert est["hdia"].bytes_per_product < est["dia"].bytes_per_product
    assert suggest_format(coo) == "hdia"


def test_irregular_prefers_whell_over_ell():
    """Power-law rows: per-hack widths (HELL) beat the global width."""
    coo = random_fem_like(4000, 16.0, span=300, far_frac=0.02, seed=3,
                          dtype=np.float32)
    est = estimate_formats(coo)
    assert est["hell"].bytes_per_product < est["ell"].bytes_per_product
    assert suggest_format(coo) == "hell"


def test_laplacian_diagonal_formats_win():
    coo = laplacian_2d(50, 50, np.float32)
    assert suggest_format(coo) == "sdia"


def test_many_diagonals_fall_back_to_dia():
    """A dense band wider than SDIA_MAX_DIAGS keeps the DIA class but
    not the static-offset program."""
    from spgpu_tpu.convert.select import SDIA_MAX_DIAGS

    n, half = 600, SDIA_MAX_DIAGS // 2 + 4
    r, c = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    keep = np.abs(r - c) <= half
    coo = CooMatrix(r[keep], c[keep], np.ones(int(keep.sum())), n, n)
    assert suggest_format(coo) == "dia"


@pytest.mark.parametrize("dt", [np.float32, np.float64, np.complex128])
def test_estimates_scale_with_itemsize(dt):
    """Traffic estimates use the matrix's own value width."""
    coo = laplacian_2d(20, 20, np.float64)
    coo = CooMatrix(coo.rows, coo.cols, coo.values.astype(dt), coo.n_rows,
                    coo.n_cols)
    est = estimate_formats(coo)
    isz = np.dtype(dt).itemsize
    assert est["dia"].bytes_per_product == 5 * 512 * isz
    assert est["ell"].bytes_per_product == 5 * 512 * (isz + 4)


def test_empty_matrix():
    coo = CooMatrix(np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0), 8, 8)
    assert suggest_format(coo) == "ell"
