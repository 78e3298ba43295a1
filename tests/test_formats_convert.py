"""M0: formats + conversions vs dense golden (SURVEY §4 pattern 1 —
golden host reference, here scipy-free NumPy densification)."""

import numpy as np
import pytest

from spgpu_tpu import convert
from spgpu_tpu.core import HDIA_HACK_SIZE as HS, HELL_HACK_SIZE, ROW_PITCH
from spgpu_tpu.formats import CooMatrix
from spgpu_tpu.utils import ctest_fixture, laplacian_2d, random_banded, random_irregular


def _fixtures():
    return {
        "laplacian": laplacian_2d(13, 11),
        "irregular": random_irregular(300, 250, avg_nnz_per_row=7.0, seed=3),
        "banded": random_banded(260, bands=7, wander=3, seed=4),
        "tiny": CooMatrix.from_arrays([0, 2, 2], [1, 0, 2], [1.0, 2.0, 3.0], 3, 3),
        "empty_rows": CooMatrix.from_arrays(
            [0, 0, 5], [0, 3, 5], [1.0, 2.0, 3.0], 7, 6
        ),
    }


FIX = _fixtures()


@pytest.fixture(params=sorted(FIX))
def coo(request):
    return FIX[request.param]


def test_coo_dense_roundtrip(coo):
    d = coo.to_dense()
    assert d.shape == coo.shape


def test_coo_base_index():
    a = CooMatrix.from_arrays([1, 2], [1, 3], [5.0, 6.0], 3, 3, base_index=1)
    d = a.to_dense()
    assert d[0, 0] == 5.0 and d[1, 2] == 6.0


def test_ell_matches_dense(coo):
    ell = convert.coo_to_ell(coo)
    np.testing.assert_allclose(ell.to_dense(), coo.to_dense(), rtol=0, atol=0)
    # row-pitch invariant
    assert ell.values.shape[1] % ROW_PITCH == 0
    assert ell.values.shape == ell.col_indices.shape


def test_ell_nors_mode(coo):
    ell = convert.coo_to_ell(coo, store_row_lengths=False)
    assert ell.row_lengths is None
    np.testing.assert_allclose(ell.to_dense(), coo.to_dense())


def test_oell_matches_dense_and_is_sorted(coo):
    ell = convert.coo_to_ell(coo)
    oell = convert.ell_to_oell(ell)
    np.testing.assert_allclose(oell.to_dense(), coo.to_dense())
    lens = np.asarray(oell.row_lengths)
    assert (np.diff(lens) <= 0).all(), "OELL rows must be descending by length"
    # stored padding rows map to >= n_rows
    perm = np.asarray(oell.row_perm)
    assert set(perm.tolist()) == set(range(ell.rows_padded))


def test_hell_matches_dense(coo):
    hell = convert.coo_to_hell(coo)
    np.testing.assert_allclose(hell.to_dense(), coo.to_dense())
    ho = np.asarray(hell.hack_offsets)
    assert ho[0] == 0 and ho[-1] == hell.total_slots
    assert (np.diff(ho) >= 0).all()


def test_ell_to_hell_matches_direct(coo):
    ell = convert.coo_to_ell(coo)
    h1 = convert.ell_to_hell(ell)
    h2 = convert.coo_to_hell(coo)
    np.testing.assert_allclose(h1.to_dense(), h2.to_dense())
    assert h1.total_slots == h2.total_slots


def test_hell_saves_padding_vs_ell():
    coo = random_irregular(2000, 2000, avg_nnz_per_row=8.0, alpha=1.2, seed=7)
    ell = convert.coo_to_ell(coo)
    hell = convert.coo_to_hell(coo)
    assert hell.storage_bytes < ell.storage_bytes, (
        "HELL must beat ELL storage on irregular rows (its raison d'être)"
    )


def test_hacked_oell(coo):
    """OELL ordering + hacking: the reference's ordered HELL leg
    (hellPerf.cpp:323-344)."""
    ell = convert.coo_to_ell(coo)
    oell = convert.ell_to_oell(ell)
    h = convert.coo_to_hell(coo, row_perm=np.asarray(oell.row_perm))
    np.testing.assert_allclose(h.to_dense(), coo.to_dense())


def test_dia_matches_dense(coo):
    dia = convert.coo_to_dia(coo)
    # duplicates: DIA is last-write-wins, dense golden adds — compare via
    # a dedup'd COO when duplicates exist.
    ref = coo.sum_duplicates().to_dense() if _has_dups(coo) else coo.to_dense()
    if not _has_dups(coo):
        np.testing.assert_allclose(dia.to_dense(), ref)
    offs = np.asarray(dia.offsets)[: dia.n_diags]
    assert (np.diff(offs) > 0).all(), "diagonal offsets ascending (dia.c:76-85)"


def test_hdia_matches_dense(coo):
    if _has_dups(coo):
        pytest.skip("duplicate policy differs (last-write-wins)")
    hdia = convert.coo_to_hdia(coo)
    np.testing.assert_allclose(hdia.to_dense(), coo.to_dense())


def test_dia_to_hdia_matches(coo):
    if _has_dups(coo):
        pytest.skip("duplicate policy differs")
    dia = convert.coo_to_dia(coo)
    hdia = convert.dia_to_hdia(dia)
    np.testing.assert_allclose(hdia.to_dense(), coo.to_dense())


def test_hdia_beats_dia_on_wandering_band():
    coo = random_banded(4000, bands=5, wander=11, seed=5)
    dia = convert.coo_to_dia(coo)
    hdia = convert.coo_to_hdia(coo)
    assert hdia.storage_bytes < dia.storage_bytes, (
        "HDIA must beat DIA storage when the band wanders (its raison d'être)"
    )


def test_duplicates_kept_in_ell():
    """The ctest fixture: every diagonal hit twice → ELL stores both and
    SpMV sums them (ctest.c:25-39 + ell.c:65-78)."""
    coo = ctest_fixture()
    ell = convert.coo_to_ell(coo)
    assert ell.max_nnz_per_row == 2
    d = ell.to_dense()
    np.testing.assert_allclose(np.diag(d), 2.0)


def test_bcoo_roundtrip(coo):
    if _has_dups(coo):
        pytest.skip("duplicate policy differs")
    b = convert.coo_to_bcoo(coo, 4, 4)
    np.testing.assert_allclose(b.to_dense(), coo.to_dense())


def test_bhdia_roundtrip(coo):
    if _has_dups(coo):
        pytest.skip("duplicate policy differs")
    b = convert.coo_to_bcoo(coo, 4, 4)
    bh = convert.bcoo_to_bhdia(b, hack_size=8)
    np.testing.assert_allclose(bh.to_dense(), coo.to_dense())


def test_parity_helpers(coo):
    assert convert.compute_ell_alloc_pitch(coo.n_rows) % ROW_PITCH == 0
    nd = convert.compute_dia_diagonals_count(coo)
    dia = convert.coo_to_dia(coo)
    assert nd == dia.n_diags
    counts = convert.compute_ell_row_lengths(coo)
    assert counts.sum() == coo.nnz
    sz = convert.compute_hell_alloc_size(counts, coo.n_rows, HELL_HACK_SIZE)
    hell = convert.coo_to_hell(coo)
    assert sz == hell.total_slots


def _has_dups(coo):
    key = coo.rows * coo.n_cols + coo.cols
    return np.unique(key).size != key.size


def test_hdia_hack_offsets_parity():
    """computeHdiaHackOffsets[FromCoo] / cooToHdiaSize / computeBcooSize
    parity helpers (SURVEY §2.3)."""
    from spgpu_tpu.convert import (
        compute_bcoo_size,
        compute_hdia_hack_offsets,
        compute_hdia_hack_offsets_from_coo,
        coo_to_dia,
        coo_to_hdia_size,
    )
    from spgpu_tpu.utils.fixtures import random_banded

    coo = random_banded(700, bands=7, wander=5, seed=3).sum_duplicates()
    off_coo = compute_hdia_hack_offsets_from_coo(coo)
    assert off_coo.shape == (-(-700 // HS) + 1,)
    assert (np.diff(off_coo) >= 0).all()
    # from-DIA scan agrees with the from-COO bucketing
    off_dia = compute_hdia_hack_offsets(coo_to_dia(coo))
    np.testing.assert_array_equal(off_coo, off_dia)
    assert coo_to_hdia_size(coo) == off_coo[-1] * HS
    # block count matches a dense blocking
    nb = compute_bcoo_size(coo, 4, 4)
    dense = coo.to_dense()
    blocks = dense.reshape(175, 4, 175, 4).transpose(0, 2, 1, 3)
    assert nb == int((blocks != 0).any(axis=(2, 3)).sum())


def test_hdia_hack_offsets_rectangular():
    """Tall/wide matrices: diagonal offsets go negative past n_cols (tall)
    or exceed n_rows (wide); the key packing must stay collision-free —
    the reference handles this with per-hack map buckets (hdia.cpp:161-228).
    Regression for a ValueError('negative elements') on tall inputs."""
    from spgpu_tpu.convert import (
        compute_hdia_hack_offsets_from_coo,
        coo_to_hdia_size,
    )

    rng = np.random.default_rng(0)
    for n_rows, n_cols in [(300, 10), (10, 300), (513, 4), (4, 513)]:
        m = 200
        rows = rng.integers(0, n_rows, m)
        cols = rng.integers(0, n_cols, m)
        coo = CooMatrix.from_arrays(rows, cols, np.ones(m), n_rows, n_cols
                                    ).sum_duplicates()
        off = compute_hdia_hack_offsets_from_coo(coo)
        # brute-force distinct (hack, diagonal) count per hack
        h = coo.rows // HS
        d = coo.cols.astype(np.int64) - coo.rows
        expect = np.zeros(off.size - 1, dtype=np.int64)
        for hk in range(off.size - 1):
            expect[hk] = np.unique(d[h == hk]).size
        np.testing.assert_array_equal(np.diff(off), expect)
        assert coo_to_hdia_size(coo) == off[-1] * HS


def test_estimate_formats_rectangular_whdia_count():
    """suggest_format's HDIA slab estimate must count (hack, diagonal)
    pairs exactly on wide matrices (key-collision regression)."""
    from spgpu_tpu.convert.select import estimate_formats

    rng = np.random.default_rng(1)
    n_rows, n_cols = 40, 5000
    m = 600
    coo = CooMatrix.from_arrays(
        rng.integers(0, n_rows, m), rng.integers(0, n_cols, m),
        np.ones(m), n_rows, n_cols,
    ).sum_duplicates()
    hs = HS
    est = estimate_formats(coo)
    h = coo.rows // hs
    d = coo.cols.astype(np.int64) - coo.rows
    true_pairs = len({(int(a), int(b)) for a, b in zip(h, d)})
    assert est["hdia"].bytes_per_product == true_pairs * (hs * 8 + 8)


def test_scipy_interop():
    import scipy.sparse as sp

    from spgpu_tpu.formats.coo import CooMatrix

    rng = np.random.default_rng(0)
    m = sp.random(50, 70, density=0.1, random_state=1, format="csr")
    coo = CooMatrix.from_scipy(m)
    np.testing.assert_allclose(coo.to_dense(), m.toarray())
    back = coo.to_scipy()
    np.testing.assert_allclose(back.toarray(), m.toarray())
    # golden spmv agrees with scipy
    x = rng.standard_normal(70)
    np.testing.assert_allclose(coo.spmv(x), m @ x)
