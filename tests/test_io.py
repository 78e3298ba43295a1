"""Matrix Market I/O: banner parsing, field/symmetry handling, symmetric
unfolding with explicit-zero dropping (mmutils.hpp parity), round-trip."""

import io

import numpy as np

import pytest

from spgpu_tpu.io import read_mm, read_mm_properties, write_mm

_BENCH = str(__import__("pathlib").Path(__file__).resolve().parents[1]
             / "bench.py")
from spgpu_tpu.formats import CooMatrix
from spgpu_tpu.utils import laplacian_2d

GENERAL = """%%MatrixMarket matrix coordinate real general
% comment line
3 4 5
1 1 1.5
2 2 -2.0
3 1 3.0
3 4 4.25
1 3 0.5
"""

SYMMETRIC = """%%MatrixMarket matrix coordinate real symmetric
3 3 4
1 1 2.0
2 1 -1.0
3 2 0.0
3 3 5.0
"""

PATTERN = """%%MatrixMarket matrix coordinate pattern general
2 2 2
1 1
2 2
"""

COMPLEX_H = """%%MatrixMarket matrix coordinate complex hermitian
2 2 2
1 1 1.0 0.0
2 1 2.0 3.0
"""

ARRAY = """%%MatrixMarket matrix array real general
2 2
1.0
2.0
3.0
4.0
"""


def test_properties():
    p = read_mm_properties(io.StringIO(GENERAL))
    assert (p.format, p.field, p.symmetry) == ("coordinate", "real", "general")
    assert (p.n_rows, p.n_cols, p.nnz) == (3, 4, 5)


def test_general():
    a = read_mm(io.StringIO(GENERAL))
    d = a.to_dense()
    assert d[0, 0] == 1.5 and d[2, 3] == 4.25 and d[0, 2] == 0.5
    assert a.nnz == 5


def test_symmetric_unfold_drops_zeros():
    a = read_mm(io.StringIO(SYMMETRIC))
    d = a.to_dense()
    # off-diagonal mirrored, explicit zero (3,2) dropped before unfold
    assert d[0, 1] == -1.0 and d[1, 0] == -1.0
    assert d[2, 1] == 0.0 and d[1, 2] == 0.0
    assert a.nnz == 4  # 3 kept + 1 mirror


def test_symmetric_no_unfold():
    a = read_mm(io.StringIO(SYMMETRIC), unfold_symmetric=False)
    assert a.to_dense()[0, 1] == 0.0


def test_pattern():
    a = read_mm(io.StringIO(PATTERN))
    np.testing.assert_allclose(a.to_dense(), np.eye(2))


def test_complex_hermitian():
    a = read_mm(io.StringIO(COMPLEX_H))
    d = a.to_dense()
    assert d[1, 0] == 2.0 + 3.0j and d[0, 1] == 2.0 - 3.0j


def test_array_format():
    a = read_mm(io.StringIO(ARRAY))
    np.testing.assert_allclose(a.to_dense(), [[1.0, 3.0], [2.0, 4.0]])


def test_roundtrip(tmp_path):
    coo = laplacian_2d(5, 4)
    path = tmp_path / "lap.mtx"
    write_mm(path, coo)
    back = read_mm(path)
    np.testing.assert_allclose(back.to_dense(), coo.to_dense())
    p = read_mm_properties(path)
    assert p.nnz == coo.nnz


def test_bench_mtx_pipeline(tmp_path):
    """bench.py --mtx pipeline pieces: write -> read -> auto-layout ->
    SpMV row (the hellPerf protocol end-to-end on a file)."""
    import subprocess
    import sys

    import numpy as np

    from spgpu_tpu.formats.coo import CooMatrix
    from spgpu_tpu.io.mm import write_mm
    from spgpu_tpu.utils.fixtures import random_banded

    n = 600
    base = random_banded(n, bands=5, wander=0, seed=1,
                         dtype=np.float32).sum_duplicates()
    d = np.zeros(n); np.add.at(d, base.rows, np.abs(base.values))
    rows = np.concatenate([base.rows, base.cols, np.arange(n)])
    cols = np.concatenate([base.cols, base.rows, np.arange(n)])
    vals = np.concatenate([base.values * .05, base.values * .05,
                           d + 1.0]).astype(np.float32)
    spd = CooMatrix(rows, cols, vals, n, n).sum_duplicates()
    keep = spd.rows >= spd.cols
    tri = CooMatrix(spd.rows[keep], spd.cols[keep], spd.values[keep], n, n)
    path = tmp_path / "t.mtx"
    write_mm(str(path), tri)
    txt = path.read_text().split("\n")
    txt[0] = txt[0].replace("general", "symmetric")
    path.write_text("\n".join(txt))

    env = dict(JAX_PLATFORMS="cpu", PATH="/usr/bin:/bin",
               HOME=str(tmp_path))
    out = subprocess.run(
        [sys.executable, _BENCH, "--mtx", str(path),
         "--iters", "2", "--cg", "1e-4"],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    import json as _json

    stages = [_json.loads(l) for l in out.stdout.strip().splitlines()
              if l.startswith("{")]
    names = [s["stage"] for s in stages]
    assert names[:3] == ["load", "convert", "spmv"]
    assert stages[0]["symmetry"] == "symmetric"
    assert stages[0]["nnz"] == spd.nnz  # unfolded
    assert stages[3]["stage"] == "solve"
    assert stages[3]["true_resid"] < 1e-3


def test_bench_mtx_complex(tmp_path):
    """bench.py --mtx on a COMPLEX Matrix Market file: complex x,
    complex flops accounting, complex solve residual."""
    import subprocess
    import sys

    import numpy as np

    from spgpu_tpu.formats.coo import CooMatrix
    from spgpu_tpu.io.mm import write_mm
    from spgpu_tpu.utils.fixtures import random_banded

    n = 500
    rng = np.random.default_rng(2)
    base = random_banded(n, bands=5, wander=0, seed=1,
                         dtype=np.float64).sum_duplicates()
    off = (base.values * 0.05
           + 0.05j * rng.standard_normal(base.nnz)).astype(np.complex64)
    rows = np.concatenate([base.rows, base.cols, np.arange(n)])
    cols = np.concatenate([base.cols, base.rows, np.arange(n)])
    vals = np.concatenate([off, np.conj(off),
                           np.full(n, 4.0 + 0j, np.complex64)])
    A = CooMatrix(rows, cols, vals, n, n).sum_duplicates()
    keep = A.rows >= A.cols
    tri = CooMatrix(A.rows[keep], A.cols[keep], A.values[keep], n, n)
    path = tmp_path / "c.mtx"
    write_mm(str(path), tri)
    txt = path.read_text().split("\n")
    txt[0] = txt[0].replace("general", "hermitian")
    path.write_text("\n".join(txt))

    env = dict(JAX_PLATFORMS="cpu", PATH="/usr/bin:/bin",
               HOME=str(tmp_path))
    out = subprocess.run(
        [sys.executable, _BENCH, "--mtx", str(path),
         "--iters", "2", "--cg", "1e-5"],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    import json as _json

    stages = [_json.loads(l) for l in out.stdout.strip().splitlines()
              if l.startswith("{")]
    assert stages[0]["field"] == "complex"
    assert stages[0]["nnz"] == A.nnz
    assert stages[2]["stage"] == "spmv" and stages[2]["gflops"] > 0
    assert stages[3]["true_resid"] < 1e-3


def test_fast_parse_matches_strtod():
    """r5 parallel tokenizer: the long-double Clinger fast path must
    reproduce strtod bit-exactly on %.17g round-trips across scales
    (values outside the 19-digit/|e|<=27 window take the strtod
    fallback inside mm_parse)."""
    from spgpu_tpu import native

    if not native.available():
        pytest.skip("native helper unavailable")
    rng = np.random.default_rng(3)
    v = np.concatenate([
        rng.standard_normal(20000),
        rng.standard_normal(20000) * 10.0 ** rng.integers(-30, 30, 20000),
        rng.standard_normal(5000) * 1e-300,
        np.array([0.0, -0.0, 1e308, 1e-308, 1e27, 1e-27, 2.0 ** -1074]),
    ])
    body = "\n".join(f"1 1 {x:.17g}" for x in v) + "\n"
    parsed = native.mm_parse(body.encode(), 3, v.size)
    assert parsed is not None
    np.testing.assert_array_equal(parsed[2], v)


def test_misaligned_body_rejected(tmp_path):
    """ADVICE r4: a structurally misaligned body (line with the wrong
    token count) must error loudly, never silently reshape."""
    p = tmp_path / "bad.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate real general\n"
        "3 3 3\n"
        "1 1 2.0\n"
        "2 2 3.0 3 3 4.0\n")  # two entries merged on one line
    with pytest.raises(ValueError):
        read_mm(str(p))
