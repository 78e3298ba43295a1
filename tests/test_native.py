"""Native C++ Matrix Market tokenizer: the ctypes module must agree with
the pure-NumPy fallback of :func:`spgpu_tpu.io.read_mm` exactly."""

import importlib

import numpy as np
import pytest

from spgpu_tpu import native
from spgpu_tpu.io import read_mm, write_mm
from spgpu_tpu.utils.fixtures import random_fem_like


def test_available_and_fallback_equivalence(monkeypatch, tmp_path):
    if not native.available():
        pytest.skip("no g++ in this environment")
    real = random_fem_like(3000, 12.0, span=200, far_frac=0.02, seed=9)
    cplx = type(real)(real.rows, real.cols, real.values * (1 - 0.5j),
                      real.n_rows, real.n_cols)
    paths = []
    for name, coo in (("real", real), ("complex", cplx)):
        paths.append((tmp_path / f"{name}.mtx", coo))
        write_mm(str(paths[-1][0]), coo)
    parsed = [read_mm(str(p)) for p, _ in paths]
    # force the NumPy fallback and compare the parsed triples
    monkeypatch.setenv("SPGPU_TPU_NO_NATIVE", "1")
    importlib.reload(native)
    try:
        assert not native.available()
        fallback = [read_mm(str(p)) for p, _ in paths]
    finally:
        monkeypatch.delenv("SPGPU_TPU_NO_NATIVE")
        importlib.reload(native)
    for a, b, (_, coo) in zip(parsed, fallback, paths):
        for f in ("rows", "cols", "values"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(a.values, coo.values)
