"""Bench harness smoke test (small CPU sizes): the measurement machinery
itself must stay runnable in CI — the reference's perf harnesses were
only compiled, never exercised, and rotted (`cusparsePerf` disabled in
the build, `CMakeLists.txt:182-183`)."""

import json


def test_run_suite_small():
    from spgpu_tpu.bench import run_suite

    lines = []
    results = run_suite("small", out=lines.append)
    assert len(results) >= 8
    kinds = set()
    for line in lines:
        d = json.loads(line)
        kinds.add(d.get("config"))
        if "gflops" in d:
            assert d["gflops"] > 0
        if "eff_bandwidth_gbs" in d:
            assert d["eff_bandwidth_gbs"] > 0
    # SpMV rows + BLAS-1 rows + conversion/vendor anchors all present
    assert {"fem_irregular", "banded", "blas1", "conversion",
            "vendor"} <= kinds
    # every device measurement names its device
    assert all("device" in json.loads(l) for l in lines
               if json.loads(l).get("config") not in ("conversion",
                                                      "vendor"))


def test_traffic_models_match_storage():
    """``storage_bytes`` — the matrix term of every bandwidth figure —
    counts exactly the bytes of the format's device arrays."""
    import jax
    import numpy as np

    from spgpu_tpu import convert
    from spgpu_tpu.utils.fixtures import random_banded

    band = random_banded(3000, bands=11, wander=7, seed=2,
                         dtype=np.float32).sum_duplicates()
    for fmt in ("ell", "hell", "dia", "hdia", "sdia"):
        a = getattr(convert, f"coo_to_{fmt}")(band)
        leaves = sum(int(l.size) * l.dtype.itemsize
                     for l in jax.tree.leaves(a))
        assert a.storage_bytes == leaves, fmt


def test_roofline_report_shape():
    from spgpu_tpu.utils.profiling import roofline_report

    rep = roofline_report("x", 1e-3, 1_000_000, 2_000_000)
    assert rep["gflops"] > 0
    assert rep["achieved_gbs"] > 0
    assert rep["roofline_frac"] is None
    rep = roofline_report("x", 1e-3, 1_000_000, 2_000_000,
                          peak_bytes_per_s=2e9)
    assert rep["roofline_frac"] == 0.5
