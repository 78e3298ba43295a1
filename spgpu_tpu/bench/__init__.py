"""Benchmark harnesses — the hellPerf/diaPerf equivalents.

Replicates the reference's measurement protocol (SURVEY §3.5;
``/root/reference/src/tests/hellPerf.cpp:209-252``, ``diaPerf.cpp``):
warm-up SpMV → ``dot(z, z)`` checksum → timed loop →
``GFLOPS = (2·nnz − 1)/t_avg`` + per-format storage report.  The timed
loop is one jitted chained ``fori_loop`` ended by ``block_until_ready``
(:func:`spgpu_tpu.utils.timing.chained_time`).

Output is structured JSON (one record per format/config) instead of the
reference's printf, so results land in BASELINE tracking directly.
"""

from spgpu_tpu.bench.harness import BenchResult, run_config, run_suite

__all__ = ["BenchResult", "run_config", "run_suite"]
