from spgpu_tpu.utils.fixtures import (
    ctest_fixture,
    laplacian_2d,
    laplacian_3d,
    random_banded,
    random_fem_like,
    random_irregular,
)
from spgpu_tpu.utils.timing import BenchResult, Clock, benchmark_op

__all__ = [
    "ctest_fixture",
    "laplacian_2d",
    "laplacian_3d",
    "random_banded",
    "random_fem_like",
    "random_irregular",
    "BenchResult",
    "Clock",
    "benchmark_op",
]

from spgpu_tpu.utils.profiling import roofline_report, trace  # noqa: F401,E402
