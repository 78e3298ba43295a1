"""Profiling helpers.

The reference's observability is a wall-clock ``Clock`` around kernel
loops plus compile-time ``--ptxas-options=-v`` register reports
(SURVEY §5; ``/root/reference/src/utils/timing.hpp:22-70``,
``CMakeLists.txt:168-169``).  Here the equivalents are:

* :func:`spgpu_tpu.utils.timing.chained_time` — device time per product
  (chained ``fori_loop`` ended by ``block_until_ready``);
* :func:`roofline_report` — achieved rates, and the share of a peak
  bandwidth when the caller supplies one;
* :func:`trace` — ``jax.profiler.trace``, which records the device.
"""

from __future__ import annotations

import contextlib
from typing import Optional

__all__ = ["roofline_report", "trace"]


def roofline_report(name: str, t_seconds: float, bytes_moved: int,
                    flops: int, peak_bytes_per_s: Optional[float] = None
                    ) -> dict:
    """Achieved bandwidth/FLOP rate, and the share of ``peak_bytes_per_s``
    when one is given."""
    achieved_bw = bytes_moved / t_seconds
    return {
        "name": name,
        "t_s": t_seconds,
        "gflops": flops / t_seconds / 1e9,
        "achieved_gbs": achieved_bw / 1e9,
        "roofline_frac": (achieved_bw / peak_bytes_per_s
                          if peak_bytes_per_s else None),
    }


@contextlib.contextmanager
def trace(log_dir: str):
    """``jax.profiler.trace`` into ``log_dir``."""
    import jax

    with jax.profiler.trace(log_dir):
        yield
