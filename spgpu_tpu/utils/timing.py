"""Wall-clock timing + the reference's benchmark measurement protocol.

Mirrors ``Clock`` (``/root/reference/src/utils/timing.hpp:22-70``) and the
perf-harness protocol (SURVEY §3.5, ``hellPerf.cpp:209-252``):
warm-up run → checksum ``dot(z, z)`` → timed loop of N iterations →
GFLOPS = (2·nnz − 1) / t_avg.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import jax

__all__ = ["Clock", "benchmark_op", "BenchResult", "chained_time"]


def chained_time(step, carry0, *step_args, iters: int = 20, reps: int = 3):
    """Seconds per iteration of ``carry = step(carry, *step_args)``.

    The iterations run chained inside one jitted ``lax.fori_loop`` (each
    step consumes the previous output, so independent dispatches cannot
    overlap and hide each other), the timer stops at
    ``block_until_ready``, and the best of ``reps`` timed runs after a
    compiling warm-up is reported.  Large device operands the step reads
    go in ``step_args`` rather than a closure, so they stay arguments of
    the compiled program instead of constants baked into it.
    """

    @jax.jit
    def timed(c0, *args):
        return jax.lax.fori_loop(0, iters, lambda _, c: step(c, *args), c0)

    jax.block_until_ready(timed(carry0, *step_args))  # compile + warm-up
    t = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(timed(carry0, *step_args))
        t = min(t, time.perf_counter() - t0)
    return t / iters


class Clock:
    """Monotonic wall clock; parity with ``timing.hpp``'s ``Clock``."""

    def get_time(self) -> float:
        return time.perf_counter()


@dataclasses.dataclass
class BenchResult:
    seconds_per_iter: float
    iters: int
    gflops: Optional[float]
    checksum: float
    bytes_per_iter: Optional[int] = None

    @property
    def gbytes_per_sec(self) -> Optional[float]:
        if self.bytes_per_iter is None:
            return None
        return self.bytes_per_iter / self.seconds_per_iter / 1e9


def benchmark_op(
    fn: Callable,
    *args,
    iters: int = 1000,
    nnz: Optional[int] = None,
    bytes_per_iter: Optional[int] = None,
    checksum_fn: Optional[Callable] = None,
) -> BenchResult:
    """Run the reference measurement protocol on a jitted ``fn(*args)``.

    The reference times a stream of asynchronous kernel launches and syncs
    once at the end (``hellPerf.cpp:238-245`` + ``cudaDeviceSynchronize``);
    we dispatch ``iters`` calls and ``block_until_ready`` on the last
    result, which is the JAX equivalent.
    """
    out = fn(*args)  # warm-up / compile
    out = jax.block_until_ready(out)
    leaf = jax.tree_util.tree_leaves(out)[0]
    checksum = float((leaf * leaf).sum()) if checksum_fn is None else float(
        checksum_fn(out)
    )

    clock = Clock()
    t0 = clock.get_time()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    t = (clock.get_time() - t0) / iters

    gflops = None
    if nnz is not None:
        gflops = (2.0 * nnz - 1.0) / t * 1e-9
    return BenchResult(t, iters, gflops, checksum, bytes_per_iter)
