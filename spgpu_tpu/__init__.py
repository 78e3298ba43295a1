"""spgpu_tpu — sparse linear algebra in JAX.

A from-scratch re-design of the capabilities of spGPU
(davidebarbieri/spgpu, reference at ``/root/reference``): ELLpack plus the
signature HELL (Hacked ELLpack) and HDIA (Hacked DIA) sparse formats, SpMV
and multi-RHS SpMM, a full BLAS-1 vector suite, host-side COO conversions
and Matrix Market I/O, all as plain JAX programs that XLA compiles for the
device (an NVIDIA GPU in production, the CPU in tests):

* every format in float32/float64/complex64/complex128 (64-bit types need
  ``jax_enable_x64``);
* reductions stay device-resident (the reference round-trips every dot to
  the host, ``sdot.cu:154-159``);
* a distributed layer the reference never had (SURVEY §2.6): row-partition
  over a ``jax.sharding.Mesh``, halo plans exchanged by one
  ``all_to_all`` per product, and distributed CG/BiCGSTAB under one jit;
* native C++ for the Matrix Market tokenizer (``spgpu_tpu/native``).
"""

from spgpu_tpu.utils.hostmem import tune_malloc as _tune_malloc

_tune_malloc()  # page-fault cost dominates conversions on microVM hosts

from spgpu_tpu import convert, formats, io, ops, parallel, solvers, utils
from spgpu_tpu.core import Context, Status, TypeCode, create, destroy, size_of
from spgpu_tpu.formats import (
    BcooMatrix,
    BhdiaMatrix,
    CooMatrix,
    DiaMatrix,
    EllMatrix,
    HdiaMatrix,
    HellMatrix,
    SdiaMatrix,
)

__version__ = "0.1.0"
