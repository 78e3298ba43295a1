"""Distributed layer: mesh row-partitioning, halo exchange, sharded SpMV.

The reference has **no** multi-GPU or multi-node support (SURVEY §2.6
absence list) — halo exchange for distributed SpMV was delegated to the
caller (PSBLAS + MPI) using the device-side ``gath``/``scat`` pack/unpack
primitives.  This package is the first-class replacement:
``jax.sharding.Mesh`` + ``shard_map``, halo plans built at conversion
time, x exchanged by collectives, reductions via ``psum``.
"""

from spgpu_tpu.parallel.partition import (
    PartitionedMatrix,
    make_row_mesh,
    partition_coo_rows,
)
from spgpu_tpu.parallel.dist_spmv import ShardedHandle, dist_spmv, make_dist_matvec
from spgpu_tpu.parallel.dist_solve import DistSolveHandle, dist_bicgstab, dist_cg

__all__ = [
    "PartitionedMatrix",
    "make_row_mesh",
    "partition_coo_rows",
    "ShardedHandle",
    "dist_spmv",
    "make_dist_matvec",
    "dist_cg",
    "dist_bicgstab",
    "DistSolveHandle",
]
