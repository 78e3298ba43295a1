"""Sharded SpMV: halo exchange overlapped with interior compute.

Replacement for the distributed SpMV the reference delegated to its
PSBLAS/MPI callers (SURVEY §2.6): ``shard_map`` over a 1-D ``Mesh``, one
``all_to_all`` per SpMV for the halo entries of ``x``, and the interior
product computed from purely local data so XLA can overlap it with the
collective (the interior slab has no data dependency on the received halo
— the scheduling analogue of the interior/boundary row split sketched in
SURVEY §7).

The device-side pack primitive ``x_local[send_idx]`` is this layer's
``gath`` (``gath_base.cuh:32-85``); the unpack is implicit in the
exterior slab's column indices, which point straight into the received
``(P·K,)`` halo buffer — no scatter needed.
"""

from __future__ import annotations

from functools import partial

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spgpu_tpu.ops.spmv_xla import hell_spmv_xla
from spgpu_tpu.parallel.partition import PartitionedMatrix, pad_vector

__all__ = ["dist_spmv", "make_dist_matvec", "shard_partitioned",
           "local_matvec", "ShardedHandle"]


def _leaf_spec(pm: PartitionedMatrix, axis: str):
    """PartitionSpec pytree: every array leaf sharded on its shard axis."""
    return jax.tree.map(lambda _: P(axis), pm)


def shard_partitioned(pm: PartitionedMatrix, mesh: Mesh, axis: str = "rows"):
    """Place every leaf of ``pm`` with its shard axis on the mesh axis."""
    return jax.tree.map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P(axis))), pm
    )


def local_matvec(pm: PartitionedMatrix, axis: str, lpm, x_local):
    """Shard-local SpMV body (runs inside ``shard_map``).

    ``lpm`` is the shard's block of the partitioned pytree (leading shard
    axis of size 1); ``x_local`` is the shard's ``(1, chunk)`` block of
    x.  Returns the local block of ``A @ x``.
    """
    xl = x_local[0]
    # halo exchange: pack (gath), all-to-all, flat receive buffer
    send_buf = xl[lpm.send_idx[0]]  # (P, K)
    halo = jax.lax.all_to_all(send_buf, axis, 0, 0).reshape(-1)  # (P*K,)
    # interior SpMV — independent of the collective; XLA overlaps them
    a_int = pm.local_interior(
        lpm.int_values[0], lpm.int_cols[0],
        lpm.int_hack_offsets[0], lpm.int_slot_to_hack[0],
    )
    z = hell_spmv_xla(a_int, xl)
    # exterior SpMV over the received halo
    a_ext = pm.local_exterior(
        lpm.ext_values[0], lpm.ext_cols[0],
        lpm.ext_hack_offsets[0], lpm.ext_slot_to_hack[0],
    )
    z = z + hell_spmv_xla(a_ext, halo)
    return z[None]


def _matvec_program(pm: PartitionedMatrix, mesh: Mesh, axis: str):
    return jax.jit(jax.shard_map(
        partial(local_matvec, pm, axis), mesh=mesh,
        in_specs=(_leaf_spec(pm, axis), P(axis)), out_specs=P(axis)))


def dist_spmv(
    pm: PartitionedMatrix,
    x: jax.Array,
    mesh: Mesh,
    axis: str = "rows",
) -> jax.Array:
    """Distributed ``A @ x`` for a row-partitioned square matrix.

    ``x`` is a global ``(n,)`` vector (replicated or sharded); the result
    is the global ``(n,)`` product, sharded over ``axis``.  One-shot: for
    a loop of products use :class:`ShardedHandle`, which places the
    matrix and compiles the program once.
    """
    h = ShardedHandle(pm, mesh, axis)
    return h.extract(h.matvec(h.embed(x)))


def make_dist_matvec(pm: PartitionedMatrix, axis: str = "rows"):
    """Return the shard-local matvec closure ``(lpm, x_local) -> z_local``
    for embedding in a larger ``shard_map`` program (e.g. the CG loop in
    :mod:`spgpu_tpu.parallel.dist_solve`)."""
    return partial(local_matvec, pm, axis)


class ShardedHandle:
    """Persistent sharded-matrix handle for a run loop.

    Places the pytree on the mesh ONCE and compiles the matvec ONCE;
    thereafter ``matvec`` maps a device-resident ``(n_shards, chunk)``
    state to the product state with no host round trips.

    >>> h = ShardedHandle(pm, mesh)
    >>> x_st = h.embed(x_host)          # once per vector
    >>> for _ in range(steps):
    ...     x_st = h.matvec(x_st)       # device-resident loop
    >>> z = h.extract(x_st)
    """

    def __init__(self, pm: PartitionedMatrix, mesh: Mesh, axis: str = "rows"):
        self.pm, self.mesh, self.axis = pm, mesh, axis
        self.sharding = NamedSharding(mesh, P(axis))
        self.pm_s = shard_partitioned(pm, mesh, axis)
        self._f = _matvec_program(pm, mesh, axis)

    def embed(self, x) -> jax.Array:
        """Global ``(n,)`` vector → device ``(n_shards, chunk)`` state."""
        pm = self.pm
        xp = pad_vector(x, pm.padded_rows).reshape(pm.n_shards, pm.chunk)
        return jax.device_put(xp, self.sharding)

    def extract(self, z_st) -> jax.Array:
        """Device ``(n_shards, chunk)`` state → global ``(n,)`` vector."""
        return z_st.reshape(-1)[: self.pm.n_rows]

    def matvec(self, x_st: jax.Array) -> jax.Array:
        """``A @ x`` on the sharded state (compiled once, reused)."""
        return self._f(self.pm_s, x_st)
