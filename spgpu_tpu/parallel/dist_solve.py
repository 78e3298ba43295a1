"""Distributed Krylov solves over a row-partitioned matrix.

The BASELINE.json validation workload: a multi-device CG whose SpMV does
a halo all-to-all per iteration (overlapped with interior compute, see
:mod:`spgpu_tpu.parallel.dist_spmv`) and whose dot products are global
``psum`` reductions over the mesh axis.  The whole iteration — matvec,
collectives, convergence test — runs inside one ``shard_map`` under one
``jit``: nothing crosses to the host until the caller reads the result
(unlike the reference, where every dot forced a device→host copy,
``sdot.cu:154-159``).  Real and complex dtypes run the same solvers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spgpu_tpu.parallel.dist_spmv import _leaf_spec, local_matvec, shard_partitioned
from spgpu_tpu.parallel.partition import PartitionedMatrix, pad_vector
from spgpu_tpu.solvers.cg import CgResult, bicgstab, cg

__all__ = ["dist_cg", "dist_bicgstab", "DistSolveHandle"]


class DistSolveHandle:
    """Compile-once distributed solver handle for a run loop.

    Matches the reference's handle-reuse contract
    (``/root/reference/src/core/core.h:60-82`` — one handle, many calls):
    the pytree is placed on the mesh ONCE, and each
    ``(symmetric, tol, maxiter)`` program is traced and compiled ONCE —
    subsequent solves with a new ``b`` reuse the executable
    (``trace_counts`` exposes the per-program trace count so tests can
    assert it stays 1).

    >>> h = DistSolveHandle(pm, mesh)
    >>> r1 = h.solve(b1)            # traces + compiles
    >>> r2 = h.solve(b2)            # reuses the executable
    """

    def __init__(self, pm: PartitionedMatrix, mesh: Mesh, axis: str = "rows"):
        self.pm, self.mesh, self.axis = pm, mesh, axis
        self.sharding = NamedSharding(mesh, P(axis))
        self.pm_s = shard_partitioned(pm, mesh, axis)
        self._progs = {}
        self.trace_counts = {}

    def _put(self, v):
        pm = self.pm
        v = pad_vector(jnp.asarray(v, pm.dtype), pm.padded_rows)
        return jax.device_put(v.reshape(pm.n_shards, pm.chunk), self.sharding)

    def _program(self, symmetric: bool, tol: float, maxiter: int):
        key = (bool(symmetric), float(tol), int(maxiter))
        if key in self._progs:
            return self._progs[key]
        pm, axis = self.pm, self.axis
        solver = cg if symmetric else bicgstab
        self.trace_counts[key] = 0

        def shard_body(lpm, b_l, x0_l, m_l):
            self.trace_counts[key] += 1
            mv = lambda v: local_matvec(pm, axis, lpm, v[None])[0]
            res = solver(mv, b_l[0], x0=x0_l[0], tol=tol, maxiter=maxiter,
                         m_inv=m_l[0], axis_name=axis)
            return res._replace(x=res.x[None])

        in_specs = (_leaf_spec(pm, axis), P(axis), P(axis), P(axis))
        out_specs = CgResult(
            x=P(axis), iterations=P(), residual_norm=P(), converged=P())
        f = jax.jit(jax.shard_map(shard_body, mesh=self.mesh,
                                  in_specs=in_specs, out_specs=out_specs))
        self._progs[key] = f
        return f

    def solve(self, b, symmetric: bool = True, tol: float = 1e-10,
              maxiter: int = 1000, x0=None, m_inv=None) -> CgResult:
        """Solve ``A x = b`` (CG if ``symmetric`` else BiCGSTAB);
        ``b``/``x0``/``m_inv`` are global ``(n,)`` vectors, the result
        ``x`` likewise.  ``m_inv`` is a Jacobi diagonal (identity when
        omitted)."""
        bp = self._put(b)
        x0p = jnp.zeros_like(bp) if x0 is None else self._put(x0)
        # identity preconditioner when none given: elementwise ones, same math
        mp = jnp.ones_like(bp) if m_inv is None else self._put(m_inv)
        res = self._program(symmetric, tol, maxiter)(self.pm_s, bp, x0p, mp)
        return res._replace(x=res.x.reshape(-1)[: self.pm.n_rows])


def dist_cg(pm: PartitionedMatrix, b, mesh: Mesh, axis: str = "rows", **kw):
    """Distributed preconditioned CG (SPD / hermitian-PD systems)."""
    return DistSolveHandle(pm, mesh, axis).solve(b, symmetric=True, **kw)


def dist_bicgstab(pm: PartitionedMatrix, b, mesh: Mesh, axis: str = "rows",
                  **kw):
    """Distributed BiCGSTAB (general systems)."""
    return DistSolveHandle(pm, mesh, axis).solve(b, symmetric=False, **kw)
