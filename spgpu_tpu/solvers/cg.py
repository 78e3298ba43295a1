"""Iterative solvers: CG / BiCGSTAB (device-resident).

The reference library was built as the GPU backend for PSBLAS-style
iterative solvers (SURVEY intro; Fortran ``baseIndex`` support everywhere)
but ships no solver itself — the solver loop lived host-side in PSBLAS,
with every dot product forcing a device→host copy
(``sdot.cu:154-159``, SURVEY §3.2 implication note).

Here the whole Krylov iteration is a ``lax.while_loop`` under jit: matrix,
vectors, and reduction scalars stay on device; nothing crosses to the host
until the caller reads the result.  This is the validation workload of
BASELINE.json ("multi-host row-partitioned CG") — the distributed version
wraps these same functions around a sharded SpMV (``spgpu_tpu.parallel``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from spgpu_tpu.ops import blas1

__all__ = ["CgResult", "cg", "bicgstab", "jacobi_preconditioner"]


class CgResult(NamedTuple):
    x: jax.Array
    iterations: jax.Array  # int32 scalar
    residual_norm: jax.Array  # float scalar
    converged: jax.Array  # bool scalar


def jacobi_preconditioner(coo) -> jnp.ndarray:
    """1/diag(A) from a host COO (duplicates summed, zero diag → 1)."""
    import numpy as np

    d = np.zeros(coo.n_rows, dtype=coo.values.dtype)
    on_diag = coo.rows == coo.cols
    np.add.at(d, coo.rows[on_diag], coo.values[on_diag])
    d = np.where(d == 0, 1.0, d)
    return jnp.asarray(1.0 / d)


def cg(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    tol: float = 1e-10,
    maxiter: int = 1000,
    m_inv: Optional[jax.Array] = None,
    axis_name: Optional[str] = None,
) -> CgResult:
    """Preconditioned conjugate gradient for SPD (or hermitian positive
    definite) ``A``, in the dtype of ``b``.

    ``matvec`` maps x → A@x (any of the format SpMVs, or a shard_map'd
    distributed SpMV).  ``m_inv`` is an optional diagonal (Jacobi)
    preconditioner vector.  ``axis_name``: when running inside
    ``shard_map`` over a row-partitioned system, reductions are summed
    across that mesh axis so every shard agrees on α/β/convergence.
    """

    def psum(v):
        return jax.lax.psum(v, axis_name) if axis_name else v

    def dotp(u, v):
        return psum(blas1.dot(u, v, conjugate=jnp.iscomplexobj(u)))

    if x0 is None:
        x0 = jnp.zeros_like(b)
    r0 = b - matvec(x0)
    z0 = r0 * m_inv if m_inv is not None else r0
    rz0 = dotp(r0, z0)
    bnorm = jnp.sqrt(jnp.real(dotp(b, b)))
    bnorm = jnp.where(bnorm == 0, 1.0, bnorm)

    def cond(state):
        x, r, z, p, rz, k = state
        rnorm = jnp.sqrt(jnp.real(dotp(r, r)))
        return (rnorm > tol * bnorm) & (k < maxiter)

    def body(state):
        x, r, z, p, rz, k = state
        ap = matvec(p)
        alpha = rz / dotp(p, ap)
        x = blas1.axpby(alpha, p, 1.0, x)
        r = blas1.axpby(-alpha, ap, 1.0, r)
        z = r * m_inv if m_inv is not None else r
        rz_new = dotp(r, z)
        beta = rz_new / rz
        p = blas1.axpby(1.0, z, beta, p)
        return (x, r, z, p, rz_new, k + 1)

    x, r, z, p, rz, k = jax.lax.while_loop(cond, body, (x0, r0, z0, r0 * 0 + z0, rz0, jnp.int32(0)))
    rnorm = jnp.sqrt(jnp.real(dotp(r, r)))
    return CgResult(x, k, rnorm, rnorm <= tol * bnorm)


def bicgstab(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    tol: float = 1e-10,
    maxiter: int = 1000,
    m_inv: Optional[jax.Array] = None,
    axis_name: Optional[str] = None,
) -> CgResult:
    """BiCGSTAB for general (non-symmetric, real or complex) systems —
    covers the non-SPD SuiteSparse matrices of the HELL config.  Inner
    products are sesquilinear for complex ``b`` (``conj(u)·v``)."""

    def psum(v):
        return jax.lax.psum(v, axis_name) if axis_name else v

    def dotp(u, v):
        return psum(blas1.dot(u, v, conjugate=jnp.iscomplexobj(u)))

    if x0 is None:
        x0 = jnp.zeros_like(b)
    r0 = b - matvec(x0)
    rhat = r0
    bnorm = jnp.sqrt(jnp.real(dotp(b, b)))
    bnorm = jnp.where(bnorm == 0, 1.0, bnorm)

    def prec(v):
        return v * m_inv if m_inv is not None else v

    def cond(s):
        x, r, p, v, rho, alpha, omega, k, down = s
        rnorm = jnp.sqrt(jnp.real(dotp(r, r)))
        return (rnorm > tol * bnorm) & (k < maxiter) & ~down

    def body(s):
        x, r, p, v, rho, alpha, omega, k, down = s
        rho_new = dotp(rhat, r)
        # breakdown guards: rho/omega/(rhat·v)/tt ≈ 0 would divide to
        # NaN and silently loop to maxiter; freeze the iterate instead.
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = prec(p)
        v = matvec(phat)
        rv = dotp(rhat, v)
        alpha = rho_new / rv
        s_vec = r - alpha * v
        shat = prec(s_vec)
        t = matvec(shat)
        tt = dotp(t, t)
        omega_new = jnp.where(tt == 0, 0.0, dotp(t, s_vec) / jnp.where(tt == 0, 1.0, tt))
        x_new = x + alpha * phat + omega_new * shat
        r_new = s_vec - omega_new * t
        tiny = jnp.asarray(jnp.finfo(jnp.real(b).dtype).tiny, jnp.real(b).dtype)
        down = (
            (jnp.abs(rho_new) < tiny)
            | (jnp.abs(rv) < tiny)
            | (jnp.abs(omega_new) < tiny)
            | ~jnp.isfinite(jnp.real(dotp(r_new, r_new)))
        )
        keep = lambda new, old: jnp.where(down, old, new)
        return (
            keep(x_new, x), keep(r_new, r), p, v, rho_new, alpha,
            jnp.where(down, omega, omega_new), k + 1, down,
        )

    one = jnp.ones((), b.dtype)
    init = (x0, r0, jnp.zeros_like(b), jnp.zeros_like(b), one, one, one,
            jnp.int32(0), jnp.bool_(False))
    x, r, p, v, rho, alpha, omega, k, down = jax.lax.while_loop(cond, body, init)
    rnorm = jnp.sqrt(jnp.real(dotp(r, r)))
    return CgResult(x, k, rnorm, rnorm <= tol * bnorm)
