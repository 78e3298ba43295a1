"""BLAS-1 / vector operation suite.

Re-design of the reference's vector kernels (SURVEY §2.5;
``/root/reference/src/core/kernels/{*dot,*nrm2,asum_base,amax_base,
scal_base,*axpby,axy_base,abs_base,gath_base,scat_base,setscal_base}``,
public API in ``src/core/vector.h``).  Design notes:

* Elementwise ops (scal/axpby/axy/axypbz/abs/setscal) are thin ``jnp``
  expressions: XLA fuses chains of them into single loops, which is
  what the reference's hand-chunked 1-thread-per-element kernels achieve
  manually.
* Reductions (dot/nrm2/asum/amax) return **device-resident 0-d arrays**.
  The reference copies per-block partials to the host and sums there
  (``sdot.cu:154-159``), forcing a device→host round-trip per reduction —
  here they stay on-device so e.g. a CG iteration never syncs.
* Multivector "m"-variants operate on ``(count, n)`` slabs in ONE fused
  kernel; the reference loops on the host issuing ``count`` kernels
  (``sdot.cu:167-175``, ``saxpby.cu:87-100``).
* ``asum``/``amax`` implement the *documented* semantics Σ|xᵢ| / max|xᵢ|.
  The reference kernels drop the contributions of lanes 2–31 of the final
  warp (discarded-return bug, ``asum_base.cuh:167-187``,
  ``amax_base.cuh:156-172``) — deliberately not replicated (SURVEY §7).
* Complex: ``dot`` is **non-conjugated** like the reference
  (``zdot.cu:47-97`` uses plain ``cuCfma``); pass ``conjugate=True`` for
  the sesquilinear inner product.  ``abs``/``asum``/``amax`` use the
  modulus (``cuCabs``, ``asum_base.cuh:39-40,66-67``) and return real.
* ``gath``/``scat`` skip negative indices after base subtraction
  (``gath_base.cuh:38-43``, ``scat_base.cuh:39-47``) — the device-side
  halo pack/unpack primitives of the PSBLAS MPI layer (SURVEY §2.6).
  ``scat`` with duplicate indices: the reference races by design
  (``vector.h:299-316``); XLA scatter picks one winner, matching the
  "undefined which" contract. ``mode="add"`` gives deterministic
  accumulation as an extension.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

__all__ = [
    "scal", "axpby", "axy", "axypbz", "abs_", "setscal",
    "dot", "nrm2", "asum", "amax",
    "gath", "scat",
    "mdot", "mnrm2", "masum", "mamax", "maxpby", "maxy", "maxypbz", "mscal",
]


def _is_static_zero(v) -> bool:
    return isinstance(v, (int, float, complex)) and v == 0


# ---------------------------------------------------------------------------
# Elementwise
# ---------------------------------------------------------------------------


def scal(alpha, x: jax.Array) -> jax.Array:
    """``y = alpha * x`` (``scal_base.cuh``)."""
    return alpha * x


def axpby(alpha, x: jax.Array, beta, y: jax.Array) -> jax.Array:
    """``z = beta*y + alpha*x`` with the in-kernel ``beta == 0`` branch of
    ``saxpby.cu:40-56`` (never reads y when beta is statically zero)."""
    if _is_static_zero(beta):
        return alpha * x
    return alpha * x + beta * y


def axy(alpha, x: jax.Array, y: jax.Array) -> jax.Array:
    """``z = alpha * x * y`` — Hadamard (``axy_base.cuh:37-108``)."""
    return alpha * x * y


def axypbz(alpha, x: jax.Array, y: jax.Array, beta, z: jax.Array) -> jax.Array:
    """``w = beta*z + alpha*x*y``; delegates like the reference dispatcher
    (alpha==0 → scal, beta==0 → axy; ``axy_base.cuh:143-186``)."""
    if _is_static_zero(alpha):
        return scal(beta, z)
    if _is_static_zero(beta):
        return axy(alpha, x, y)
    return alpha * x * y + beta * z


def abs_(x: jax.Array, alpha=1.0) -> jax.Array:
    """``y = alpha * |x|`` (``abs_base.cuh:44-57``); complex input yields
    the modulus as the corresponding real dtype (the reference stores it
    back into a complex array with zero imaginary part — use
    ``.astype(x.dtype)`` on the result for bit-parity with that layout)."""
    m = jnp.abs(x)
    if isinstance(alpha, (int, float)) and alpha == 1:
        return m
    return alpha * m


def setscal(y: jax.Array, val, first: int = 0, last: Optional[int] = None) -> jax.Array:
    """``y[first..last] = val`` (``setscal_base.cuh``; 0-based inclusive
    ``first``, exclusive ``last`` — the baseIndex shift of ``vector.h:1182``
    is handled at the COO boundary)."""
    if last is None:
        last = y.shape[-1]
    return y.at[..., first:last].set(val)


# ---------------------------------------------------------------------------
# Reductions (device-resident)
# ---------------------------------------------------------------------------


def dot(a: jax.Array, b: jax.Array, conjugate: bool = False) -> jax.Array:
    """``a · b``; non-conjugated for complex like the reference
    (``zdot.cu``).  ``conjugate=True`` → conj(a)·b."""
    if conjugate:
        a = jnp.conj(a)
    return jnp.sum(a * b, axis=-1)


def nrm2(x: jax.Array) -> jax.Array:
    """‖x‖₂; complex returns real (``snrm2.cu:120-166``)."""
    s = jnp.sum(jnp.real(x * jnp.conj(x)), axis=-1)
    return jnp.sqrt(s)


def asum(x: jax.Array) -> jax.Array:
    """Σ|xᵢ| with modulus for complex (correct semantics; see module note
    on the reference's discarded-return bug)."""
    return jnp.sum(jnp.abs(x), axis=-1)


def amax(x: jax.Array) -> jax.Array:
    """max|xᵢ| (correct semantics; see module note)."""
    return jnp.max(jnp.abs(x), axis=-1)


# ---------------------------------------------------------------------------
# Sparse gather / scatter
# ---------------------------------------------------------------------------


def gath(y: jax.Array, indices: jax.Array, out: Optional[jax.Array] = None,
         base_index: int = 0) -> jax.Array:
    """``values[i] = y[indices[i] − base]``, skipping negative positions
    (``gath_base.cuh:32-47``): where ``indices − base < 0`` the output
    keeps ``out``'s prior value (0 if ``out`` is None)."""
    pos = indices - base_index
    ok = pos >= 0
    safe = jnp.clip(pos, 0, y.shape[-1] - 1)
    gathered = y[..., safe]
    if out is None:
        out = jnp.zeros(gathered.shape, y.dtype)
    return jnp.where(ok, gathered, out)


def scat(y: jax.Array, indices: jax.Array, values: jax.Array, beta=0.0,
         base_index: int = 0, mode: str = "store") -> jax.Array:
    """``y[pos] = beta*y[pos] + values[i]`` at touched slots only
    (``scat_base.cuh:39-47``; β==0 → plain store, untouched slots keep y).

    ``mode="store"``: duplicate indices → one winner (the reference's
    documented race, ``vector.h:299-316``).  ``mode="add"``: duplicates
    accumulate after the single β scaling (deterministic extension).
    """
    pos = indices - base_index
    ok = pos >= 0
    n = y.shape[-1]
    # route skipped entries to a scratch slot past the end, then drop it.
    safe = jnp.where(ok, pos, n)
    if mode == "add":
        touched = jnp.zeros((n + 1,), bool).at[safe].max(ok)
        sums = (
            jnp.zeros(y.shape[:-1] + (n + 1,), y.dtype)
            .at[..., safe]
            .add(jnp.where(ok, values, 0).astype(y.dtype))
        )
        base = y if not _is_static_zero(beta) else jnp.zeros_like(y)
        scaled = base * beta if not _is_static_zero(beta) else base
        return jnp.where(touched[:n], scaled + sums[..., :n], y)
    y_ext = jnp.concatenate([y, jnp.zeros(y.shape[:-1] + (1,), y.dtype)], axis=-1)
    if _is_static_zero(beta):
        upd = values
    else:
        upd = beta * y_ext[..., safe] + values
    y_ext = y_ext.at[..., safe].set(upd.astype(y.dtype))
    return y_ext[..., :n]


# ---------------------------------------------------------------------------
# Multivector ("m") variants — single fused kernels over (count, n) slabs.
#
# Every scalar op above reduces/broadcasts over the last axis, so the
# m-variant is the same function applied to a 2-D multivector: one XLA
# kernel where the reference issues `count` launches from a host loop
# (sdot.cu:167-175, saxpby.cu:87-100, asum_base.cuh tail).  Kept as named
# entry points for API parity with spgpuDmdot / spgpuDmaxpby / ...
# ---------------------------------------------------------------------------


def mdot(a: jax.Array, b: jax.Array, conjugate: bool = False) -> jax.Array:
    """Per-column dot of two (count, n) multivectors → (count,)."""
    return dot(a, b, conjugate)


def mnrm2(x: jax.Array) -> jax.Array:
    return nrm2(x)


def masum(x: jax.Array) -> jax.Array:
    return asum(x)


def mamax(x: jax.Array) -> jax.Array:
    return amax(x)


def mscal(alpha, x: jax.Array) -> jax.Array:
    return scal(alpha, x)


def maxpby(alpha, x: jax.Array, beta, y: jax.Array) -> jax.Array:
    return axpby(alpha, x, beta, y)


def maxy(alpha, x: jax.Array, y: jax.Array) -> jax.Array:
    return axy(alpha, x, y)


def maxypbz(alpha, x: jax.Array, y: jax.Array, beta, z: jax.Array) -> jax.Array:
    return axypbz(alpha, x, y, beta, z)
