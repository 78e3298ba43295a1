"""SpMV / SpMM — XLA implementations (every format, every dtype).

Pure ``jnp`` programs that XLA fuses into one gather→multiply→reduce pass
per format; the same code runs on the CPU (tests, fp64 golden checks) and
the GPU, in float32/float64/complex64/complex128 and bfloat16.

Correspondence with the reference kernels (SURVEY §2.4):

* ``ell_spmv``  ↔ ``spgpu{S,D,C,Z}ellspmv``  (``ell_spmv_base*.cuh``)
* ``hell_spmv`` ↔ ``spgpu{S,D,C,Z}hellspmv`` (``hell_spmv_base*.cuh``)
* ``dia_spmv``  ↔ ``spgpu{S,D,C,Z}diaspmv``  (``dia_spmv_base*.cuh``);
  ``sdia_spmv`` is the same product with compile-time offsets
* ``hdia_spmv`` ↔ ``spgpu{S,D,C,Z}hdiaspmv`` (``hdia_spmv_base*.cuh``)

Shared semantics: ``z = beta*y + alpha*(A @ x)`` with a ``beta == 0``
specialisation that never reads ``y`` (the reference's ``_krn_b0``
kernels, ``ell_spmv_base_template.cuh:334-340``), and OELL's stored-row →
original-row output permutation (``:274-282``).  The CUDA mechanics the
reference needs — texture-cache variants, 2-way prefetch, grid chunking,
``__shfl`` hack-offset broadcast — have no equivalent here because XLA
handles caching, pipelining and tiling (SURVEY §7).

All functions accept multi-RHS ``x`` with leading batch dims
``(..., n_cols) → (..., n_rows)``; this *fuses* the reference's
"m"-multivector host-side loop into one kernel (SURVEY §2.5 note).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from spgpu_tpu.formats import (
    DiaMatrix, EllMatrix, HdiaMatrix, HellMatrix, SdiaMatrix)

__all__ = ["ell_spmv_xla", "hell_spmv_xla", "dia_spmv_xla", "sdia_spmv_xla",
           "hdia_spmv_xla"]


def _is_zero(v) -> bool:
    """True only for a *static* zero (safe to skip reading y)."""
    return isinstance(v, (int, float)) and v == 0


def _combine(acc, n_rows, alpha, beta, y, perm=None):
    """z = beta*y + alpha*acc, with OELL permutation and row unpadding."""
    if perm is not None:
        # stored row i holds original row perm[i]; scatter back.
        # perm is a permutation of the padded rows → pure shuffle.
        out = jnp.zeros(acc.shape, acc.dtype)
        out = out.at[..., perm].set(acc)
        acc = out
    acc = acc[..., :n_rows]
    if _is_zero(beta) or y is None:
        return acc if isinstance(alpha, (int, float)) and alpha == 1 else alpha * acc
    return alpha * acc + beta * y


def ell_spmv_xla(
    a: EllMatrix,
    x: jax.Array,
    alpha=1.0,
    beta=0.0,
    y: Optional[jax.Array] = None,
) -> jax.Array:
    """ELL/OELL SpMV: one fused gather-multiply-reduce over the slot axis.

    Padding slots carry (value 0, col 0) so no explicit ``rS`` masking is
    needed — the analogue of the reference's "noRs" kernels operating on
    zero-padded storage (``ell_spmv_base_nors.cuh:17-120``); the rS-driven
    early loop exit is a GPU latency trick, not a semantic.
    """
    xg = x[..., a.col_indices]  # (..., width_p, rows_p)
    acc = (a.values * xg).sum(axis=-2)
    return _combine(acc, a.n_rows, alpha, beta, y, a.row_perm)


def hell_spmv_xla(
    a: HellMatrix,
    x: jax.Array,
    alpha=1.0,
    beta=0.0,
    y: Optional[jax.Array] = None,
) -> jax.Array:
    """HELL SpMV: gather + multiply on the stacked (slots × hack) slab,
    then one ``segment_sum`` over ``slot_to_hack`` reduces each hack's
    ragged slot range to its 128 rows — the XLA-native replacement for the
    reference's per-warp hack-offset ``__shfl`` broadcast
    (``hell_spmv_base_template.cuh:32-54``)."""
    xg = x[..., a.col_indices]  # (..., S, hack)
    prod = a.values * xg
    prod = jnp.moveaxis(prod, -2, 0)  # (S, ..., hack)
    zh = jax.ops.segment_sum(prod, a.slot_to_hack, num_segments=a.num_hacks)
    acc = jnp.moveaxis(zh, 0, -2)  # (..., H, hack)
    acc = acc.reshape(acc.shape[:-2] + (a.rows_padded,))
    return _combine(acc, a.n_rows, alpha, beta, y, a.row_perm)


def dia_spmv_xla(
    a: DiaMatrix,
    x: jax.Array,
    alpha=1.0,
    beta=0.0,
    y: Optional[jax.Array] = None,
) -> jax.Array:
    """DIA SpMV: Σ_j dM[j] · x[i + offsets[j]] with the per-element column
    bound check of ``dia_spmv_base_template.cuh:133-135`` expressed as a
    clamp + mask (affine gather — no indirection array read)."""
    rows_p = a.rows_padded
    i = jnp.arange(rows_p, dtype=jnp.int32)[None, :]
    cols = i + a.offsets[:, None]  # (diags_p, rows_p)
    ok = (cols >= 0) & (cols < a.n_cols)
    xg = x[..., jnp.clip(cols, 0, a.n_cols - 1)]
    acc = (a.values * jnp.where(ok, xg, 0)).sum(axis=-2)
    return _combine(acc, a.n_rows, alpha, beta, y)


def sdia_spmv_xla(
    a: SdiaMatrix,
    x: jax.Array,
    alpha=1.0,
    beta=0.0,
    y: Optional[jax.Array] = None,
) -> jax.Array:
    """SDIA SpMV: Σ_j values[j] · x[i + offsets[j]] with every offset a
    compile-time constant — each term is a static slice of x zero-padded
    by the offset range, so the program reads no index stream, gathers
    nothing and needs no bound check (``dia_spmv_base_template.cuh:133-135``
    becomes the zero margins)."""
    n = a.n_rows
    if not a.offsets:
        acc = jnp.zeros(x.shape[:-1] + (n,), jnp.result_type(a.values, x))
        return _combine(acc, n, alpha, beta, y)
    lo = max(0, -min(a.offsets))
    hi = max(0, n + max(a.offsets) - a.n_cols)
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(lo, hi)])
    acc = sum(a.values[j] * xp[..., lo + off: lo + off + n]
              for j, off in enumerate(a.offsets))
    return _combine(acc, n, alpha, beta, y)


def hdia_spmv_xla(
    a: HdiaMatrix,
    x: jax.Array,
    alpha=1.0,
    beta=0.0,
    y: Optional[jax.Array] = None,
) -> jax.Array:
    """HDIA SpMV: per-slot shifted x window + segment_sum over hacks.

    Slot ``s`` (hack ``h``) touches x columns
    ``h·hack_size + lane + offsets[s]`` — contiguous per slot, so the
    gather is affine like DIA's.  Padding slots have ``offset = n_cols``
    which always fails the bound check."""
    lane = jnp.arange(a.hack_size, dtype=jnp.int32)[None, :]
    start = (a.slot_to_hack * a.hack_size + a.offsets)[:, None]
    cols = start + lane  # (S, hack)
    ok = (cols >= 0) & (cols < a.n_cols)
    xg = x[..., jnp.clip(cols, 0, a.n_cols - 1)]
    prod = a.values * jnp.where(ok, xg, 0)
    prod = jnp.moveaxis(prod, -2, 0)
    zh = jax.ops.segment_sum(prod, a.slot_to_hack, num_segments=a.num_hacks)
    acc = jnp.moveaxis(zh, 0, -2)
    acc = acc.reshape(acc.shape[:-2] + (a.rows_padded,))
    return _combine(acc, a.n_rows, alpha, beta, y)
