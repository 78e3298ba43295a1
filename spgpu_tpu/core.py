"""Core runtime: context, type registry, layout constants, status codes.

Re-design of the reference's context layer
(``/root/reference/src/core/core.h:43-138``, ``core.c:11-99``):

* The reference caches CUDA device properties (warpSize, maxGridSize, SM
  count, compute capability) in a ``SpgpuHandleStruct`` and launches every
  kernel on ``handle->currentStream``.  Here XLA compiles and launches the
  kernels, so :class:`Context` only records the JAX device (and optionally
  a mesh for the distributed layer).
* CUDA streams are not exposed by JAX (XLA owns scheduling);
  ``stream_create``/``set_stream`` are kept as documented no-op shims for
  API parity with ``spgpuStreamCreate``/``spgpuSetStream``
  (``core.c:50-80``).
* Status codes and the ``spgpuSizeOf`` type table are mirrored one-to-one
  (``core.h:43-57,134-138``, ``core.c:82-99``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import jax
import numpy as np

# ---------------------------------------------------------------------------
# Status / type codes (parity with core.h:43-57)
# ---------------------------------------------------------------------------


class Status(enum.IntEnum):
    """Return codes; mirrors ``spgpuStatus_t`` (``core.h:43-48``)."""

    SUCCESS = 0
    UNSUPPORTED = 1
    UNSPECIFIED = 2
    OUTOFMEMORY = 3


class TypeCode(enum.IntEnum):
    """Element type codes; mirrors ``spgpuType_t`` (``core.h:51-57``)."""

    INT = 0
    FLOAT = 1
    DOUBLE = 2
    COMPLEX_FLOAT = 3
    COMPLEX_DOUBLE = 4
    # Extension: not present in the reference.
    BFLOAT16 = 5


_TYPE_TO_DTYPE = {
    TypeCode.INT: np.dtype(np.int32),
    TypeCode.FLOAT: np.dtype(np.float32),
    TypeCode.DOUBLE: np.dtype(np.float64),
    TypeCode.COMPLEX_FLOAT: np.dtype(np.complex64),
    TypeCode.COMPLEX_DOUBLE: np.dtype(np.complex128),
}


def size_of(code: TypeCode) -> int:
    """Byte size of a type code; mirrors ``spgpuSizeOf`` (``core.c:82-99``)."""
    if code == TypeCode.BFLOAT16:
        return 2
    return _TYPE_TO_DTYPE[TypeCode(code)].itemsize


def dtype_of(code: TypeCode):
    if code == TypeCode.BFLOAT16:
        import jax.numpy as jnp

        return jnp.bfloat16
    return _TYPE_TO_DTYPE[TypeCode(code)]


# ---------------------------------------------------------------------------
# Layout constants
# ---------------------------------------------------------------------------

#: Row-axis pitch of the slot-major formats (ELL, DIA): rows are padded to
#: a multiple of 128 elements, a whole number of 128-byte memory
#: transactions for every dtype.  The reference pads to 32 elements
#: (``ell.c:33-37``, ``ell.h:24``).
ROW_PITCH = 128


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


#: Default rows per hack of HELL.  The reference requires a multiple of its
#: warp size 32 and uses 32 (``hell.h:30-33``).  Measured on an H100
#: (PERF.md, bring-up): a power-law FEM matrix pads 6.1x at 32 against
#: 12.6x at 128, and its SpMV runs 2.4x faster.
HELL_HACK_SIZE = 32

#: Default rows per hack of HDIA.  HDIA pads only per diagonal, so wider
#: hacks cost little padding and mean fewer slots to reduce over (measured
#: on an H100, PERF.md: 128 beats 32 by 7-12% on banded and stencil
#: matrices).
HDIA_HACK_SIZE = 128


def require_x64(dtype) -> None:
    """Raise when 64-bit values would silently become 32-bit on device.

    With ``jax_enable_x64`` off, ``jnp.asarray`` turns float64/complex128
    host arrays into float32/complex64 (with only a warning).  Conversions
    and solvers call this first so such inputs fail loudly instead."""
    dt = np.dtype(dtype)
    if dt in (np.float64, np.complex128) and not jax.config.jax_enable_x64:
        raise ValueError(
            f"{dt} values need 64-bit JAX: call "
            "jax.config.update('jax_enable_x64', True) before building "
            "the matrix, or pass float32/complex64 values")


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Context:
    """Per-device context; analogue of ``spgpuHandle_t``.

    Mirrors ``spgpuCreate`` (``core.c:11-41``), which caches device
    properties and a default stream.  Here we keep the JAX device and
    (optionally) a device mesh for the distributed layer — the
    replacement for the reference's bring-your-own-thread multi-GPU story
    (SURVEY §2.6).
    """

    device: object = None
    mesh: Optional[jax.sharding.Mesh] = None

    def __post_init__(self):
        if self.device is None:
            self.device = jax.devices()[0]

    @property
    def platform(self) -> str:
        return self.device.platform

    # -- stream shims (parity with core.c:50-80; XLA owns scheduling) -------

    def stream_create(self):
        """No-op shim for ``spgpuStreamCreate`` — XLA owns scheduling."""
        return None

    def set_stream(self, stream):
        """No-op shim for ``spgpuSetStream``."""
        return Status.SUCCESS

    def get_stream(self):
        """No-op shim for ``spgpuGetStream``."""
        return None


def create(device_index: int = 0) -> Context:
    """Create a context; mirrors ``spgpuCreate`` (``core.c:11-41``)."""
    return Context(device=jax.devices()[device_index])


def destroy(ctx: Context) -> Status:
    """Mirrors ``spgpuDestroy`` (``core.c:43-48``); nothing to free in JAX."""
    return Status.SUCCESS
