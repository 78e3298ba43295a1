"""Sparse matrix storage formats.

Re-designs of the reference's caller-owned device-buffer formats
(SURVEY §2.2; ``/root/reference/src/core/{ell,hell,dia,hdia}.h``) as JAX
pytree dataclasses.  The reference stores values **column-major with a
32-element pitch** so that consecutive GPU threads (one per row) read
consecutive addresses (``ell.h:26-61``, ``ell.c:33-37``).  The same
decision holds here: every format is **slot-major**, shape
``(slots, rows_padded)``, with rows on the contiguous last axis padded to
:data:`~spgpu_tpu.core.ROW_PITCH` — each slot of consecutive rows is one
coalesced read.
"""

from spgpu_tpu.formats.coo import CooMatrix
from spgpu_tpu.formats.ell import EllMatrix
from spgpu_tpu.formats.hell import HellMatrix
from spgpu_tpu.formats.dia import DiaMatrix, SdiaMatrix
from spgpu_tpu.formats.hdia import HdiaMatrix
from spgpu_tpu.formats.bcoo import BcooMatrix, BhdiaMatrix

__all__ = [
    "CooMatrix",
    "EllMatrix",
    "HellMatrix",
    "DiaMatrix",
    "SdiaMatrix",
    "HdiaMatrix",
    "BcooMatrix",
    "BhdiaMatrix",
]
