from spgpu_tpu.solvers.auto import solve
from spgpu_tpu.solvers.cg import CgResult, bicgstab, cg, jacobi_preconditioner

__all__ = ["CgResult", "bicgstab", "cg", "jacobi_preconditioner", "solve"]
