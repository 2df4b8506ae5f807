"""Operators and the CUDA kernel wrappers. The JAX package's TPU layout,
``SortedKKTLayout``, is not ported: the port's layout is ``KKTLayout``."""

from two_pass_lanczos_tpu_torch.ops.kkt_fused import FusedKKTSolver
from two_pass_lanczos_tpu_torch.ops.spmv import (
    SortedCOO,
    coo_spmv,
    csr_from_triplets,
    kkt_matvec,
)
from two_pass_lanczos_tpu_torch.ops.tridiag import (
    assemble_tridiagonal,
    eigh_tridiagonal,
    tridiagonal_solve_e1,
)

__all__ = [
    "FusedKKTSolver",
    "coo_spmv",
    "csr_from_triplets",
    "kkt_matvec",
    "SortedCOO",
    "assemble_tridiagonal",
    "eigh_tridiagonal",
    "tridiagonal_solve_e1",
]
