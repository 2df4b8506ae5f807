"""Carry state across from the JAX package, as NumPy arrays.

The port never imports ``jax``; these functions take the JAX objects and read
them with ``np.asarray``, so the tests can feed one instance, one operator
or one decomposition to both packages. Like every entry point of the port
they put the result on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.algorithms.core import LanczosDecomposition
from two_pass_lanczos_tpu_torch.devices import DEFAULT_DEVICE, resolve_device
from two_pass_lanczos_tpu_torch.operators import (
    CudaKKTOperator,
    DenseOperator,
    DiagonalOperator,
    KKTOperator,
    LinearOperator,
    SparseOperator,
)
from two_pass_lanczos_tpu_torch.ops.kkt_fused import FusedKKTSolver
from two_pass_lanczos_tpu_torch.ops.spmv import csr_from_triplets

__all__ = ["solver_from_jax", "decomposition_from_jax", "operator_from_jax"]


def solver_from_jax(jax_fused_solver, device=DEFAULT_DEVICE) -> FusedKKTSolver:
    """The port's solver for the instance of a JAX ``FusedKKTSolver``
    (its ``_kkt_arrays``: quad costs, arc_u, arc_v, num_nodes), with the
    same ``compensated`` setting."""
    d, u, v, p = jax_fused_solver._kkt_arrays
    return FusedKKTSolver(np.asarray(d), np.asarray(u), np.asarray(v), int(p),
                          device=device,
                          compensated=jax_fused_solver.compensated)


def decomposition_from_jax(dec, device=DEFAULT_DEVICE) -> LanczosDecomposition:
    """A JAX ``LanczosDecomposition`` as the port's, on ``device``."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    return LanczosDecomposition(
        alphas=t(dec.alphas), betas=t(dec.betas),
        steps_taken=t(np.int32(dec.steps_taken)).reshape(()),
        b_norm=t(dec.b_norm).reshape(()))


def operator_from_jax(op, device=DEFAULT_DEVICE) -> LinearOperator:
    """The port's operator of the same class as the JAX operator ``op``,
    from its arrays: Dense, Diagonal, Sparse (the padding dropped), KKT,
    and ``PallasKKTOperator`` as :class:`CudaKKTOperator` (the padded arcs
    dropped). Both packages then compute the same A."""
    kind = type(op).__name__
    if kind == "DenseOperator":
        return DenseOperator(np.asarray(op.a), device=device)
    if kind == "DiagonalOperator":
        return DiagonalOperator(np.asarray(op.diag), device=device)
    if kind == "SparseOperator":
        mat, nnz = op.mat, op.mat.nnz
        return SparseOperator(csr_from_triplets(
            *mat.shape, np.asarray(mat.rows)[:nnz], np.asarray(mat.cols)[:nnz],
            np.asarray(mat.vals)[:nnz], device=device), device=device)
    if kind == "KKTOperator":
        return KKTOperator(np.asarray(op.d), np.asarray(op.arc_u),
                           np.asarray(op.arc_v), int(op.num_nodes),
                           device=device)
    if kind == "PallasKKTOperator":
        m = int(op.num_arcs)
        return CudaKKTOperator(
            np.asarray(op.d_pad)[:m], np.asarray(op.u_pad)[:m],
            np.asarray(op.v_pad)[:m], int(op.num_nodes), device=device)
    raise TypeError(f"no counterpart in the port for a JAX {kind}")
