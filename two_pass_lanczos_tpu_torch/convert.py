"""Carry state across from the JAX package, as NumPy arrays.

The port never imports ``jax``; these functions take the JAX objects and read
them with ``np.asarray``, so the tests can feed one instance, one operator
or one decomposition to both packages. Like every entry point of the port
they put the result on the card unless the caller asks for the CPU; the
sharded solvers' device is their mesh's (``make_mesh`` defaults to the
card).
"""

from __future__ import annotations

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.algorithms.block import BlockDecomposition
from two_pass_lanczos_tpu_torch.algorithms.core import LanczosDecomposition
from two_pass_lanczos_tpu_torch.algorithms.df import DFKKTOperator
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
from two_pass_lanczos_tpu_torch.ops.kkt_fused_df import DFFusedKKTSolver
from two_pass_lanczos_tpu_torch.ops.spmv import csr_from_triplets
from two_pass_lanczos_tpu_torch.parallel.fused_sharded import (
    ShardedFusedKKTSolver,
)
from two_pass_lanczos_tpu_torch.parallel.fused_sharded_df import (
    DFShardedFusedKKTSolver,
)
from two_pass_lanczos_tpu_torch.parallel.sharded import ShardedSparseOperator

__all__ = ["solver_from_jax", "decomposition_from_jax",
           "block_decomposition_from_jax", "operator_from_jax",
           "df_operator_from_jax", "df_solver_from_jax",
           "sharded_solver_from_jax", "df_sharded_solver_from_jax",
           "sharded_operator_from_jax"]


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


def block_decomposition_from_jax(dec, device=DEFAULT_DEVICE
                                 ) -> BlockDecomposition:
    """A JAX ``BlockDecomposition`` as the port's, on ``device``: so JAX's
    pass one can feed the port's ``block_pass_two`` and
    ``block_padded_f_e1``."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    return BlockDecomposition(
        a_blocks=t(dec.a_blocks), b_blocks=t(dec.b_blocks), r0=t(dec.r0),
        steps_taken=t(np.int32(dec.steps_taken)).reshape(()))


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


def df_operator_from_jax(op, device=DEFAULT_DEVICE) -> DFKKTOperator:
    """The port's :class:`DFKKTOperator` for a JAX ``DFKKTOperator``: its
    ``d.hi`` and ``d.lo`` planes as they are (never recombined: hi + lo is
    not the f64 costs exactly, and both packages must compute with the same
    pair), its arcs and node count."""
    return DFKKTOperator((np.asarray(op.d.hi), np.asarray(op.d.lo)),
                         np.asarray(op.arc_u), np.asarray(op.arc_v),
                         int(op.num_nodes), device=device)


def df_solver_from_jax(jax_df_solver, device=DEFAULT_DEVICE
                       ) -> DFFusedKKTSolver:
    """The port's :class:`DFFusedKKTSolver` for a JAX ``DFFusedKKTSolver``.
    The JAX solver keeps only its rep layout, so the arcs are read back from
    the tail ordering: at ``layout.u.pos`` the d hi/lo planes
    (``_arrs[0:2]``) hold each arc's cost pair, ``es2`` its tail and
    ``eo2`` its head."""
    lay = jax_df_solver.layout
    pos = np.asarray(lay.u.pos)
    arrs = jax_df_solver._arrs

    def at_pos(a):
        return np.asarray(a).reshape(-1)[pos]

    return DFFusedKKTSolver((at_pos(arrs[0]), at_pos(arrs[1])),
                            at_pos(lay.u.es2).astype(np.int64),
                            at_pos(lay.u.eo2).astype(np.int64), int(lay.p),
                            device=device)


def _same_split(jax_solver, port_solver) -> None:
    """Both solvers must own the same arcs on every rank (the JAX
    package's ``np.array_split`` over the same device count)."""
    theirs = [np.asarray(ix) for ix in jax_solver.arc_idx]
    ours = port_solver.arc_idx
    if len(theirs) != len(ours) or not all(
            np.array_equal(a, b) for a, b in zip(theirs, ours)):
        raise ValueError(
            f"the JAX solver splits its arcs over {len(theirs)} devices, "
            f"the mesh has {len(ours)} ranks: arc_idx differs")


def sharded_solver_from_jax(jax_solver, mesh) -> ShardedFusedKKTSolver:
    """This rank's :class:`ShardedFusedKKTSolver` for the instance of a JAX
    ``ShardedFusedKKTSolver`` (its host ``_kkt_arrays``), on ``mesh``; the
    mesh must have as many ranks as the JAX mesh has devices, so that each
    rank owns the JAX shard of its index."""
    d, u, v, p = jax_solver._kkt_arrays
    s = ShardedFusedKKTSolver(np.asarray(d), np.asarray(u), np.asarray(v),
                              int(p), mesh)
    _same_split(jax_solver, s)
    return s


def df_sharded_solver_from_jax(jax_solver, mesh, kkt_arrays
                               ) -> DFShardedFusedKKTSolver:
    """This rank's :class:`DFShardedFusedKKTSolver` for a JAX
    ``DFShardedFusedKKTSolver``. The JAX solver keeps only its padded
    per-device layouts, so the caller passes the instance's
    ``(d64, u, v, p)``; its size and the arc split are checked against the
    JAX solver's."""
    d, u, v, p = kkt_arrays
    if (len(d), int(p)) != (jax_solver.m, jax_solver.p):
        raise ValueError(
            f"kkt_arrays have m={len(d)}, p={int(p)}; the JAX solver "
            f"m={jax_solver.m}, p={jax_solver.p}")
    s = DFShardedFusedKKTSolver(np.asarray(d, np.float64), np.asarray(u),
                                np.asarray(v), int(p), mesh)
    _same_split(jax_solver, s)
    return s


def sharded_operator_from_jax(jax_sop, mesh) -> ShardedSparseOperator:
    """This rank's :class:`ShardedSparseOperator` for the matrix of a JAX
    ``ShardedSparseOperator``, whose triplets survive only in its
    per-device blocks (``local_blocks``: owned columns by local id, remote
    columns by gathered id, both padded with zero values). The triplets are
    read back through its partition's ``perm`` (the padding and any
    explicit zero dropped), each row's entries in their order there; the
    port then partitions them over ``mesh`` itself."""
    part = jax_sop.part
    rp = part.rows_per
    blocks = [np.asarray(a) for a in jax_sop.local_blocks]
    rows, cols, vals = [], [], []
    for (lr, lc, lv), local in ((blocks[:3], True), (blocks[3:], False)):
        for d in range(part.ndev):
            keep = lv[d] != 0
            pos_c = lc[d][keep].astype(np.int64)
            rows.append(part.perm[d * rp + lr[d][keep].astype(np.int64)])
            cols.append(part.perm[d * rp + pos_c if local else pos_c])
            vals.append(lv[d][keep])
    return ShardedSparseOperator(part.n_orig, np.concatenate(rows),
                                 np.concatenate(cols), np.concatenate(vals),
                                 mesh)
