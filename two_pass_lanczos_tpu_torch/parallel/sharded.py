"""Row-sharded sparse operator and distributed f(A)·b solves.

Counterpart of ``two_pass_lanczos_tpu/parallel/sharded.py`` on
``torch.distributed``: one process per device, a :class:`Mesh` of D ranks.
The operator's rows and every n-vector are split over the ranks by the
nnz-balancing symmetric permutation of ``parallel/partition.py``; rank r
holds the rows ``perm[r·rows_per:(r+1)·rows_per]``. Each Lanczos step does,
in this order (:meth:`ShardedSparseOperator._matvec`):

1. issue the all-gather of the current Krylov vector, O(n) bytes,
   asynchronously (``parallel/comm.all_gather_start``);
2. the OWNED-column part of the local row-block SpMV, which reads only
   this rank's shard, while the gather is in flight (SURVEY §7 stage 5);
3. wait for the gather;
4. the REMOTE-column part, on the gathered vector;
5. the two scalar reductions (α, β²) as all-gathers of the (D,) partials
   folded in rank order (``comm.gather_fold``).

Each part of the SpMV is ``ops/spmv.coo_spmv``, a fixed-order CSR row sum,
as the generic ``SparseOperator`` does: no ``index_add_`` (atomic on CUDA),
so pass two replays pass one's basis bit for bit on every rank. The JAX
package reduced the dots with ``lax.psum``; the rank-ordered fold gives
every rank the same α, β bits whatever NCCL's algorithm. The recurrence is
``algorithms/core.py``'s, eager around the product and the collectives,
with α, β and the breakdown flag on the device, so a pass queues its work
with no host sync; only the callback path reads back, once per chunk.

As in the JAX package, N ranks match one rank to rounding (the reduction
orders differ), while the two-pass replay is bitwise within a fixed D.

Real f32 and f64 operators only. The capability methods (``eigsh``,
``slq_*``, ``solve_fAb_block``, ``estimate_interval``, ``chebyshev_fAb``)
raise ``NotImplementedError`` until ROADMAP Queue 1 item 2, and
``reorth=True`` raises as the generic solvers' does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.algorithms.core import (
    LanczosDecomposition,
    basis_product,
    pass_one_chunk_scan,
    pass_one_scan,
    pass_two_scan,
)
from two_pass_lanczos_tpu_torch.ops.kkt_fused import run_chunks, scaled_y
from two_pass_lanczos_tpu_torch.ops.spmv import SortedCOO, coo_spmv
from two_pass_lanczos_tpu_torch.parallel.comm import (
    all_gather,
    all_gather_start,
    gather_fold,
)
from two_pass_lanczos_tpu_torch.parallel.mesh import Mesh
from two_pass_lanczos_tpu_torch.parallel.partition import (
    RowPartition,
    local_blocks,
    snake_partition,
)
from two_pass_lanczos_tpu_torch.solvers import _check_reorth
from two_pass_lanczos_tpu_torch.utils.collectives import record_event

__all__ = ["ShardedSparseOperator"]

_CAPABILITY = ("{} is not ported yet: the capability layer comes with "
               "ROADMAP Queue 1 item 2")


class ShardedSparseOperator:
    """A symmetric sparse operator row-partitioned over a 1-D mesh.

    Usage, in every rank of the run::

        mesh = make_mesh()                                # NCCL, a card each
        sop = ShardedSparseOperator.from_kkt_arrays(arrays, mesh)
        x, decomp = sop.solve_fAb(b, k=500, f="inv")      # NumPy (n,) x

    Build from COO triplets (or a :class:`SortedCOO`); rows are permuted
    for nnz balance (``partition.snake_partition``) and vectors padded to
    ``rows_per·D``. ``solve_fAb`` takes and returns ordinary
    (original-order, unpadded) vectors; ``raw=True`` returns this rank's
    permuted shard instead, with no collective.
    """

    def __init__(self, n: int, rows, cols, vals, mesh: Mesh, dtype=None):
        self.mesh = mesh
        self.device = mesh.device
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        if dtype is not None:
            vals = vals.astype(dtype)
        if vals.dtype not in (np.float32, np.float64):
            raise ValueError(f"real f32 or f64 values only, not {vals.dtype}")
        self.dtype = torch.from_numpy(vals[:0]).dtype

        nnz_per_row = np.bincount(rows, minlength=n)
        self.part: RowPartition = snake_partition(nnz_per_row, mesh.size)
        r, rp = mesh.rank, self.part.rows_per
        owned, remote = local_blocks(rows, cols, vals, self.part, r)

        def local(block, width):
            # rows ascending, each row's entries in triplet order: the order
            # of the JAX package's sorted scatter-add
            lr, lc, lv = block
            indptr = np.zeros(rp + 1, np.int64)
            np.cumsum(np.bincount(lr, minlength=rp), out=indptr[1:])
            up = lambda a, dt: torch.from_numpy(  # noqa: E731
                np.ascontiguousarray(a, dt)).to(self.device)
            return SortedCOO(rows=up(lr, np.int64), cols=up(lc, np.int64),
                             vals=up(lv, vals.dtype), indptr=up(indptr, np.int64),
                             shape=(rp, width))

        #: this rank's rows: columns of its own shard, and of the gathered
        #: vector
        self.owned: SortedCOO = local(owned, rp)
        self.remote: SortedCOO = local(remote, self.part.n_pad)
        #: original row ids of this rank's shard (ids >= n are padding)
        self._rows = torch.from_numpy(
            self.part.perm[r * rp:(r + 1) * rp].copy()).to(self.device)
        self._restore = torch.from_numpy(
            self.part.inv_perm[:n].copy()).to(self.device)

    # ------------------------------------------------------------------
    @classmethod
    def from_coo(cls, coo: SortedCOO, mesh: Mesh):
        """From the port's :class:`SortedCOO` (on any device)."""
        return cls(coo.shape[0], coo.rows.cpu().numpy(),
                   coo.cols.cpu().numpy(), coo.vals.cpu().numpy(), mesh)

    @classmethod
    def from_kkt_arrays(cls, arrays, mesh: Mesh, dtype=np.float64):
        """Directly from loader output — assembles the 5m KKT triplets."""
        m, p = arrays.num_arcs, arrays.num_nodes
        j = np.arange(m, dtype=np.int64)
        au = np.asarray(arrays.arc_u).astype(np.int64) + m
        av = np.asarray(arrays.arc_v).astype(np.int64) + m
        rows = np.concatenate([j, au, av, j, j])
        cols = np.concatenate([j, j, j, au, av])
        ones = np.ones(m, dtype=dtype)
        vals = np.concatenate([np.asarray(arrays.quad_costs).astype(dtype),
                               ones, -ones, ones, -ones])
        return cls(m + p, rows, cols, vals, mesh, dtype=dtype)

    # ------------------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, int]:
        n = self.part.n_orig
        return (n, n)

    @property
    def nnz_per_device(self) -> np.ndarray:
        return self.part.nnz_per_dev

    def _prepare_b(self, b) -> torch.Tensor:
        """This rank's ``(rows_per,)`` shard of the padded, permuted b (or
        ``(nf, rows_per)`` for an ``(nf, n)`` stack), on the mesh's
        device; ``b`` is NumPy or a tensor anywhere."""
        t = b if isinstance(b, torch.Tensor) else torch.from_numpy(
            np.asarray(b))
        n = self.part.n_orig
        if t.shape[-1] != n:
            raise ValueError(f"b has length {t.shape[-1]}, operator is {n}")
        t = t.to(device=self.device, dtype=self.dtype)
        pad = t.new_zeros(t.shape[:-1] + (self.part.n_pad - n,))
        return torch.cat([t, pad], dim=-1)[..., self._rows].contiguous()

    def _restore_x(self, x_local: torch.Tensor) -> np.ndarray:
        """The original-order (n,) — or (nf, n) — x as NumPy on every rank:
        one all-gather of the shards, then the inverse permutation."""
        g = all_gather(x_local, self.mesh)  # (D, ..., rows_per)
        x_perm = g.movedim(0, -2).reshape(x_local.shape[:-1]
                                          + (self.part.n_pad,))
        return x_perm[..., self._restore].cpu().numpy()

    # -- the per-step collectives -----------------------------------------
    def _matvec(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of A·x for its shard x: the gather issued, the
        owned-column product computed while it flies, then the
        remote-column product on the gathered vector."""
        pending = all_gather_start(x, self.mesh)
        y = coo_spmv(self.owned, x)
        record_event("owned-spmv")
        x_full = pending.wait().view(-1)
        if self.remote.nnz:
            y = y + coo_spmv(self.remote, x_full)
            record_event("remote-spmv")
        return y

    def _dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """⟨a, b⟩ over the mesh: the (D,) partials folded in rank order."""
        return gather_fold(torch.dot(a, b), self.mesh)

    def matvec_distributed(self, x, raw: bool = False):
        """One distributed SpMV (for tests and benchmarks): original order
        in and out, or this rank's permuted shard with ``raw=True``."""
        y = self._matvec(self._prepare_b(x))
        return y if raw else self._restore_x(y)

    # -- passes -----------------------------------------------------------
    def pass_one_chunked(self, b, k: int, callback=None, chunk: int = 16):
        """Pass one with a live per-iteration callback over the mesh — the
        reference's in-loop ``LanczosCallback`` break-out on the row
        partition.

        Same contract as ``ShardedFusedKKTSolver.pass_one_chunked``: after
        each ``chunk``-step run of ``pass_one_chunk_scan`` the replicated α,
        β, ``steps`` and breakdown flag come back in one copy and
        ``callback(s, None, (alphas[:s], betas[:s-1]))`` is replayed for
        every new step s; a stop at step s costs at most
        ceil(s/chunk)·chunk matvecs. α and β are bitwise the monolithic
        pass's. Returns ``(decomposition, stopped)``.
        """
        bl = self._prepare_b(b)
        carry = None

        def run(j0, c):
            nonlocal carry
            a_c, b_c, carry = pass_one_chunk_scan(self._matvec, bl, c, carry,
                                                  k, dot=self._dot)
            host = torch.cat([a_c, b_c, carry.steps.to(a_c.dtype).reshape(1),
                              carry.done.to(a_c.dtype).reshape(1),
                              carry.b_norm.reshape(1)]).cpu().numpy()
            return (host[:c], host[c:2 * c], int(host[2 * c]),
                    not host[2 * c + 1], host[2 * c + 2])

        decomp, stopped, self._last_p1_launches = run_chunks(
            run, k, chunk, callback, self.device, self.dtype)
        return decomp, stopped

    def solve_fAb(self, b, *, k: int, f="exp", method: str = "two_pass",
                  raw: bool = False, callback=None, callback_chunk: int = 16,
                  reorth: bool = False):
        """Distributed f(A)·b. Returns ``(x, decomposition)``.

        ``x`` is a NumPy array in original row order on every rank (one
        all-gather of the shards), or with ``raw=True`` this rank's
        ``(rows_per,)`` row-permuted shard on its device; the
        decomposition's α, β, steps and ‖b‖ are the same bits on every rank.
        ``f`` may be a tuple of function specs — all evaluated from one
        decomposition for one run's matvecs (``x`` gains a leading nf
        axis). ``method="one_pass"`` stores this rank's ``(k, rows_per)``
        basis and forms x = V_k·y in full precision. ``callback``
        (two_pass only) runs pass one by :meth:`pass_one_chunked`; a stop at
        step s runs a pass two of s steps, so the solve pays
        ceil(s/chunk)·chunk + s matvecs instead of 2k.
        """
        _check_reorth(reorth)
        if method not in ("one_pass", "two_pass"):
            raise ValueError(f"unknown method {method!r}")
        if callback is not None and method != "two_pass":
            raise ValueError("callback early stopping is implemented for the "
                             "two_pass method")
        bl = self._prepare_b(b)
        if callback is not None:
            decomp, _ = self.pass_one_chunked(b, k, callback, callback_chunk)
            k2 = max(decomp.steps(), 1)
            self._last_p2_len = k2
            short = LanczosDecomposition(
                alphas=decomp.alphas[:k2], betas=decomp.betas[:k2],
                steps_taken=decomp.steps_taken, b_norm=decomp.b_norm)
            x, _ = pass_two_scan(self._matvec, bl, short,
                                 scaled_y(short, f, k2))
        elif method == "one_pass":
            decomp, basis = pass_one_scan(self._matvec, bl, k,
                                          emit_basis=True, dot=self._dot)
            x = basis_product(scaled_y(decomp, f, k).to(self.dtype), basis)
            del basis
        else:
            decomp, _ = pass_one_scan(self._matvec, bl, k, dot=self._dot)
            x, _ = pass_two_scan(self._matvec, bl, decomp,
                                 scaled_y(decomp, f, k))
        return (x if raw else self._restore_x(x)), decomp

    # -- not ported yet -----------------------------------------------------
    def eigsh(self, *args, **kwargs):
        raise NotImplementedError(_CAPABILITY.format("eigsh"))

    def slq_trace(self, *args, **kwargs):
        raise NotImplementedError(_CAPABILITY.format("slq_trace"))

    def slq_spectral_density(self, *args, **kwargs):
        raise NotImplementedError(_CAPABILITY.format("slq_spectral_density"))

    def slq_trace_adaptive(self, *args, **kwargs):
        raise NotImplementedError(_CAPABILITY.format("slq_trace_adaptive"))

    def solve_fAb_block(self, *args, **kwargs):
        raise NotImplementedError(_CAPABILITY.format("solve_fAb_block"))

    def estimate_interval(self, *args, **kwargs):
        raise NotImplementedError(_CAPABILITY.format("estimate_interval"))

    def chebyshev_fAb(self, *args, **kwargs):
        raise NotImplementedError(_CAPABILITY.format("chebyshev_fAb"))
