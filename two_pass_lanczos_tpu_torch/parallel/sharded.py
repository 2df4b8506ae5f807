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

Each part of the SpMV is ``ops/spmv.coo_spmv``, a fixed-order CSR row sum
(one launch of K15, ``csrc/csr_spmv.cu``, on a card; each part carries its
own row-block plan), as the generic ``SparseOperator`` does: no
``index_add_`` (atomic on CUDA), so pass two replays pass one's basis bit
for bit on every rank. The JAX
package reduced the dots with ``lax.psum``; the rank-ordered fold gives
every rank the same α, β bits whatever NCCL's algorithm. The recurrence is
``algorithms/core.py``'s, eager around the product and the collectives,
with α, β and the breakdown flag on the device, so a pass queues its work
with no host sync; only the callback path reads back, once per chunk.

As in the JAX package, N ranks match one rank to rounding (the reduction
orders differ), while the two-pass replay is bitwise within a fixed D.

The capability methods run the port's shared drivers over the same
matvec and rank-ordered folds: ``eigsh`` (thick restart with the basis
split by rows, ``eigen._expand_and_ritz``'s sharding hooks), the SLQ
methods (one sharded pass one a probe), ``solve_fAb_block`` (block Lanczos
with CholeskyQR2 in place of the Householder QR, which has no distributed
form: its only collectives are the folded p×p Gram matrices),
``estimate_interval`` (two sharded eigsh runs) and ``chebyshev_fAb`` (no
inner product at all); ``solve_fAb(reorth=...)`` reorthogonalises against
the row-split basis, folding the ``(j+1,)`` projection partials.

Real (f32, f64) and complex Hermitian (c64, c128) triplets, as in the JAX
package: a complex operator keeps α, β and ‖b‖ real (each rank's partial
is ``Re⟨a, b⟩``), its projections conjugate the basis, and its collectives
gather the complex vectors as their real views.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from two_pass_lanczos_tpu_torch import slq
from two_pass_lanczos_tpu_torch.algorithms.block import (
    BlockDecomposition,
    _block_matvec,
    _block_recurrence_body,
    _contract,
    host_f_e1_r0,
)
from two_pass_lanczos_tpu_torch.algorithms.chebyshev import (
    chebyshev_coefficients,
    chebyshev_scan,
    interval_from_extremes,
    validate_interval_for_f,
)
from two_pass_lanczos_tpu_torch.algorithms.core import (
    LanczosDecomposition,
    basis_product,
    breakdown_tolerance,
    full_f32_matmul,
    inner,
    pass_one_chunk_scan,
    pass_one_scan,
    pass_two_scan,
    real_dtype,
)
from two_pass_lanczos_tpu_torch.devices import cpu_generator
from two_pass_lanczos_tpu_torch.eigen import (
    EigshResult,
    _eigsh_driver,
    _expand_and_ritz,
    _norm,
    eigsh_thickness,
    validate_eigsh_params,
)
from two_pass_lanczos_tpu_torch.ops.kkt_fused import run_chunks, scaled_y
from two_pass_lanczos_tpu_torch.ops.spmv import (
    SortedCOO,
    coo_spmv,
    row_blocks,
)
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
from two_pass_lanczos_tpu_torch.solvers import pass_one_reorth, reorth_mode
from two_pass_lanczos_tpu_torch.spectrum import _f_of_theta
from two_pass_lanczos_tpu_torch.utils.collectives import record_event

__all__ = ["ShardedSparseOperator"]


def rank_generator(gen: torch.Generator, rank: int) -> torch.Generator:
    """A CPU generator of this rank's own: seeded from (a seed drawn from
    ``gen``, which every rank draws alike, and ``rank``), the port's form
    of JAX's ``fold_in(key, axis_index)``."""
    base = int(torch.randint(0, 2 ** 62, (), generator=gen))
    seed = np.random.SeedSequence([base, rank]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed))


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
        if vals.dtype not in (np.float32, np.float64, np.complex64,
                              np.complex128):
            raise ValueError(f"f32, f64, c64 or c128 values only, not "
                             f"{vals.dtype}")
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
                             blocks=up(row_blocks(indptr), np.int64),
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
        """⟨a, b⟩ (``Re⟨a, b⟩`` for complex shards) over the mesh: the
        (D,) partials folded in rank order."""
        return gather_fold(inner(a, b), self.mesh)

    def _fold(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of this rank's partials ``t``, in rank
        order (the reorthogonalisation's projections, eigsh's, the block
        Gram matrices)."""
        return gather_fold(t, self.mesh)

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
            run, k, chunk, callback, self.device, real_dtype(self.dtype))
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
        ``reorth=True``/``"full"`` or ``"selective"`` (one-pass only) runs
        the reorthogonalised pass one with this rank's rows of the basis;
        each CGS sweep folds one ``(j+1,)`` vector of projection partials.
        """
        mode = reorth_mode(reorth)  # normalise; reject typos
        if mode is not None:
            if method != "one_pass":
                raise ValueError(
                    "reorth= requires method='one_pass' (the stored basis it "
                    "orthogonalises against is the one-pass state)")
            if callback is not None:
                raise ValueError(
                    "reorth= is not supported together with callback=")
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
            if mode is not None:
                decomp, basis = pass_one_reorth(self._matvec, bl, k, mode,
                                                dot=self._dot,
                                                reduce=self._fold)
            else:
                decomp, basis = pass_one_scan(self._matvec, bl, k,
                                              emit_basis=True, dot=self._dot)
            x = basis_product(scaled_y(decomp, f, k).to(self.dtype), basis)
            del basis
        else:
            decomp, _ = pass_one_scan(self._matvec, bl, k, dot=self._dot)
            x, _ = pass_two_scan(self._matvec, bl, decomp,
                                 scaled_y(decomp, f, k))
        return (x if raw else self._restore_x(x)), decomp


    # -- capability methods ------------------------------------------------
    def eigsh(self, nev: int = 6, *, which: str = "LA", ncv=None,
              tol: float = 1e-8, maxiter: int = 100, v0=None, key=None,
              _restore_vectors: bool = True) -> EigshResult:
        """Distributed thick-restart Lanczos eigenpairs: :func:`eigen.eigsh`
        with this rank's rows of the (ncv+1, n) basis.

        Per expansion step one distributed SpMV and two CGS2 sweeps whose
        (ncv+1,) projection partials are folded in rank order; the ncv×ncv
        Rayleigh–Ritz ``eigh`` runs on every rank on the same bits. ``v0``
        (default: Gaussian from ``key``, in original row order, the draw of
        :func:`eigen.eigsh`) is padded and permuted; random injections past
        an invariant subspace are masked to the rows that are not padding
        (whose spurious zero eigenvalues never enter the Krylov space), and
        each rank draws them from its own generator (:func:`rank_generator`).
        Returns :class:`eigen.EigshResult`, the eigenvectors in original row
        order on every rank (one gather)."""
        n = self.part.n_orig
        ncv = validate_eigsh_params(n, nev, ncv, which, maxiter)
        ell = eigsh_thickness(nev, ncv)
        gen = cpu_generator(0 if key is None else key)
        if v0 is None:
            v0 = torch.randn(n, generator=gen, dtype=self.dtype)
        b_local = self._prepare_b(v0)
        if float(_norm(b_local, self._fold)) == 0.0:
            raise ValueError("v0 must be nonzero")
        valid = (self._rows < n).to(self.dtype)
        mine = []

        def fold(g):
            # this rank's stream, made at the first injection (so a run
            # without one draws from ``gen`` as the single-card eigsh does)
            if not mine:
                mine.append(rank_generator(g, self.mesh.rank))
            return mine[0]
        v_basis = torch.zeros((ncv + 1,) + tuple(b_local.shape),
                              dtype=self.dtype, device=self.device)
        v_basis[0] = b_local / _norm(b_local, self._fold)
        h_proj = torch.zeros((ncv, ncv), dtype=self.dtype,
                             device=self.device)

        def cycle(v, h, start):
            return _expand_and_ritz(self._matvec, v, h, start, gen,
                                    reduce_sum=self._fold,
                                    inject_mask=valid, inject_fold=fold)

        theta, vectors, resid, restarts, converged = _eigsh_driver(
            cycle, v_basis, h_proj, nev=nev, ell=ell, which=which, tol=tol,
            maxiter=maxiter)
        return EigshResult(
            eigenvalues=theta,
            eigenvectors=(self._restore_x(vectors) if _restore_vectors
                          else None),
            residual_norms=resid, restarts=restarts, converged=converged)

    def _slq_pass_one(self, probes, k: int) -> LanczosDecomposition:
        """Pass one over the row partition for each row of the (m, n)
        probes (original order), one after another; the stacked
        decomposition, the same bits on every rank."""
        z = self._prepare_b(torch.as_tensor(probes))
        return slq.stack_decompositions(
            [pass_one_scan(self._matvec, row.contiguous(), k,
                           dot=self._dot)[0] for row in z])

    def slq_trace(self, f="inv", *, k: int = 50, num_probes: int = 16,
                  key, probe: str = "rademacher") -> slq.SLQResult:
        """Distributed stochastic Lanczos quadrature ``tr f(A)``: the
        estimator of :func:`slq.slq_trace` with every probe's pass one over
        the row partition. The probes are drawn from ``key`` (a CPU
        ``torch.Generator`` or an ``int`` seed) in original row order, as
        the single-card estimator draws them, so both see the same probes;
        the padding rows stay zero and contribute nothing."""
        if num_probes < 1:
            raise ValueError("num_probes must be >= 1")
        if not callable(f):
            slq._f_of_theta(torch.ones(1), f)  # reject unknown strings
        probes = slq._draw_probes(key, num_probes, self.part.n_orig,
                                  self.dtype, probe)
        decomp = self._slq_pass_one(probes, k)
        return slq.slq_stats(slq.batched_quadratic_form(decomp, f))

    def slq_spectral_density(self, grid, *, sigma=None, k: int = 50,
                             num_probes: int = 16, key,
                             probe: str = "gaussian") -> torch.Tensor:
        """Distributed smoothed spectral density: the unit probes' pass one
        over the row partition, then :func:`slq.dos_from_decomposition`
        on the replicated decomposition. A tensor on the mesh's device."""
        grid, sigma = slq.validate_dos_params(grid, sigma, num_probes)
        probes = slq._draw_probes(key, num_probes, self.part.n_orig,
                                  self.dtype, probe)
        probes = probes / torch.linalg.norm(probes, dim=1, keepdim=True)
        return slq.dos_from_decomposition(self._slq_pass_one(probes, k),
                                          grid, sigma)

    def slq_trace_adaptive(self, f="inv", *, k: int = 50, key,
                           probe: str = "rademacher",
                           target_rel_stderr: float = 0.01,
                           batch: int = 8, max_probes: int = 512
                           ) -> slq.SLQResult:
        """:meth:`slq_trace` with the probe count chosen by the shared
        :func:`slq.adaptive_probe_loop`: ``batch`` probes a round through
        this operator until the sample standard error certifies
        ``target_rel_stderr`` (or ``max_probes``)."""
        return slq.adaptive_probe_loop(
            lambda gen, take: self.slq_trace(
                f, k=k, num_probes=take, key=gen, probe=probe).samples,
            key, batch=batch, max_probes=max_probes,
            target_rel_stderr=target_rel_stderr)

    def _chol_qr2(self, w: torch.Tensor, ref_scale: torch.Tensor, tol: float):
        """The distributed tall-skinny QR of this rank's rows ``w``:
        ``(V, R, ok)`` by two rounds of ``R = chol(fold(WᴴW))ᴴ; V = W·R⁻¹``
        (CholeskyQR2, Yamamoto et al. 2015). ``ok`` fails on a Cholesky
        that is not positive definite or on a relative collapse of |diag
        R| against the larger of its own scale and ``ref_scale`` (the
        recurrence's max|diag A_j|, which alone sees an invariant subspace's
        rounding-noise residual)."""
        p = w.shape[1]
        eye = torch.eye(p, dtype=w.dtype, device=w.device)

        def one_round(v_in):
            c, info = torch.linalg.cholesky_ex(self._fold(v_in.mH @ v_in))
            ok_r = (info == 0) & ~torch.isnan(c).any()
            r = torch.where(ok_r, c, eye).mH
            return (torch.linalg.solve_triangular(r, v_in, upper=True,
                                                  left=False), r, ok_r)

        v1, r1, ok1 = one_round(w)
        v2, r2, ok2 = one_round(v1)
        r = r2 @ r1
        diag = r.diagonal().abs()
        full = diag.min() > tol * torch.maximum(diag.max(), ref_scale)
        return v2, r, ok1 & ok2 & full

    @full_f32_matmul()
    def solve_fAb_block(self, b_block, *, k: int, f="exp",
                        raw: bool = False):
        """Distributed block Lanczos ``f(A)·B`` over the row partition.

        The recurrence is ``algorithms/block.py``'s body with its p×p
        projections folded across ranks; the block normalisation is
        CholeskyQR2 (:meth:`_chol_qr2`), whose positive Cholesky diagonal
        matches the single-card positive-diagonal R, so both agree to
        rounding. A rank breakdown truncates through ``steps_taken``; a zero
        or rank-deficient B gives zeros. The projected f(T) is the host f64
        solve of :func:`algorithms.block.solve_fAb_block`. Returns the (n,
        p) NumPy x on every rank, or with ``raw=True`` this rank's
        (rows_per, p) row-permuted shard."""
        if not callable(f):
            _f_of_theta(np.ones(1), f)
        if k < 1:
            raise ValueError("k must be >= 1")
        t = b_block if isinstance(b_block, torch.Tensor) else \
            torch.from_numpy(np.asarray(b_block))
        if t.dim() != 2:
            raise ValueError(
                f"b_block must be (n, p), got {tuple(t.shape)}")
        n, p = t.shape
        if n != self.part.n_orig:
            raise ValueError(
                f"b_block has {n} rows, operator is {self.part.n_orig}")
        if p < 1 or p > n:
            raise ValueError(f"block width p={p} must be in [1, n={n}]")
        if t.is_complex() and not self.dtype.is_complex:
            raise TypeError(
                "complex b_block with a real operator; build the "
                "ShardedSparseOperator with complex vals for a "
                "Hermitian A (the block path is self-adjoint-generic)")
        bl = self._prepare_b(t.T).T.contiguous()  # (rows_per, p)
        dt, dev = bl.dtype, bl.device
        tol = breakdown_tolerance(dt)
        block_mv = _block_matvec(self._matvec)
        v0, r0, ok0 = self._chol_qr2(
            bl, torch.zeros((), dtype=real_dtype(dt), device=dev), tol)
        v_curr = torch.where(ok0, v0, torch.zeros_like(v0))
        v_prev = torch.zeros_like(v_curr)
        b_prev = torch.zeros((p, p), dtype=dt, device=dev)
        done = ~ok0
        steps = torch.zeros((), dtype=torch.int32, device=dev)
        a_blocks = torch.zeros((k, p, p), dtype=dt, device=dev)
        b_blocks = torch.zeros((k, p, p), dtype=dt, device=dev)
        basis = torch.zeros((k,) + tuple(bl.shape), dtype=dt, device=dev)
        for j in range(k):
            executed = ~done
            w, a_j = _block_recurrence_body(block_mv, v_prev, v_curr, b_prev,
                                            self._fold)
            v_next, b_j, ok = self._chol_qr2(
                w, a_j.diagonal().abs().max(), tol)
            advance = executed & ok
            a_blocks[j] = torch.where(executed, a_j, torch.zeros_like(a_j))
            b_blocks[j] = torch.where(advance, b_j, torch.zeros_like(b_j))
            basis[j] = torch.where(executed, v_curr,
                                   torch.zeros_like(v_curr))
            v_prev = torch.where(advance, v_curr, v_prev)
            v_curr = torch.where(advance, v_next, v_curr)
            b_prev = torch.where(advance, b_j, b_prev)
            done = done | ~ok
            steps = steps + executed.to(torch.int32)
        decomp = BlockDecomposition(
            a_blocks=a_blocks, b_blocks=b_blocks,
            r0=torch.where(ok0, r0, torch.zeros_like(r0)), steps_taken=steps)
        s = int(steps)
        self._last_block_steps = s
        if s == 0:  # a zero or rank-deficient B: zeros
            return (torch.zeros_like(bl) if raw
                    else torch.zeros((n, p), dtype=dt).numpy())
        y = torch.from_numpy(host_f_e1_r0(decomp, f, k)).to(device=dev,
                                                            dtype=dt)
        x = _contract(basis, y, s)
        return x if raw else self._restore_x(x.T).T

    def estimate_interval(self, *, margin: float = 0.05, tol: float = 1e-3,
                          key=None):
        """Spectral interval [a, b] ⊇ spec(A) from two 1-eigenpair runs of
        the distributed :meth:`eigsh` (LA, then SA, on one generator from
        ``key``, seed 0 by default), widened by the residual norms plus
        ``margin``: :func:`algorithms.chebyshev.estimate_interval` on the
        row partition, with the same widening."""
        gen = cpu_generator(0 if key is None else key)
        ncv = min(20, self.part.n_orig)
        hi = self.eigsh(nev=1, which="LA", tol=tol, ncv=ncv, key=gen,
                        _restore_vectors=False)
        lo = self.eigsh(nev=1, which="SA", tol=tol, ncv=ncv, key=gen,
                        _restore_vectors=False)
        return interval_from_extremes(hi, lo, margin)

    def chebyshev_fAb(self, b, f, *, degree: int = 100, interval=None,
                      raw: bool = False):
        """Distributed Chebyshev-expansion f(A)·b: ``degree`` distributed
        SpMVs, O(n/D) memory a rank and no collective beyond the SpMV's own
        gather (the recurrence has no inner product). ``interval`` must
        hold spec(A); ``None`` takes :meth:`estimate_interval`. The padded
        rows stay zero through the recurrence. Returns the NumPy (n,) x on
        every rank, or this rank's shard with ``raw=True``."""
        if interval is None:
            interval = self.estimate_interval()
        a_lo, a_hi = float(interval[0]), float(interval[1])
        validate_interval_for_f(f, a_lo, a_hi)
        cs = torch.as_tensor(chebyshev_coefficients(f, interval, degree),
                             dtype=self.dtype, device=self.device)
        scale = torch.tensor(
            [2.0 / (a_hi - a_lo), (a_hi + a_lo) / (a_hi - a_lo)],
            dtype=self.dtype, device=self.device)
        y = chebyshev_scan(self._matvec, self._prepare_b(b), cs, scale)
        return y if raw else self._restore_x(y)
