"""Arc-sharded distributed f(A)·b on the hand-written shard matvec (K7).

Counterpart of ``two_pass_lanczos_tpu/parallel/fused_sharded.py`` on
``torch.distributed``: one process per device, a :class:`Mesh` of D ranks.

* **Shard the arc block, replicate the node block.** Rank r owns the
  contiguous arcs ``np.array_split(np.arange(m), D)[r]`` (the JAX package's
  split) in the f32 solver's Hopper layout over the *global* node ids
  (``ops/kkt_fused.KKTLayout`` of its arcs); its local vector is
  ``[x_a of its arcs (m_d), x_n (p)]``.
* **Per step, O(p) bytes.** Each rank runs K7 over its arcs: the arc
  outputs are local and the node output is the shard's partial of E·x_a,
  which ``parallel/comm.gather_fold`` gathers as a (D, p) buffer and sums
  in rank order. A dot gathers its (D,) arc partials the same way and adds
  the node block's part, which every rank holds bit for bit. The JAX solver
  used ``lax.psum`` for both; the rank-ordered fold keeps the node block
  and α, β bitwise equal on every rank whatever NCCL's algorithm.

The recurrence is ``algorithms/core.py``'s (``pass_one_scan``,
``pass_one_chunk_scan``, ``pass_two_scan``) over that matvec and dot:
eager PyTorch around K7 and the collectives, with the breakdown flag, α and
β kept on the device, so a k-step pass queues its work with no host sync
(NCCL collectives are stream-ordered); only the callback path reads back,
once per chunk. On CPU tensors (a gloo mesh) K7's plain version
``ops/kkt_fused.kkt_shard_matvec`` runs instead; a CUDA shard never runs it.

Not ported: the TPU layout (per-shard dual sorted orderings padded to a
common R, a common windowed-gather width with re-clamped windows, arrays
stacked per device and placed by ``make_array_from_callback``), which VMEM,
the lanes and the lack of a gather forced; ``interpret``; and the
capability methods (``slq_*``, ``estimate_interval``, ``chebyshev_fAb``),
which raise ``NotImplementedError`` until ROADMAP Queue 1 item 2.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.algorithms.core import (
    LanczosDecomposition,
    basis_product,
    breakdown_tolerance,
    pass_one_chunk_scan,
    pass_one_scan,
    pass_two_scan,
    zero_tolerance,
)
from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
    KKTLayout,
    kkt_shard_matvec,
    kkt_shard_matvec_cuda,
    run_chunks,
    scaled_y,
)
from two_pass_lanczos_tpu_torch.parallel.comm import (
    all_gather_arcs,
    gather_fold,
)
from two_pass_lanczos_tpu_torch.parallel.mesh import Mesh

__all__ = ["ShardedFusedKKTSolver"]

_CAPABILITY = ("{} is not ported yet: the capability layer comes with "
               "ROADMAP Queue 1 item 2")


def split_arcs(m: int, mesh: Mesh):
    """The JAX package's arc split over the mesh and this rank's share."""
    if m < mesh.size:
        raise ValueError(f"{m} arcs cannot be split over {mesh.size} ranks")
    arc_idx = np.array_split(np.arange(m, dtype=np.int64), mesh.size)
    return arc_idx, arc_idx[mesh.rank]


class ShardedFusedKKTSolver:
    """Distributed fused f(A)·b for one KKT instance over a 1-D mesh.

    Usage, in every rank of the run::

        mesh = make_mesh()                       # NCCL, one card per rank
        s = ShardedFusedKKTSolver(d, u, v, p, mesh)
        x, decomp = s.solve(b, k=500, f="inv")   # NumPy (n,) on every rank
    """

    #: per-rank admission for the one-pass basis (k·(m_d + p)·4 bytes): an
    #: H100 holds 80 GB; 64 GiB (68.7 GB) leaves ~11 GB for the shard's
    #: layout, the solver's vectors, the allocator's cache and NCCL's
    #: buffers (the JAX package admitted 12 GiB of a 16 GB TPU v5e)
    ONE_PASS_HBM_BUDGET = 64 * 2**30

    def __init__(self, quad_costs, arc_u, arc_v, num_nodes, mesh: Mesh):
        self.mesh = mesh
        self.device = mesh.device
        d = np.asarray(quad_costs)
        u = np.asarray(arc_u)
        v = np.asarray(arc_v)
        self.m, self.p = len(d), int(num_nodes)
        self.n = self.m + self.p
        self.arc_idx, ix = split_arcs(self.m, mesh)
        self.shard_sizes = [len(i) for i in self.arc_idx]
        self._arc0 = int(ix[0])
        # this rank's shard only, over the global node ids
        self.layout = KKTLayout.build(d[ix], u[ix], v[ix], self.p,
                                      self.device)
        self.m_d = self.layout.m
        self.n_local = self.layout.n
        self.tol = breakdown_tolerance(torch.float32)
        self.ztol = zero_tolerance(torch.float32)

    @property
    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    # -- packing ----------------------------------------------------------
    def pack(self, b) -> torch.Tensor:
        """The local ``(m_d + p,)`` f32 right-hand side on this rank's
        device, ``[b_a of the shard, b_n]``, from an (n,) b (NumPy, or a
        tensor anywhere). An ``(m_d + p,)`` f32 tensor already on the device
        is the pre-packed b, used in place."""
        if (isinstance(b, torch.Tensor) and b.device == self.device
                and b.dtype == torch.float32
                and tuple(b.shape) == (self.n_local,) and b.is_contiguous()):
            return b
        t = b if isinstance(b, torch.Tensor) else torch.from_numpy(
            np.asarray(b, np.float32))
        if tuple(t.shape) != (self.n,):
            raise ValueError(f"b must have shape ({self.n},) or be packed "
                             f"({self.n_local},), got {tuple(t.shape)}")
        t = t.to(device=self.device, dtype=torch.float32)
        a0 = self._arc0
        return torch.cat([t[a0:a0 + self.m_d], t[self.m:]])

    def unpack(self, x: torch.Tensor) -> np.ndarray:
        """The full (n,) — or (nf, n) — x as NumPy on every rank, from the
        local one: one all-gather of the arc shards (each padded to the
        largest) and the replicated node block."""
        xa = all_gather_arcs(x[..., :self.m_d], self.shard_sizes, self.mesh)
        return torch.cat([xa, x[..., self.m_d:]], dim=-1).cpu().numpy()

    # -- the per-step collectives -----------------------------------------
    def _matvec(self, x: torch.Tensor) -> torch.Tensor:
        """The local part of A·x: K7 (its plain version on the CPU), then
        the node partials folded across ranks in place of y_n."""
        if self._cuda:
            y = kkt_shard_matvec_cuda(self.layout, x)
        else:
            y = kkt_shard_matvec(self.layout, x)
        y[self.m_d:] = gather_fold(y[self.m_d:], self.mesh)
        return y

    def _dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """⟨a, b⟩ over the whole vector: the arc partials folded across
        ranks plus the replicated node block's part."""
        m = self.m_d
        return (gather_fold(torch.dot(a[:m], b[:m]), self.mesh)
                + torch.dot(a[m:], b[m:]))

    def matvec(self, x) -> np.ndarray:
        """One distributed y = A·x of an (n,) x; the full (n,) y on every
        rank (a testing hook, as in the JAX package)."""
        return self.unpack(self._matvec(self.pack(x)))

    # -- passes -----------------------------------------------------------
    def pass_one(self, b, k: int, state: Optional[torch.Tensor] = None
                 ) -> LanczosDecomposition:
        """Pass one over the mesh; a ``(2, m_d + p)`` ``state`` receives
        this rank's final ``(v_prev, v_curr)``."""
        dec, _ = pass_one_scan(self._matvec, self.pack(b), k, state=state,
                               dot=self._dot)
        return dec

    def pass_one_with_basis(self, b, k: int
                            ) -> Tuple[LanczosDecomposition, torch.Tensor]:
        """Pass one that keeps this rank's ``(k, m_d + p)`` basis slab."""
        return pass_one_scan(self._matvec, self.pack(b), k, emit_basis=True,
                             dot=self._dot)

    def pass_two(self, b, decomp: LanczosDecomposition, y_full,
                 state: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Pass two over the mesh: this rank's local x for a ``(k,)`` or
        ``(nf, k)`` y (zero beyond ``steps_taken``, scaled by ‖b‖)."""
        y_full = torch.as_tensor(y_full, dtype=torch.float32,
                                 device=self.device)
        x, _ = pass_two_scan(self._matvec, self.pack(b), decomp, y_full,
                             state=state)
        return x

    def one_pass_basis_bytes(self, k: int) -> int:
        """Per-rank device bytes of the one-pass basis slab."""
        return k * (max(self.shard_sizes) + self.p) * 4

    def pass_one_chunked(self, packed, k: int, callback=None,
                         chunk: int = 16):
        """Pass one over the mesh with a live per-iteration callback — the
        reference's in-loop ``LanczosCallback`` break-out on the distributed
        path. ``packed`` is b, packed or not.

        Runs ceil(k/chunk) chunks of ``pass_one_chunk_scan`` (the monolithic
        pass's step, so α and β are bitwise its own); after each, one
        readback brings the chunk's α, β, ``steps`` and breakdown flag to
        the host, and ``callback(s, None, (alphas[:s], betas[:s-1]))`` is
        replayed for every new step s. A stop at step s costs at most
        ceil(s/chunk)·chunk matvecs. Returns ``(decomposition, stopped)``.
        """
        b = self.pack(packed)
        carry = None

        def run(j0, c):
            nonlocal carry
            a_c, b_c, carry = pass_one_chunk_scan(self._matvec, b, c, carry, k,
                                                  dot=self._dot)
            host = torch.cat([a_c, b_c, carry.steps.float().reshape(1),
                              carry.done.float().reshape(1),
                              carry.b_norm.reshape(1)]).cpu().numpy()
            return (host[:c], host[c:2 * c], int(host[2 * c]),
                    not host[2 * c + 1], host[2 * c + 2])

        decomp, stopped, self._last_p1_launches = run_chunks(
            run, k, chunk, callback, self.device)
        return decomp, stopped

    # -- solve ------------------------------------------------------------
    def solve(self, b, *, k: int, f="inv", method: str = "two_pass",
              raw: bool = False, callback=None, callback_chunk: int = 16):
        """Distributed f(A)·b, ``method`` ∈ {"two_pass", "one_pass"}.

        Returns ``(x, decomposition)``: x the full NumPy (n,) array on every
        rank (one all-gather of the arc shards), or with ``raw=True`` this
        rank's ``(x_a of the shard, x_n)`` device pair, with no collective.
        ``b`` is an (n,) vector or the packed local tensor (:meth:`pack`),
        used in place. ``f`` may be a tuple of function specs (x gains a
        leading nf axis). ``method="one_pass"`` stores this rank's basis slab
        (admitted against ``ONE_PASS_HBM_BUDGET``) and forms x = V_k·y in
        full f32. ``callback`` (two_pass only) runs pass one by
        :meth:`pass_one_chunked` in ``callback_chunk``-step chunks; a stop
        at step s runs a pass two of s steps, so the solve pays at most
        ceil(s/chunk)·chunk + s matvecs instead of 2k.
        """
        if method not in ("two_pass", "one_pass"):
            raise ValueError("method must be 'two_pass' or 'one_pass'")
        if method == "one_pass":
            need = self.one_pass_basis_bytes(k)
            if need > self.ONE_PASS_HBM_BUDGET:
                raise ValueError(
                    f"one-pass basis slab needs {need} bytes of HBM per "
                    f"rank (k={k}, m_d + p = {max(self.shard_sizes) + self.p}"
                    f"), over the {self.ONE_PASS_HBM_BUDGET}-byte admission "
                    "budget; use method='two_pass' (O(n) memory) or more "
                    "ranks")
        if callback is not None and method != "two_pass":
            raise ValueError(
                "callback early stopping is implemented for the two_pass "
                "method")
        b = self.pack(b)
        if callback is not None:
            decomp, _ = self.pass_one_chunked(b, k, callback, callback_chunk)
            k2 = max(decomp.steps(), 1)
            self._last_p2_len = k2
            y_full = scaled_y(decomp, f, k)[..., :k2]
            short = LanczosDecomposition(
                alphas=decomp.alphas[:k2], betas=decomp.betas[:k2],
                steps_taken=decomp.steps_taken, b_norm=decomp.b_norm)
            x = self.pass_two(b, short, y_full)
        elif method == "one_pass":
            decomp, basis = self.pass_one_with_basis(b, k)
            x = basis_product(scaled_y(decomp, f, k), basis)
            del basis
        else:
            decomp = self.pass_one(b, k)
            x = self.pass_two(b, decomp, scaled_y(decomp, f, k))
        if raw:
            return (x[..., :self.m_d], x[..., self.m_d:]), decomp
        return self.unpack(x), decomp

    # -- not ported yet -----------------------------------------------------
    def slq_trace(self, *args, **kwargs):
        raise NotImplementedError(_CAPABILITY.format("slq_trace"))

    def slq_spectral_density(self, *args, **kwargs):
        raise NotImplementedError(_CAPABILITY.format("slq_spectral_density"))

    def slq_trace_adaptive(self, *args, **kwargs):
        raise NotImplementedError(_CAPABILITY.format("slq_trace_adaptive"))

    def estimate_interval(self, *args, **kwargs):
        raise NotImplementedError(_CAPABILITY.format("estimate_interval"))

    def chebyshev_fAb(self, *args, **kwargs):
        raise NotImplementedError(_CAPABILITY.format("chebyshev_fAb"))
