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

On CPU tensors (a gloo mesh) the recurrence is ``algorithms/core.py``'s
(``pass_one_chunk_scan``, whose chained chunks are bitwise one
``pass_one_scan``, and ``pass_two_scan``) over that matvec and dot, with
K7's plain version ``ops/kkt_fused.kkt_shard_matvec``; a CUDA shard never
runs it. The solver picks its passes once, at construction: the scans or
the fused step, each with ``start``, ``pass_one`` and ``pass_two``.

* **On a card, the fused step** (``parallel/sharded_step.py``): a step of
  pass one is K7's pass-one instance, whose arc threads go on from y_a to
  w_a and ⟨v_a, w_a⟩'s block partials, and one hand-written kernel after
  each of its three folds (w_n and α's parts; w −= α·v and β²'s partials,
  then their sum; β, the breakdown test, v_next and the masked state): five
  kernels and three all-gathers, where the scans issued ~36 operations. A
  step of pass two is K7's pass-two instance, which updates v_a and x_a
  from the stored α_j, β_j, one fold and one node kernel. The collectives
  are the scans', call for call; the vectors round as the scans' operations
  do, and only the dots sum in a new (fixed) order. Every card pass takes
  it: the solve's, the chunked pass one of the callback path (chunks
  bitwise the monolithic pass), the basis pass of one-pass and the SLQ
  methods' passes. The breakdown flag, α and β stay on the device, so a
  k-step pass queues its work with no host sync (NCCL collectives are
  stream-ordered); only the callback path reads back, once per chunk.

* **Each pass one CUDA graph.** Issued one at a time, even the fused
  step's eight operations leave the host to set the pace. So on a CUDA
  mesh a two-pass :meth:`ShardedFusedKKTSolver.solve` without a callback
  replays two captured graphs: pass one (every step's kernels and
  all-gathers) and pass two. f(T_k)·e₁ (``scaled_y``, which waits
  on the host twice) runs between them, eagerly. The graphs are cached on
  the solver by ``(k, number of f rows)`` and captured at first use, after
  one eager solve has set up NCCL's communicators; every rank makes the
  same calls, so every rank captures the same sequence. Their inputs are
  static buffers: :meth:`ShardedFusedKKTSolver.pack` writes b into the one
  both passes read, and pass one's decomposition (α, β, steps taken, ‖b‖)
  and f(T_k)·e₁'s y are copied into pass two's; the caller gets copies of
  the outputs. A pair of graphs shares one private memory pool, which holds
  the passes' vectors and which the allocator's peak does not count
  (``torch.cuda.memory_reserved`` does). The arithmetic is the eager
  solve's, kernel for kernel, so a replay is bitwise the eager solve on
  every rank. A replay adds to ``LAUNCHES``, ``sharded_step.STEP_KERNELS``,
  ``comm.COLLECTIVES`` and the open ``record_collectives`` logs what its
  capture recorded, which the capture itself does not count: it runs
  nothing. The CPU path, the callback path, one-pass and the capability
  methods run eagerly. NCCL does not destroy a communicator while a graph
  that holds its collectives lives, so ``destroy_process_group`` waits
  until the solver is freed or :meth:`ShardedFusedKKTSolver.release_graphs`
  has run.

The capability methods run on the same matvec and folds: the SLQ
methods one sharded pass one a probe (on a card the fused step; each
probe's α and β bitwise a solve's pass one on it), ``chebyshev_fAb`` the
expansion on the packed local vector (``degree`` plain K7 launches and
node folds, no inner product) and ``estimate_interval`` eigsh on the f32
``make_kkt_operator`` of the whole instance on this rank's device (K8 on
a card), cached.

Not ported: the TPU layout (per-shard dual sorted orderings padded to a
common R, a common windowed-gather width with re-clamped windows, arrays
stacked per device and placed by ``make_array_from_callback``), which VMEM,
the lanes and the lack of a gather forced; and ``interpret``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from two_pass_lanczos_tpu_torch import slq
from two_pass_lanczos_tpu_torch.algorithms.chebyshev import (
    chebyshev_coefficients,
    chebyshev_scan,
    estimate_interval,
    validate_interval_for_f,
)
from two_pass_lanczos_tpu_torch.algorithms.core import (
    ChunkCarry,
    LanczosDecomposition,
    _start,
    basis_product,
    breakdown_tolerance,
    pass_one_chunk_scan,
    pass_two_scan,
    zero_tolerance,
)
from two_pass_lanczos_tpu_torch.observability import trace
from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
    LAUNCHES,
    KKTLayout,
    kkt_shard_matvec,
    kkt_shard_matvec_cuda,
    run_chunks,
    scaled_y,
)
from two_pass_lanczos_tpu_torch.parallel.comm import (
    COLLECTIVES,
    all_gather_arcs,
    gather_fold,
)
from two_pass_lanczos_tpu_torch.parallel.mesh import Mesh
from two_pass_lanczos_tpu_torch.parallel.sharded_step import (
    STEP_KERNELS,
    ShardStep,
)
from two_pass_lanczos_tpu_torch.utils.collectives import (
    report_again,
    set_aside,
)

__all__ = ["ShardedFusedKKTSolver", "STEP_KERNELS"]


def split_arcs(m: int, mesh: Mesh):
    """The JAX package's arc split over the mesh and this rank's share."""
    if m < mesh.size:
        raise ValueError(f"{m} arcs cannot be split over {mesh.size} ranks")
    arc_idx = np.array_split(np.arange(m, dtype=np.int64), mesh.size)
    return arc_idx, arc_idx[mesh.rank]


class _ScanPasses:
    """The passes on CPU tensors (a gloo mesh) with :class:`ShardStep`'s
    ``start``, ``pass_one`` and ``pass_two``: ``algorithms/core.py``'s
    scans over the solver's matvec and dot. Its carry is the scans'
    ``ChunkCarry``; chained chunks are bitwise one ``pass_one_scan``."""

    def __init__(self, matvec, dot):
        self.matvec, self.dot = matvec, dot

    def start(self, b: torch.Tensor) -> ChunkCarry:
        return _start(b, self.dot)

    def pass_one(self, carry: ChunkCarry, count: int, k_limit: int,
                 alphas: torch.Tensor, betas: torch.Tensor,
                 basis: Optional[torch.Tensor] = None) -> ChunkCarry:
        # the scan takes its dtype and device from the vector it is given
        a, b, carry = pass_one_chunk_scan(self.matvec, carry.v_curr, count,
                                          carry, k_limit, dot=self.dot,
                                          basis=basis)
        alphas.copy_(a)
        betas.copy_(b)
        return carry

    def pass_two(self, b: torch.Tensor, decomp: LanczosDecomposition,
                 y: torch.Tensor):
        state = torch.empty((2,) + tuple(b.shape), dtype=b.dtype)
        x, _ = pass_two_scan(self.matvec, b, decomp, y, state=state)
        return x, state[0], state[1]


class _Captured:
    """One pass captured as a CUDA graph (``run()`` its work, its result
    ``out``), with what the capture recorded: the kernel launches
    (``LAUNCHES`` and :data:`STEP_KERNELS`), the collectives and the calls
    of the open ``record_collectives`` logs. The
    capture counts none of them, since it runs nothing on the device; each
    :meth:`replay` adds them, as the eager pass would."""

    #: the counters a capture records and a replay adds to
    COUNTERS = (LAUNCHES, STEP_KERNELS, COLLECTIVES)

    def __init__(self, run: Callable[[], object], pool=None):
        self.graph = torch.cuda.CUDAGraph()
        before = [dict(c) for c in self.COUNTERS]
        try:
            with set_aside() as self.log:
                # thread-local: NCCL's watchdog thread queries its events
                # while this thread captures
                with torch.cuda.graph(self.graph, pool=pool,
                                      capture_error_mode="thread_local"):
                    self.out = run()
            self.counts = [{k: c[k] - b[k] for k in c}
                           for c, b in zip(self.COUNTERS, before)]
        finally:
            for c, b in zip(self.COUNTERS, before):
                c.update(b)

    def replay(self) -> None:
        self.graph.replay()
        for c, added in zip(self.COUNTERS, self.counts):
            for k, n in added.items():
                c[k] += n
        report_again(self.log)


class _TwoPassGraphs:
    """The two graphs of a two-pass solve at one ``(k, nf)``: pass one
    from the solver's static b, pass two from the same b and its own
    static decomposition and y, sharing one memory pool (pass two always
    replays after pass one)."""

    def __init__(self, solver: "ShardedFusedKKTSolver", k: int, nf: int):
        dev, b = solver.device, solver._static_b
        f32 = dict(dtype=torch.float32, device=dev)
        self.decomp = LanczosDecomposition(
            alphas=torch.zeros(k, **f32), betas=torch.zeros(k, **f32),
            steps_taken=torch.zeros((), dtype=torch.int32, device=dev),
            b_norm=torch.zeros((), **f32))
        self.y = torch.zeros((k,) if nf == 0 else (nf, k), **f32)
        self.one = _Captured(lambda: solver.pass_one(b, k))
        self.two = _Captured(lambda: solver.pass_two(b, self.decomp, self.y),
                             pool=self.one.graph.pool())


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
        # the passes: the fused step on a card, the core scans on the CPU
        self._passes = (
            ShardStep(self.layout, mesh, self.tol, self.ztol, self._dot)
            if self._cuda else _ScanPasses(self._matvec, self._dot))
        # the whole instance on the host, for estimate_interval's operator,
        # and its cache
        self._kkt_arrays = (d.astype(np.float32), u, v, self.p)
        self._interval_cache = None
        # the CUDA graphs of the two-pass solve by (k, f rows; 0 for one
        # spec), their static b, and whether an eager solve has run (and
        # so set up NCCL's communicators)
        self._graphs: Dict[Tuple[int, int], _TwoPassGraphs] = {}
        self._static_b: Optional[torch.Tensor] = None
        self._warm = False

    @property
    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    # -- packing ----------------------------------------------------------
    def pack(self, b, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The local ``(m_d + p,)`` f32 right-hand side on this rank's
        device, ``[b_a of the shard, b_n]``, from an (n,) b (NumPy, or a
        tensor anywhere). An ``(m_d + p,)`` f32 tensor already on the device
        is the pre-packed b, used in place; with ``out`` (the graphs'
        static b) b is written into ``out``, which is returned."""
        if (isinstance(b, torch.Tensor) and b.device == self.device
                and b.dtype == torch.float32
                and tuple(b.shape) == (self.n_local,) and b.is_contiguous()):
            return b if out is None else out.copy_(b)
        t = b if isinstance(b, torch.Tensor) else torch.from_numpy(
            np.asarray(b, np.float32))
        if tuple(t.shape) != (self.n,):
            raise ValueError(f"b must have shape ({self.n},) or be packed "
                             f"({self.n_local},), got {tuple(t.shape)}")
        t = t.to(device=self.device, dtype=torch.float32)
        a0 = self._arc0
        return torch.cat([t[a0:a0 + self.m_d], t[self.m:]], out=out)

    def gather_x(self, x) -> torch.Tensor:
        """The full (n,) — or (nf, n) — f32 x on this rank's device, from
        the local one (``(..., m_d + p)``, or the ``(x_a of the shard,
        x_n)`` pair of ``solve(raw=True)``): one all-gather of the arc
        shards (each padded to the largest) and the replicated node
        block."""
        with trace("tpl.gather_x"):
            xa, xn = x if isinstance(x, tuple) else (x[..., :self.m_d],
                                                     x[..., self.m_d:])
            return torch.cat(
                [all_gather_arcs(xa, self.shard_sizes, self.mesh), xn],
                dim=-1)

    def unpack(self, x) -> np.ndarray:
        """:meth:`gather_x` as NumPy on the host."""
        return self.gather_x(x).cpu().numpy()

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
    def _pass_one(self, b: torch.Tensor, k: int,
                  basis: Optional[torch.Tensor] = None):
        """Pass one from the packed b: the decomposition and the final
        carry."""
        if k < 1:
            raise ValueError("k must be >= 1")
        f32 = dict(dtype=torch.float32, device=self.device)
        alphas, betas = torch.empty(k, **f32), torch.empty(k, **f32)
        carry = self._passes.pass_one(self._passes.start(b), k, k, alphas,
                                      betas, basis)
        return LanczosDecomposition(alphas, betas, carry.steps,
                                    carry.b_norm), carry

    def pass_one(self, b, k: int, state: Optional[torch.Tensor] = None
                 ) -> LanczosDecomposition:
        """Pass one over the mesh; a ``(2, m_d + p)`` ``state`` receives
        this rank's final ``(v_prev, v_curr)``."""
        dec, carry = self._pass_one(self.pack(b), k)
        if state is not None:
            state[0].copy_(carry.v_prev)
            state[1].copy_(carry.v_curr)
        return dec

    def pass_one_with_basis(self, b, k: int
                            ) -> Tuple[LanczosDecomposition, torch.Tensor]:
        """Pass one that keeps this rank's ``(k, m_d + p)`` basis slab."""
        basis = torch.empty((k, self.n_local), dtype=torch.float32,
                            device=self.device)
        return self._pass_one(self.pack(b), k, basis)[0], basis

    def pass_two(self, b, decomp: LanczosDecomposition, y_full,
                 state: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Pass two over the mesh: this rank's local x for a ``(k,)`` or
        ``(nf, k)`` y (zero beyond ``steps_taken``, scaled by ‖b‖);
        ``state`` receives the final ``(v_prev, v_curr)``."""
        y_full = torch.as_tensor(y_full, dtype=torch.float32,
                                 device=self.device)
        k = decomp.k_max
        if y_full.dim() not in (1, 2) or y_full.shape[-1] != k:
            raise ValueError(f"y_full must be (k,) or (nf, k) with k={k}")
        x, v_prev, v_curr = self._passes.pass_two(
            self.pack(b), decomp, y_full.reshape(-1, k).contiguous())
        if state is not None:
            state[0].copy_(v_prev)
            state[1].copy_(v_curr)
        return x if y_full.dim() == 2 else x[0]

    def one_pass_basis_bytes(self, k: int) -> int:
        """Per-rank device bytes of the one-pass basis slab."""
        return k * (max(self.shard_sizes) + self.p) * 4

    def pass_one_chunked(self, packed, k: int, callback=None,
                         chunk: int = 16):
        """Pass one over the mesh with a live per-iteration callback — the
        reference's in-loop ``LanczosCallback`` break-out on the distributed
        path. ``packed`` is b, packed or not.

        Runs ceil(k/chunk) chunks of the passes' ``pass_one`` (the
        monolithic pass's step, so α and β are bitwise its own); after each, one
        readback brings the chunk's α, β, ``steps`` and breakdown flag to
        the host, and ``callback(s, None, (alphas[:s], betas[:s-1]))`` is
        replayed for every new step s. A stop at step s costs at most
        ceil(s/chunk)·chunk matvecs. Returns ``(decomposition, stopped)``.
        """
        b = self.pack(packed)
        carry = None

        def next_steps(c):
            """The next ``c`` steps: their α, β, and (steps, done, ‖b‖)."""
            nonlocal carry
            if carry is None:
                carry = self._passes.start(b)
            f32 = dict(dtype=torch.float32, device=self.device)
            a_c, b_c = torch.empty(c, **f32), torch.empty(c, **f32)
            carry = self._passes.pass_one(carry, c, k, a_c, b_c)
            return a_c, b_c, torch.stack([
                carry.steps.float(), carry.done.float(), carry.b_norm])

        def run(j0, c):
            host = torch.cat(next_steps(c)).cpu().numpy()
            return (host[:c], host[c:2 * c], int(host[2 * c]),
                    not host[2 * c + 1], host[2 * c + 2])

        decomp, stopped, self._last_p1_launches = run_chunks(
            run, k, chunk, callback, self.device)
        return decomp, stopped

    # -- solve ------------------------------------------------------------
    def _graph_two_pass(self, b, k: int, f
                        ) -> Tuple[torch.Tensor, LanczosDecomposition]:
        """The two-pass solve by the graphs of ``(k, f rows)``, captured
        here at their first use: this rank's local x and the
        decomposition, copies of the graphs' outputs."""
        if self._static_b is None:
            self._static_b = torch.empty(self.n_local, dtype=torch.float32,
                                         device=self.device)
        key = (k, len(f) if isinstance(f, tuple) else 0)
        if key not in self._graphs:
            self._graphs[key] = _TwoPassGraphs(self, k, key[1])
        g = self._graphs[key]
        self.pack(b, out=self._static_b)
        with trace("tpl.pass_one"):
            g.one.replay()
            out = g.one.out
            decomp = LanczosDecomposition(
                alphas=out.alphas.clone(), betas=out.betas.clone(),
                steps_taken=out.steps_taken.clone(),
                b_norm=out.b_norm.clone())
        y_full = scaled_y(decomp, f, k)
        with trace("tpl.pass_two"):
            for into, src in zip(
                    (g.decomp.alphas, g.decomp.betas, g.decomp.steps_taken,
                     g.decomp.b_norm, g.y),
                    (decomp.alphas, decomp.betas, decomp.steps_taken,
                     decomp.b_norm, y_full)):
                into.copy_(src)
            g.two.replay()
            x = g.two.out.clone()
        return x, decomp

    def release_graphs(self) -> None:
        """Free the two-pass solve's CUDA graphs and their memory; a later
        solve captures them again. Call it (or free the solver) before
        ``destroy_process_group``."""
        self._graphs.clear()

    def solve(self, b, *, k: int, f="inv", method: str = "two_pass",
              raw: bool = False, callback=None, callback_chunk: int = 16):
        """Distributed f(A)·b, ``method`` ∈ {"two_pass", "one_pass"}.

        Returns ``(x, decomposition)``: x the full NumPy (n,) array on every
        rank (:meth:`unpack`), or with ``raw=True`` this rank's ``(x_a of
        the shard, x_n)`` device pair, with no collective (:meth:`gather_x`
        gathers the whole x on the device). ``b`` is an (n,) vector or the
        packed local tensor (:meth:`pack`). ``f`` may be a tuple of function
        specs (x gains a leading nf axis). On a CUDA mesh a two-pass solve
        without ``callback`` replays the passes' CUDA graphs (the module
        docstring), after one eager solve. ``method="one_pass"`` stores this
        rank's basis slab (admitted against ``ONE_PASS_HBM_BUDGET``) and
        forms x = V_k·y in full f32. ``callback`` (two_pass only) runs pass
        one by :meth:`pass_one_chunked` in ``callback_chunk``-step chunks; a
        stop at step s runs a pass two of s steps, so the solve pays at most
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
        with trace("tpl.solve"):
            if (self._cuda and self._warm and callback is None
                    and method == "two_pass"):
                x, decomp = self._graph_two_pass(b, k, f)
            else:
                x, decomp = self._eager_solve(b, k, f, method, callback,
                                              callback_chunk)
                self._warm = True
            if raw:
                return (x[..., :self.m_d], x[..., self.m_d:]), decomp
            return self.unpack(x), decomp

    def _eager_solve(self, b, k: int, f, method: str, callback,
                     callback_chunk: int
                     ) -> Tuple[torch.Tensor, LanczosDecomposition]:
        """:meth:`solve`'s work one operation at a time: this rank's local
        x and the decomposition."""
        b = self.pack(b)
        basis = None
        with trace("tpl.pass_one"):
            if callback is not None:
                decomp, _ = self.pass_one_chunked(b, k, callback,
                                                  callback_chunk)
            elif method == "one_pass":
                decomp, basis = self.pass_one_with_basis(b, k)
            else:
                decomp = self.pass_one(b, k)
        y_full = scaled_y(decomp, f, k)
        if basis is not None:
            with trace("tpl.basis_product"):
                return basis_product(y_full, basis), decomp
        if callback is not None:
            k2 = max(decomp.steps(), 1)
            self._last_p2_len = k2
            y_full = y_full[..., :k2]
            decomp_p2 = LanczosDecomposition(
                alphas=decomp.alphas[:k2], betas=decomp.betas[:k2],
                steps_taken=decomp.steps_taken, b_norm=decomp.b_norm)
        else:
            decomp_p2 = decomp
        with trace("tpl.pass_two"):
            return self.pass_two(b, decomp_p2, y_full), decomp

    # -- capability methods --------------------------------------------------
    def _slq_pass_one(self, probes, k: int) -> LanczosDecomposition:
        """:meth:`pass_one` for each row of the (m, n) probes, one after
        another: the sharded recurrence of :meth:`solve` on K7 and the node
        fold, so each probe's α and β are bitwise a solve's pass one on it.
        Returns the stacked decomposition, the same bits on every rank."""
        if k < 1:
            raise ValueError("k must be >= 1")
        z = torch.as_tensor(probes).to(device=self.device,
                                       dtype=torch.float32)
        if z.dim() != 2 or z.shape[1] != self.n:
            raise ValueError(f"probes must be (m, {self.n}), got "
                             f"{tuple(z.shape)}")
        return slq.stack_decompositions([self.pass_one(row, k) for row in z])

    def slq_trace(self, f="inv", *, k: int = 50, num_probes: int = 16,
                  key, probe: str = "rademacher") -> slq.SLQResult:
        """``tr f(A)`` by stochastic Lanczos quadrature over the arc
        partition: the probes drawn from ``key`` (a CPU ``torch.Generator``
        or an ``int`` seed) as ``FusedKKTSolver.slq_trace`` draws them, each
        probe's pass one by :meth:`_slq_pass_one`, all quadratures one
        batched ``eigh`` on the device."""
        if num_probes < 1:
            raise ValueError("num_probes must be >= 1")
        if not callable(f):
            slq._f_of_theta(torch.ones(1), f)  # reject unknown strings first
        probes = slq._draw_probes(key, num_probes, self.n, torch.float32,
                                  probe)
        decomp = self._slq_pass_one(probes, k)
        return slq.slq_stats(slq.batched_quadratic_form(decomp, f))

    def slq_spectral_density(self, grid, *, sigma=None, k: int = 50,
                             num_probes: int = 16, key,
                             probe: str = "gaussian") -> torch.Tensor:
        """Smoothed spectral density over the arc partition: the unit
        probes' pass one by :meth:`_slq_pass_one`, the density by
        :func:`slq.dos_from_decomposition` on the replicated decomposition.
        A tensor on this rank's device."""
        grid, sigma = slq.validate_dos_params(grid, sigma, num_probes)
        probes = slq._draw_probes(key, num_probes, self.n, torch.float32,
                                  probe)
        probes = probes / torch.linalg.norm(probes, dim=1, keepdim=True)
        return slq.dos_from_decomposition(self._slq_pass_one(probes, k),
                                          grid, sigma)

    def slq_trace_adaptive(self, f="inv", *, k: int = 50, key,
                           probe: str = "rademacher",
                           target_rel_stderr: float = 0.01,
                           batch: int = 8, max_probes: int = 512
                           ) -> slq.SLQResult:
        """:meth:`slq_trace` with the probe count chosen by the shared
        :func:`slq.adaptive_probe_loop`: ``batch`` probes a round over the
        arc partition until the sample standard error certifies
        ``target_rel_stderr`` (or ``max_probes``)."""
        return slq.adaptive_probe_loop(
            lambda gen, take: self.slq_trace(
                f, k=k, num_probes=take, key=gen, probe=probe).samples,
            key, batch=batch, max_probes=max_probes,
            target_rel_stderr=target_rel_stderr)

    def estimate_interval(self, *, margin: float = 0.05, tol: float = 1e-3,
                          key=None):
        """Cached spec(A) interval: :func:`algorithms.chebyshev
        .estimate_interval` (two 1-eigenpair ``eigsh`` runs) on the f32
        ``make_kkt_operator`` of the whole instance on this rank's device,
        whose matvec is K8 on a card (the interval is a property of A; the
        operator is ~12 bytes an arc). Every rank computes the same
        interval. Computed once; later calls return the same object."""
        if self._interval_cache is None:
            from two_pass_lanczos_tpu_torch.operators import make_kkt_operator

            d, u, v, p = self._kkt_arrays
            op = make_kkt_operator(d, u, v, p, dtype=torch.float32,
                                   device=self.device)
            self._interval_cache = estimate_interval(
                op, margin=margin, tol=tol, key=key)
        return self._interval_cache

    def chebyshev_fAb(self, b, f, *, degree: int = 100, interval=None,
                      raw: bool = False):
        """Storage-free Chebyshev f(A)·b over the arc partition
        (:func:`algorithms.chebyshev.chebyshev_scan` on the packed local
        vector): ``degree`` K7 launches and node folds, the updates
        elementwise on the replicated node block, no inner product.
        ``interval`` must hold spec(A); ``None`` takes
        :meth:`estimate_interval` (cached). Returns the full NumPy (n,) y
        on every rank, or with ``raw=True`` this rank's ``(y_a of the
        shard, y_n)`` device pair."""
        if interval is None:
            interval = self.estimate_interval()
        a_lo, a_hi = float(interval[0]), float(interval[1])
        validate_interval_for_f(f, a_lo, a_hi)
        cs = torch.as_tensor(chebyshev_coefficients(f, interval, degree),
                             dtype=torch.float32, device=self.device)
        scale = torch.tensor(
            [2.0 / (a_hi - a_lo), (a_hi + a_lo) / (a_hi - a_lo)],
            dtype=torch.float32, device=self.device)
        y = chebyshev_scan(self._matvec, self.pack(b), cs, scale)
        if raw:
            return y[:self.m_d], y[self.m_d:]
        return self.unpack(y)
