"""The fused Lanczos step of the arc-sharded f32 solver on a card.

:class:`ShardStep` runs the passes of ``parallel/fused_sharded.py``'s
:class:`ShardedFusedKKTSolver` on a CUDA mesh: K7's step instances
(``csrc/kkt_shard_matvec.cu``) and the kernels that follow each fold
(``csrc/shard_step.cu``; the step's outline in ``csrc/shard_step.cuh``).

* **Pass one, a step:** K7's pass-one instance (y = A·v, then w_a = y_a −
  β_prev·v_prev_a and the block partials of ⟨v_a, w_a⟩ in the thread that
  computed y_a), the node fold's all-gather, ``node_fold`` (w_n and the
  step's α parts), α's all-gather, ``orthogonalise`` (w −= α·v and β²'s
  block partials), ``norm``, β²'s all-gather, ``advance`` (β, the breakdown
  test, v_next and the masked state): five kernels and three gathers.
* **Pass two, a step:** K7's pass-two instance (the whole arc update from
  the stored α_j, β_j, and x_a += y_{j+1}·v_next_a), the node fold's
  all-gather and ``two_nodes`` (the node rows' update and x_n).

The collectives are those of ``algorithms/core.py``'s scans over the
solver's matvec and dot, call for call: ‖b‖'s, three a step of pass one
and one a step of pass two, all through ``parallel/comm.all_gather`` and
folded in rank order, so every rank holds the same bits. The vector
updates round as the scans' operations do (``csrc/lanczos_common.cuh``),
so given the same α and β the vectors are the scans'; the dots sum in a
fixed block tree instead of cuBLAS's order. No atomics: a run is
deterministic, chunked pass one is bitwise the monolithic one, and pass two
regenerates pass one's basis bit for bit.

Buffers: the three vectors rotate, step j reading v_prev from row j % 3 and
v from row (j + 1) % 3 of a ``(3, m_d + p)`` tensor (rows 16-byte aligned)
and writing w and then v_next into row (j + 2) % 3; the scalar state
(β_prev, done, steps, ‖b‖) alternates between the two rows of an int32
``(2, 4)`` tensor (the floats by their bits). A dot leaves 16 shares of its
arc part and of its node part; the arc shares are gathered as a ``(D,
16)`` buffer. All are allocated by each pass, so under the solver's CUDA
graphs they live in the graphs' pool. ``LAUNCHES["kkt_streaming_matvec"]``
counts K7's step instances, one a product as before; :data:`STEP_KERNELS`
counts the other launches.

:class:`CudaStepKernels` launches the kernels; :class:`PlainStepKernels` is
each one's plain version in PyTorch, with the same arguments, which the
CPU tests run the step's host side on and ``chip_smoke.py`` holds each
kernel to on the card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from two_pass_lanczos_tpu_torch.algorithms.core import LanczosDecomposition
from two_pass_lanczos_tpu_torch.ops._build import load_library
from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
    LAUNCHES,
    KKTLayout,
    _check,
    _layout_args,
    _ptr,
    _stream,
    kkt_shard_matvec,
)
from two_pass_lanczos_tpu_torch.parallel.comm import all_gather
from two_pass_lanczos_tpu_torch.parallel.mesh import Mesh

__all__ = ["STEP_KERNELS", "StepCarry", "ShardStep", "CudaStepKernels",
           "PlainStepKernels"]

#: launches of the fused step's kernels other than K7, by kernel
STEP_KERNELS = {"shard_step_node_fold": 0, "shard_step_orthogonalise": 0,
                "shard_step_norm": 0, "shard_step_advance": 0,
                "shard_step_two_nodes": 0}

#: arcs of one of K7's arc blocks (``tpl::kThreads``) and of one of
#: ``orthogonalise``'s blocks (``tpl::kQuadBlock``), each of which leaves
#: one block partial; the shares of a dot that ``node_fold`` and ``norm``
#: leave (``tpl::kFoldParts``), so four groups of scalars a step
_K7_ARCS, _QUAD_ARCS, _FOLD_PARTS = 256, 1024, 16
_NULL = ctypes.c_void_p(0)
_F32 = torch.float32
#: the entry points that are K7's step instances (counted in ``LAUNCHES``)
_K7_STEPS = ("one_matvec", "two_matvec")


class StepCarry(NamedTuple):
    """Pass one's state: the rotating ``(3, n)`` vectors, the ``(2, 4)``
    scalar slots and the steps run so far (a host int that names the rows
    the next step reads). Its properties are ``core.ChunkCarry``'s."""

    vectors: torch.Tensor
    state: torch.Tensor
    run: int

    @property
    def slot(self) -> torch.Tensor:
        """The int32 (4,) state the next step reads."""
        return self.state[self.run % 2]

    @property
    def v_prev(self) -> torch.Tensor:
        return self.vectors[self.run % 3]

    @property
    def v_curr(self) -> torch.Tensor:
        return self.vectors[(self.run + 1) % 3]

    @property
    def done(self) -> torch.Tensor:
        return self.slot[1]

    @property
    def steps(self) -> torch.Tensor:
        return self.slot[2]

    @property
    def b_norm(self) -> torch.Tensor:
        return self.slot.view(_F32)[3]


class CudaStepKernels:
    """The fused step's entry points on a card. ``kernels(name, *args)``
    launches ``tpl_shard_step_<name>`` on the current stream with the
    pointers of the tensors in ``args``, a :class:`KKTLayout`'s seven
    arguments in its place and a null pointer for ``None``."""

    def __init__(self):
        self._lib = None

    def __call__(self, name: str, *args) -> None:
        if self._lib is None:
            self._lib = load_library()
        flat = []
        for a in args:
            if isinstance(a, KKTLayout):
                flat.extend(_layout_args(a))
            elif isinstance(a, torch.Tensor):
                flat.append(_ptr(a))
            else:
                flat.append(_NULL if a is None else a)
        entry = getattr(self._lib, f"tpl_shard_step_{name}")
        _check(self._lib, entry(*flat, _stream()), f"shard_step_{name}")


class PlainStepKernels:
    """The plain version of each of the fused step's kernels, in PyTorch
    on the tensors themselves, with :class:`CudaStepKernels`'s arguments:
    the reference the card's kernels are held to. The vectors round as the
    kernels' do; the dots sum in PyTorch's order and leave a sum whole in
    the first of its 16 shares, so a share group's total, not each share,
    is the kernels'."""

    def __call__(self, name: str, *args) -> None:
        getattr(self, name)(*args)

    @staticmethod
    def _matvec(lay: KKTLayout, x: torch.Tensor):
        y = kkt_shard_matvec(lay, x)
        return y[:lay.m], y[lay.m:]

    @staticmethod
    def _executes(state: torch.Tensor, k_limit: int) -> bool:
        return not bool(state[1]) and int(state[2]) < k_limit

    def one_matvec(self, lay, v_prev, v_curr, w, s, partials, state):
        m = lay.m
        ya, s[:] = self._matvec(lay, v_curr)
        w[:m] = ya - _field(state, 0) * v_prev[:m]
        partials[:] = _block_sums(v_curr[:m] * w[:m], _K7_ARCS)

    def node_fold(self, g, ranks, m, p, v_prev, v, w, partials, parts,
                  state, scal):
        w[m:] = _fold(g, ranks) - _field(state, 0) * v_prev[m:]
        scal[0] = _shares(partials[:parts].sum())
        scal[1] = _shares(torch.dot(v[m:], w[m:]))

    def orthogonalise(self, g, ranks, m, p, v, w, partials, state, k_limit,
                      alpha, scal):
        a = _fold(g, ranks).sum() + scal[1].sum()
        w -= a * v
        quads = _block_sums(w[:m] * w[:m], _QUAD_ARCS)
        partials[:len(quads)] = quads
        alpha.fill_(a if self._executes(state, k_limit) else 0.0)

    def norm(self, m, p, w, partials, parts, scal):
        scal[2] = _shares(partials[:parts].sum())
        scal[3] = _shares(torch.dot(w[m:], w[m:]))

    def advance(self, g, ranks, m, p, v_prev, v, w, basis_row, state,
                next_state, k_limit, tol, beta, scal):
        b = torch.sqrt(_fold(g, ranks).sum() + scal[3].sum())
        executes = self._executes(state, k_limit)
        breakdown = bool(b <= tol)
        advance = executes and not breakdown
        if basis_row is not None:
            basis_row.copy_(v if executes else torch.zeros_like(v))
        if advance:
            w.mul_(1.0 / b)
        else:
            w.copy_(v)
            v.copy_(v_prev)
        _field(next_state, 0).copy_(b if advance else _field(state, 0))
        next_state[1] = int(state[1]) | int(executes and breakdown)
        next_state[2] = int(state[2]) + int(executes)
        _field(next_state, 3).copy_(_field(state, 3))
        beta.fill_(b if advance else 0.0)

    @staticmethod
    def _two(alphas, betas, steps, step):
        """Step ``step`` of pass two's α, β_prev, 1/β and activity."""
        zero = torch.zeros((), dtype=_F32, device=alphas.device)
        active = step < int(steps) - 1
        beta = betas[step] if betas[step] > 0 else torch.ones_like(zero)
        prev = betas[step - 1] if step > 0 else zero
        return alphas[step], prev, 1.0 / beta if active else zero, active

    def two_matvec(self, lay, v_prev, v_curr, v_next, s, alphas, betas,
                   steps, y, nf, k, step, x):
        m = lay.m
        ya, s[:] = self._matvec(lay, v_curr)
        a, bp, inv, active = self._two(alphas, betas, steps, step)
        if active:
            v_next[:m] = ((ya - bp * v_prev[:m]) - a * v_curr[:m]) * inv
            x[:, :m] += y[:, step + 1:step + 2] * v_next[:m]

    def two_nodes(self, g, ranks, m, p, v_prev, v, v_next, alphas, betas,
                  steps, y, nf, k, step, x):
        a, bp, inv, active = self._two(alphas, betas, steps, step)
        if not active:
            v_next.copy_(v)
            v.copy_(v_prev)
            return
        v_next[m:] = ((_fold(g, ranks) - bp * v_prev[m:]) - a * v[m:]) * inv
        x[:, m:] += y[:, step + 1:step + 2] * v_next[m:]


def _field(state: torch.Tensor, i: int) -> torch.Tensor:
    """Float field i of an int32 state slot, by its bits."""
    return state.view(_F32)[i]


def _block_sums(t: torch.Tensor, size: int) -> torch.Tensor:
    """One sum per ``size`` elements, as the kernels' block partials."""
    pad = (-t.numel()) % size
    return torch.cat([t, t.new_zeros(pad)]).view(-1, size).sum(1)


def _shares(total: torch.Tensor) -> torch.Tensor:
    """A sum as the 16 shares a dot leaves, all in the first."""
    return torch.cat([total.reshape(1), total.new_zeros(_FOLD_PARTS - 1)])


def _fold(g: torch.Tensor, ranks: int) -> torch.Tensor:
    """The gathered rows summed in rank order, as ``comm.gather_fold``."""
    acc = g[0]
    for r in range(1, ranks):
        acc = acc + g[r]
    return acc


class ShardStep:
    """The fused passes over one rank's shard (:class:`KKTLayout` over the
    global node ids) on a CUDA mesh; see the module docstring. ``dot`` is
    the solver's distributed inner product (‖b‖'s); ``kernels`` the step's
    kernels, :class:`CudaStepKernels` unless given."""

    def __init__(self, layout: KKTLayout, mesh: Mesh, tol: float,
                 ztol: float, dot, kernels=None):
        self.layout, self.mesh, self.dot = layout, mesh, dot
        self.tol, self.ztol = float(tol), float(ztol)
        self.kernels = CudaStepKernels() if kernels is None else kernels
        self.parts = -(-layout.m // _K7_ARCS)
        self.quad_parts = -(-layout.m // _QUAD_ARCS)
        # the vectors' rows start 16-byte aligned, for the quad kernels
        self.row = -(-layout.n // 4) * 4

    def _empty(self, *shape, dtype=_F32) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, device=self.layout.d.device)

    def _launch(self, name: str, *args) -> None:
        """Launch kernel ``name`` and count it."""
        self.kernels(name, *args)
        if name in _K7_STEPS:
            LAUNCHES["kkt_streaming_matvec"] += 1
        else:
            STEP_KERNELS[f"shard_step_{name}"] += 1

    def first_vector(self, b: torch.Tensor, b_norm: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """v₁ = b·(1/‖b‖), 0 for a zero b (‖b‖ ≤ ``ztol``), as
        ``algorithms/core.py`` forms it, and the zero-b flag."""
        zero_b = b_norm <= self.ztol
        inv_n = torch.where(zero_b, torch.zeros_like(b_norm), 1.0 / b_norm)
        return b * inv_n, zero_b

    def start(self, b: torch.Tensor) -> StepCarry:
        """Pass one's start from the packed b: ‖b‖ = √dot(b, b), v₀ = 0, v₁;
        a zero b starts done."""
        b_norm = torch.sqrt(self.dot(b, b))
        v1, zero_b = self.first_vector(b, b_norm)
        vectors = self._vectors(v1)
        zero = torch.zeros((), dtype=torch.int32, device=b.device)
        state = self._empty(2, 4, dtype=torch.int32)
        state[0].copy_(torch.stack([zero, zero_b.to(torch.int32), zero,
                                    b_norm.view(torch.int32)]))
        return StepCarry(vectors, state, 0)

    def _vectors(self, v1: torch.Tensor) -> torch.Tensor:
        """The ``(3, n)`` rotating vectors, v₀ = 0 and v₁ in rows 0 and 1
        (views of 16-byte aligned rows)."""
        vectors = self._empty(3, self.row)[:, :self.layout.n]
        vectors[0].zero_()
        vectors[1].copy_(v1)
        return vectors

    def pass_one(self, carry: StepCarry, count: int, k_limit: int,
                 alphas: torch.Tensor, betas: torch.Tensor,
                 basis: Optional[torch.Tensor] = None) -> StepCarry:
        """``count`` steps of pass one from ``carry``; a step executes
        unless the run is done or ``k_limit`` steps have executed. Step i
        writes α into ``alphas[i]``, β into ``betas[i]`` and, with a
        ``(count, n)`` ``basis``, the vector it starts from into
        ``basis[i]`` (each 0 where the step does not execute, β also where
        it breaks down). Returns the carry after them."""
        lay, mesh = self.layout, self.mesh
        m, p, ranks = lay.m, lay.p, mesh.size
        vec, state = carry.vectors, carry.state
        s, partials = self._empty(p), self._empty(self.parts)
        scal = self._empty(4, _FOLD_PARTS)  # α's arc, node; β²'s arc, node
        for i in range(count):
            r = carry.run + i
            prev, cur, w = (vec[(r + q) % 3] for q in range(3))
            slot, after = state[r % 2], state[(r + 1) % 2]
            self._launch("one_matvec", lay, prev, cur, w, s, partials, slot)
            g = all_gather(s, mesh)
            self._launch("node_fold", g, ranks, m, p, prev, cur, w, partials,
                         self.parts, slot, scal)
            g = all_gather(scal[0], mesh)  # (D, 16)
            self._launch("orthogonalise", g, ranks, m, p, cur, w, partials,
                         slot, k_limit, alphas[i], scal)
            self._launch("norm", m, p, w, partials, self.quad_parts, scal)
            g = all_gather(scal[2], mesh)
            self._launch("advance", g, ranks, m, p, prev, cur, w,
                         None if basis is None else basis[i], slot, after,
                         k_limit, self.tol, betas[i], scal)
        return StepCarry(vec, state, carry.run + count)

    def pass_two(self, b: torch.Tensor, decomp: LanczosDecomposition,
                 y: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Pass two from the packed b and pass one's decomposition for an
        ``(nf, k)`` y (zero beyond ``steps_taken``, scaled by ‖b‖):
        ``(x, v_prev, v_curr)``, x ``(nf, n)`` and the final state, v_curr
        pass one's v_{steps_taken}."""
        lay, mesh = self.layout, self.mesh
        m, p, ranks = lay.m, lay.p, mesh.size
        nf, k = y.shape
        dev = lay.d.device
        alphas = decomp.alphas.to(device=dev, dtype=_F32).contiguous()
        betas = decomp.betas.to(device=dev, dtype=_F32).contiguous()
        steps = decomp.steps_taken.to(device=dev, dtype=torch.int32)
        v1, _ = self.first_vector(b, decomp.b_norm.to(device=dev,
                                                      dtype=_F32))
        vec = self._vectors(v1)
        x = y[:, 0:1] * v1
        s = self._empty(p)
        for j in range(k - 1):
            prev, cur, nxt = (vec[(j + q) % 3] for q in range(3))
            self._launch("two_matvec", lay, prev, cur, nxt, s, alphas, betas,
                         steps, y, nf, k, j, x)
            g = all_gather(s, mesh)
            self._launch("two_nodes", g, ranks, m, p, prev, cur, nxt, alphas,
                         betas, steps, y, nf, k, j, x)
        return x, vec[(k - 1) % 3], vec[k % 3]
