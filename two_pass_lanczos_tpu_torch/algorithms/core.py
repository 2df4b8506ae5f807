"""Core Lanczos recurrence in plain PyTorch: the oracle for the CUDA kernels.

Counterpart of ``two_pass_lanczos_tpu/algorithms/core.py``. The recurrence
keeps the reference's operation order exactly:

1. ``w = A·v``
2. ``w -= β_prev·v_prev``
3. ``α = ⟨v, w⟩``
4. ``w -= α·v``
5. ``β = ‖w‖``; breakdown when ``β ≤ 1000·ε``
6. ``v_next = w·(1/β)`` (reciprocal-multiply, not division)

Breakdown is masked, not raised: a ``done`` flag freezes the state and
``steps_taken`` counts the executed steps, so the loop runs a fixed ``k``
steps with no host synchronisation (the flags stay tensors). Pass two
(:func:`pass_two_scan`) replays steps 1, 2, 4 and 6 from the stored α and β
with the same arithmetic, so its regenerated basis is bit-identical to pass
one's.

One step is written once (:func:`lanczos_recurrence_step`, masked by
:func:`_step`): :func:`pass_one_scan` runs ``k`` of them from ``b``,
:func:`pass_one_chunk_scan` runs ``chunk`` of them from a carried
:class:`ChunkCarry`, so chained chunks give α and β bitwise equal to one
monolithic pass. The inner products go through ``dot``: :func:`inner`
(``torch.dot``, or ``Re(vdot)`` on complex tensors), :func:`dot_f64` as the
plain version of the compensated (two-float) kernel reductions, or a
sharded tier's ``inner`` of its rows folded over the ranks.

All functions are dtype-generic (f32 and f64, and complex64/complex128 for
a Hermitian A, as in the JAX package: α, β and ‖b‖ are then real, α is
``Re⟨v, w⟩`` by ``torch.vdot`` and a norm is ``√Re⟨x, x⟩``) and
device-generic. The fused solver (``ops/kkt_fused.py``) uses them for CPU
tensors and the hand-written kernels for CUDA tensors; the generic solvers
(``solvers.py``) run them on any operator's ``matvec``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "breakdown_tolerance",
    "zero_tolerance",
    "real_dtype",
    "LanczosDecomposition",
    "ChunkCarry",
    "inner",
    "dot_f64",
    "basis_product",
    "full_f32_matmul",
    "l2_norm",
    "lanczos_recurrence_step",
    "pass_one_scan",
    "pass_one_chunk_scan",
    "pass_two_scan",
    "pass_one_last_vector",
]

Dot = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The real dtype of ``dtype``: α, β and ‖b‖ of a complex run."""
    return _REAL.get(dtype, dtype)


def breakdown_tolerance(dtype: torch.dtype) -> float:
    """Breakdown tolerance: ``1000 · ε`` of the working real dtype."""
    return float(torch.finfo(real_dtype(dtype)).eps) * 1000.0


def zero_tolerance(dtype: torch.dtype) -> float:
    """``‖b‖`` at or below this is the zero vector: ``1000 · tiny`` (the
    smallest normal of the real dtype), so small but valid right-hand sides
    are kept."""
    return float(torch.finfo(real_dtype(dtype)).tiny) * 1000.0


@dataclasses.dataclass(frozen=True)
class LanczosDecomposition:
    """Scalar output of pass one: the complete definition of T_k.

    * ``alphas``: ``(k,)``; entries ``[steps_taken:]`` are zero.
    * ``betas``: ``(k,)``; ``betas[j]`` is β_{j+1}. The off-diagonal of T_k is
      ``betas[:steps_taken-1]``; after a full run without breakdown
      ``betas[steps_taken-1]`` holds the residual norm β_k, after a breakdown
      it is 0.
    * ``steps_taken``: int32 0-d tensor, the number of executed steps.
    * ``b_norm``: ``‖b‖₂`` as a 0-d tensor.
    """

    alphas: torch.Tensor
    betas: torch.Tensor
    steps_taken: torch.Tensor
    b_norm: torch.Tensor

    @property
    def k_max(self) -> int:
        return int(self.alphas.shape[0])

    def steps(self) -> int:
        return int(self.steps_taken)

    def alphas_valid(self) -> np.ndarray:
        """α₁..α_steps as a NumPy array."""
        return self.alphas.detach().cpu().numpy()[: self.steps()]

    def betas_valid(self) -> np.ndarray:
        """β₁..β_{steps-1} as a NumPy array (length ``steps_taken - 1``)."""
        s = self.steps()
        return self.betas.detach().cpu().numpy()[: max(s - 1, 0)]

    def beta_last(self) -> float:
        """β_steps, the final residual norm (0.0 after a breakdown)."""
        s = self.steps()
        return 0.0 if s == 0 else float(self.betas[s - 1])


def dot_f64(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``⟨x, y⟩`` accumulated in f64 and rounded once to ``x``'s dtype.

    The plain version of the compensated kernels' α, β and ‖b‖ reductions
    (exact products folded as two-float pairs, then ``hi + lo``), which the
    JAX package's ``_dot_rep_comp`` approximates to ~f32 rounding too."""
    return torch.dot(x.to(torch.float64), y.to(torch.float64)).to(x.dtype)


def inner(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``Re⟨x, y⟩`` in the real dtype of x: ``torch.dot`` for real tensors,
    ``Re(vdot)`` (x conjugated) for complex ones; the default ``dot``."""
    return torch.vdot(x, y).real if x.is_complex() else torch.dot(x, y)


def l2_norm(x: torch.Tensor, dot: Dot = inner) -> torch.Tensor:
    """‖x‖ in the real dtype of x: ``√dot(x, x)``."""
    return torch.sqrt(dot(x, x))


def basis_product(y_full: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """``x = y_full @ basis`` for a ``(k, n)`` basis, in full f32 whatever
    the caller's TF32 setting (the JAX package asks for
    ``Precision.HIGHEST``): one GEMV ``Vᵀ·y`` per row of ``y_full``, a route
    on which cuBLAS never uses TF32, and no process-global switch is
    touched. ``(k,)`` gives ``(n,)``, ``(nf, k)`` gives ``(nf, n)``; nf rows
    read the basis nf times."""
    vt = basis.t()
    if y_full.dim() == 1:
        return torch.mv(vt, y_full)
    return torch.stack([torch.mv(vt, row) for row in y_full])


@contextlib.contextmanager
def full_f32_matmul():
    """TF32 off for the GEMMs run inside the block (the block recurrence's
    ``(n, p)×(p, p)`` products and Gram matrices, its QR and triangular
    solves), whatever the caller's setting, which is restored on exit. The
    JAX package asks for ``Precision.HIGHEST`` on the same products."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


class ChunkCarry(NamedTuple):
    """State carried from one chunk of pass one to the next."""

    v_prev: torch.Tensor
    v_curr: torch.Tensor
    beta_prev: torch.Tensor  # 0-d
    done: torch.Tensor  # 0-d bool: a breakdown or a zero b
    steps: torch.Tensor  # 0-d int32: steps executed so far
    b_norm: torch.Tensor  # 0-d


def _init_v1(b: torch.Tensor, b_norm: torch.Tensor):
    zero_b = b_norm <= zero_tolerance(b.dtype)
    inv_n = torch.where(zero_b, torch.zeros_like(b_norm), 1.0 / b_norm)
    return b * inv_n, zero_b


def _start(b: torch.Tensor, dot: Dot) -> ChunkCarry:
    """‖b‖, v₁ = b·(1/‖b‖), v₀ = 0; a zero b starts done (0 steps)."""
    b_norm = l2_norm(b, dot)
    v, zero_b = _init_v1(b, b_norm)
    return ChunkCarry(
        v_prev=torch.zeros_like(b), v_curr=v,
        beta_prev=torch.zeros((), dtype=real_dtype(b.dtype), device=b.device),
        done=zero_b,
        steps=torch.zeros((), dtype=torch.int32, device=b.device),
        b_norm=b_norm)


def _residual(matvec, v_curr: torch.Tensor, v_prev: torch.Tensor,
              beta_prev: torch.Tensor, dot: Dot
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Steps 1-4 of the module docstring: ``(α, w)`` with ``w`` the
    unnormalised next vector before its norm (the reorthogonalised
    recurrence sweeps it here, ``algorithms/reorth.py``)."""
    w = matvec(v_curr)
    w = w - beta_prev * v_prev
    alpha = dot(v_curr, w)
    w = w - alpha * v_curr
    return alpha, w


def lanczos_recurrence_step(
        matvec, v_curr: torch.Tensor, v_prev: torch.Tensor,
        beta_prev: torch.Tensor, dot: Dot = inner
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One unmasked recurrence step, steps 1-5 of the module docstring in the
    reference's order: ``(α, β, w)`` with ``w`` the unnormalised next
    vector."""
    alpha, w = _residual(matvec, v_curr, v_prev, beta_prev, dot)
    return alpha, l2_norm(w, dot), w


def _step(matvec, c: ChunkCarry, executed: torch.Tensor, tol: float,
          dot: Dot) -> Tuple[torch.Tensor, torch.Tensor, ChunkCarry]:
    """One masked recurrence step. Returns the step's stored α (0 unless
    ``executed``), its stored β (0 unless it advanced) and the new carry."""
    alpha, beta, w = lanczos_recurrence_step(matvec, c.v_curr, c.v_prev,
                                             c.beta_prev, dot)
    return _advance(c, executed, alpha, beta, w, tol)


def _advance(c: ChunkCarry, executed: torch.Tensor, alpha: torch.Tensor,
             beta: torch.Tensor, w: torch.Tensor, tol: float
             ) -> Tuple[torch.Tensor, torch.Tensor, ChunkCarry]:
    """Step 6 and the masking of one step from its ``(α, β, w)``: the
    breakdown test, v_next = w·(1/β) and the new carry. Every pass one
    (plain, chunked, reorthogonalised) ends its step here."""
    zero = torch.zeros((), dtype=real_dtype(c.v_curr.dtype),
                       device=c.v_curr.device)
    v, v_prev = c.v_curr, c.v_prev
    breakdown = beta <= tol
    advance = executed & ~breakdown
    inv_b = torch.where(advance, 1.0 / beta, zero)
    v_next = w * inv_b
    carry = ChunkCarry(
        v_prev=torch.where(advance, v, v_prev),
        v_curr=torch.where(advance, v_next, v),
        beta_prev=torch.where(advance, beta, c.beta_prev),
        done=c.done | (executed & breakdown),
        steps=c.steps + executed.to(torch.int32),
        b_norm=c.b_norm)
    return (torch.where(executed, alpha, zero),
            torch.where(advance, beta, zero), carry)


def pass_one_scan(matvec: Callable[[torch.Tensor], torch.Tensor],
                  b: torch.Tensor, k: int, *, emit_basis: bool = False,
                  state: Optional[torch.Tensor] = None, dot: Dot = inner
                  ) -> Tuple[LanczosDecomposition, Optional[torch.Tensor]]:
    """Run ``k`` masked recurrence steps from ``b``.

    Returns ``(decomposition, basis)``; ``basis`` is ``(k, n)`` with row ``i``
    equal to v_{i+1} (zero beyond ``steps_taken``) when ``emit_basis``, else
    ``None``. If ``state`` (a ``(2, n)`` tensor) is given it receives the
    final ``(v_prev, v_curr)``. ``dot`` computes ‖b‖², α and β².
    """
    if k < 1:
        raise ValueError("k must be >= 1")
    dt = b.dtype
    tol = breakdown_tolerance(dt)
    c = _start(b, dot)
    alphas = torch.zeros(k, dtype=real_dtype(dt), device=b.device)
    betas = torch.zeros(k, dtype=real_dtype(dt), device=b.device)
    basis = (torch.zeros((k, b.shape[0]), dtype=dt, device=b.device)
             if emit_basis else None)
    for j in range(k):
        executed = ~c.done
        if emit_basis:
            basis[j] = torch.where(executed, c.v_curr, torch.zeros_like(b))
        alphas[j], betas[j], c = _step(matvec, c, executed, tol, dot)
    if state is not None:
        state[0].copy_(c.v_prev)
        state[1].copy_(c.v_curr)
    return LanczosDecomposition(alphas, betas, c.steps, c.b_norm), basis


def pass_one_chunk_scan(matvec: Callable[[torch.Tensor], torch.Tensor],
                        b: torch.Tensor, chunk: int,
                        carry: Optional[ChunkCarry], k_limit: int, *,
                        dot: Dot = inner,
                        basis: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, ChunkCarry]:
    """Run ``chunk`` masked steps from ``carry`` (from ``b`` when ``carry``
    is None). A step executes unless the run is done or ``k_limit`` steps
    have been executed. Returns ``(alphas, betas, carry)``, the first two
    ``(chunk,)`` and indexed from the chunk's first step; chained chunks
    give α and β bitwise equal to one :func:`pass_one_scan`. A ``(chunk,
    n)`` ``basis`` receives the chunk's rows of pass one's basis (row ``i``
    the vector step ``i`` starts from, zero unless it executes)."""
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    dt = b.dtype
    tol = breakdown_tolerance(dt)
    c = _start(b, dot) if carry is None else carry
    alphas = torch.zeros(chunk, dtype=real_dtype(dt), device=b.device)
    betas = torch.zeros(chunk, dtype=real_dtype(dt), device=b.device)
    for i in range(chunk):
        executed = ~c.done & (c.steps < k_limit)
        if basis is not None:
            basis[i] = torch.where(executed, c.v_curr, torch.zeros_like(b))
        alphas[i], betas[i], c = _step(matvec, c, executed, tol, dot)
    return alphas, betas, c


def pass_two_scan(matvec: Callable[[torch.Tensor], torch.Tensor],
                  b: torch.Tensor, decomp: LanczosDecomposition,
                  y_full: torch.Tensor, *, emit_basis: bool = False,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Replay pass one from the stored α, β and accumulate ``x = Σ y_j v_j``.

    ``y_full`` is ``(k,)`` or an ``(nf, k)`` stack, already zero beyond
    ``steps_taken`` and scaled by ‖b‖; ``x`` is ``(n,)`` or ``(nf, n)``.
    Step ``j`` (``0 ≤ j < k-1``) regenerates v_{j+2} and is a no-op unless
    ``j < steps_taken - 1``. ``basis`` and ``state`` are as in
    :func:`pass_one_scan`; pass two's final ``v_curr`` is v_{steps_taken}.
    """
    dt = b.dtype
    rdt = real_dtype(dt)
    k = decomp.k_max
    steps = decomp.steps_taken
    alphas, betas = decomp.alphas.to(rdt), decomp.betas.to(rdt)
    y_full = y_full.to(dt)
    v, _ = _init_v1(b, decomp.b_norm.to(rdt))
    v_prev = torch.zeros_like(b)
    x = y_full[..., 0:1] * v
    basis = None
    if emit_basis:
        basis = torch.zeros((k, b.shape[0]), dtype=dt, device=b.device)
        basis[0] = v
    zero = torch.zeros((), dtype=rdt, device=b.device)
    one = torch.ones((), dtype=rdt, device=b.device)
    for j in range(k - 1):
        active = j < steps - 1
        beta_prev = betas[j - 1] if j > 0 else zero
        w = matvec(v)
        w = w - beta_prev * v_prev
        w = w - alphas[j] * v
        beta_j = betas[j]
        inv_b = torch.where(
            active, 1.0 / torch.where(beta_j > 0, beta_j, one), zero)
        v_next = w * inv_b
        x = x + y_full[..., j + 1:j + 2] * v_next
        if emit_basis:
            basis[j + 1] = torch.where(active, v_next, zero)
        v_prev = torch.where(active, v, v_prev)
        v = torch.where(active, v_next, v)
    if state is not None:
        state[0].copy_(v_prev)
        state[1].copy_(v)
    return x, basis


def pass_one_last_vector(decomp: LanczosDecomposition,
                         state: torch.Tensor) -> torch.Tensor:
    """Pass one's v_{steps_taken} from its final ``(v_prev, v_curr)`` state.

    A step that advanced moved v_curr into v_prev, so after a full run
    (stored ``betas[s-1] > 0``) v_s is ``v_prev``; after a breakdown at the
    last executed step (``betas[s-1] == 0``) it is still ``v_curr``.
    """
    s = decomp.steps()
    if s == 0:
        raise ValueError("no basis vector: pass one took 0 steps")
    return state[1] if float(decomp.betas[s - 1]) == 0.0 else state[0]
