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

Both functions are dtype-generic (f32 and f64) and device-generic; the
fused solver (``ops/kkt_fused.py``) uses them for CPU tensors and the
hand-written kernels for CUDA tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

__all__ = [
    "breakdown_tolerance",
    "zero_tolerance",
    "LanczosDecomposition",
    "pass_one_scan",
    "pass_two_scan",
    "pass_one_last_vector",
]


def breakdown_tolerance(dtype: torch.dtype) -> float:
    """Breakdown tolerance: ``1000 · ε`` of the working dtype."""
    return float(torch.finfo(dtype).eps) * 1000.0


def zero_tolerance(dtype: torch.dtype) -> float:
    """``‖b‖`` at or below this is the zero vector: ``1000 · tiny`` (the
    smallest normal), so small but valid right-hand sides are kept."""
    return float(torch.finfo(dtype).tiny) * 1000.0


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


def _init_v1(b: torch.Tensor, b_norm: torch.Tensor):
    zero_b = b_norm <= zero_tolerance(b.dtype)
    inv_n = torch.where(zero_b, torch.zeros_like(b_norm), 1.0 / b_norm)
    return b * inv_n, zero_b


def pass_one_scan(matvec: Callable[[torch.Tensor], torch.Tensor],
                  b: torch.Tensor, k: int, *, emit_basis: bool = False,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[LanczosDecomposition, Optional[torch.Tensor]]:
    """Run ``k`` masked recurrence steps from ``b``.

    Returns ``(decomposition, basis)``; ``basis`` is ``(k, n)`` with row ``i``
    equal to v_{i+1} (zero beyond ``steps_taken``) when ``emit_basis``, else
    ``None``. If ``state`` (a ``(2, n)`` tensor) is given it receives the
    final ``(v_prev, v_curr)``.
    """
    if k < 1:
        raise ValueError("k must be >= 1")
    dt = b.dtype
    tol = breakdown_tolerance(dt)
    b_norm = torch.sqrt(torch.dot(b, b))
    v, done = _init_v1(b, b_norm)
    v_prev = torch.zeros_like(b)
    beta_prev = torch.zeros((), dtype=dt, device=b.device)
    steps = torch.zeros((), dtype=torch.int32, device=b.device)
    alphas = torch.zeros(k, dtype=dt, device=b.device)
    betas = torch.zeros(k, dtype=dt, device=b.device)
    basis = (torch.zeros((k, b.shape[0]), dtype=dt, device=b.device)
             if emit_basis else None)
    zero = torch.zeros((), dtype=dt, device=b.device)
    for j in range(k):
        executed = ~done
        w = matvec(v)
        w = w - beta_prev * v_prev
        alpha = torch.dot(v, w)
        w = w - alpha * v
        beta = torch.sqrt(torch.dot(w, w))
        breakdown = beta <= tol
        advance = executed & ~breakdown
        alphas[j] = torch.where(executed, alpha, zero)
        betas[j] = torch.where(advance, beta, zero)
        inv_b = torch.where(advance, 1.0 / beta, zero)
        v_next = w * inv_b
        if emit_basis:
            basis[j] = torch.where(executed, v, zero)
        v_prev = torch.where(advance, v, v_prev)
        v = torch.where(advance, v_next, v)
        beta_prev = torch.where(advance, beta, beta_prev)
        done = done | breakdown
        steps = steps + executed.to(torch.int32)
    if state is not None:
        state[0].copy_(v_prev)
        state[1].copy_(v)
    return LanczosDecomposition(alphas, betas, steps, b_norm), basis


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
    k = decomp.k_max
    steps = decomp.steps_taken
    alphas, betas = decomp.alphas.to(dt), decomp.betas.to(dt)
    y_full = y_full.to(dt)
    v, _ = _init_v1(b, decomp.b_norm.to(dt))
    v_prev = torch.zeros_like(b)
    x = y_full[..., 0:1] * v
    basis = None
    if emit_basis:
        basis = torch.zeros((k, b.shape[0]), dtype=dt, device=b.device)
        basis[0] = v
    zero = torch.zeros((), dtype=dt, device=b.device)
    one = torch.ones((), dtype=dt, device=b.device)
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
