"""Block Lanczos: f(A)·B for a block of right-hand sides, one shared space.

Counterpart of ``two_pass_lanczos_tpu/algorithms/block.py``. One block
Krylov space K_k(A, B) = span{B, AB, …, A^{k−1}B}, B ∈ 𝔽^{n×p} (𝔽 = ℝ
or ℂ, A self-adjoint):

    A·V_j = V_{j−1}·B_{j−1}ᴴ + V_j·A_j + V_{j+1}·B_j

with V_j orthonormal n×p blocks, A_j Hermitian p×p and B_j upper
triangular with a real positive diagonal, the R of the residual block's
QR. A block of width p resolves eigenvalue multiplicities up to p that a
single-vector space cannot see.

Each step is :func:`_block_recurrence_body` (shared by both passes, so the
replay issues the same products at the same shapes), then the QR's R
(``torch.linalg.qr(mode="r")`` with the positive-diagonal rotation) and the
next block W·R⁻¹ (``torch.linalg.solve_triangular``), not QR's Q, so pass
two can rebuild it from the stored R. Breakdown is the residual block
losing rank, a relative test on |diag R|; it truncates through
``steps_taken`` and a zero or rank-deficient B gives zero steps and a zero
x. Every product runs with TF32 off (``core.full_f32_matmul``; the JAX
package asks for ``Precision.HIGHEST``).

The block matvec applies the operator's matvec to the p columns one by
one (JAX vmaps it): under ``make_kkt_operator`` on a card that is p
launches of the kernel K8 a block step, each column bitwise K8 alone.
The loops are eager PyTorch with the done flag on the device, as
``core.pass_one_scan``: fixed k steps, no host read.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.algorithms.core import (
    breakdown_tolerance,
    full_f32_matmul,
    real_dtype,
)

__all__ = ["BlockDecomposition", "block_pass_one", "block_pass_two",
           "block_padded_f_e1", "solve_fAb_block", "solve_fAb_block_jit"]

FSpec = Union[str, Callable[[np.ndarray], np.ndarray]]
Reduce = Optional[Callable[[torch.Tensor], torch.Tensor]]


class BlockDecomposition(NamedTuple):
    """Block tridiagonal T_k and its bookkeeping (fixed shapes).

    * ``a_blocks`` — (k, p, p) diagonal blocks A_j (Hermitian), zeros
      beyond ``steps_taken``.
    * ``b_blocks`` — (k, p, p) sub-diagonal blocks B_j (upper triangular;
      ``b_blocks[j]`` couples blocks j and j+1); ``b_blocks[steps-1]`` is
      the final residual R, as β_k is kept by the single-vector pass.
    * ``r0`` — (p, p) upper-triangular factor of the first QR, B = V₁·r0
      (the block analogue of ‖b‖).
    * ``steps_taken`` — int32 0-d tensor, the full-rank block steps.
    """

    a_blocks: torch.Tensor
    b_blocks: torch.Tensor
    r0: torch.Tensor
    steps_taken: torch.Tensor


def _adj(m: torch.Tensor) -> torch.Tensor:
    """The conjugate transpose; on a real tensor the transpose."""
    return m.mH


def _r_pos(w: torch.Tensor) -> torch.Tensor:
    """The R of the reduced QR of w with a real positive diagonal: each row
    times the conjugate phase of its diagonal entry (±1 on real input), so
    p = 1 is the β > 0 normalisation of the single-vector recurrence."""
    r = torch.linalg.qr(w, mode="r").R
    d = r.diagonal()
    mag = d.abs()
    zero = mag == 0
    safe = torch.where(zero, torch.ones_like(mag), mag)
    phase = torch.where(zero, torch.ones_like(d), d / safe.to(d.dtype))
    return phase.conj()[:, None] * r


def _right_tri_solve(w: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``W·R⁻¹`` for upper-triangular R: the block normalisation."""
    return torch.linalg.solve_triangular(r, w, upper=True, left=False)


def _rank_ok(r: torch.Tensor, ref_scale: torch.Tensor,
             tol: float) -> torch.Tensor:
    """The relative rank test: the smallest |diag R| against the larger of
    R's own scale and ``ref_scale`` (no absolute floor, so small but valid
    blocks pass; a zero block has scale 0 and fails)."""
    diag = r.diagonal().abs()
    scale = torch.maximum(diag.max(), ref_scale)
    return diag.min() > tol * scale


def _block_matvec(matvec) -> Callable[[torch.Tensor], torch.Tensor]:
    """(n, p) → (n, p): the operator's matvec on each column in turn."""
    def block_mv(v: torch.Tensor) -> torch.Tensor:
        return torch.stack([matvec(v[:, i].contiguous())
                            for i in range(v.shape[1])], dim=1)

    return block_mv


def _block_recurrence_body(block_mv, v_prev: torch.Tensor,
                           v_curr: torch.Tensor, b_prev: torch.Tensor,
                           reduce: Reduce = None):
    """One block orthogonalisation, the routine both passes call:
    ``(w, a_j)``, the unnormalised next block and the diagonal block
    (Hermitian-symmetrised, with one CGS re-sweep against the two live
    blocks). ``reduce`` finishes the p×p projections across ranks (the
    row-sharded operator's rank-ordered fold)."""
    def proj(v, x):
        g = _adj(v) @ x
        return g if reduce is None else reduce(g)

    w = block_mv(v_curr)
    w = w - v_prev @ _adj(b_prev)
    a_j = proj(v_curr, w)
    a_j = 0.5 * (a_j + _adj(a_j))  # exact Hermitian symmetry of the block
    w = w - v_curr @ a_j
    c_prev = proj(v_prev, w)
    c_curr = proj(v_curr, w)
    w = w - v_prev @ c_prev - v_curr @ c_curr
    a_j = a_j + 0.5 * (c_curr + _adj(c_curr))
    return w, a_j


def _validate_block(b_block: torch.Tensor, k: int) -> None:
    if k < 1:
        raise ValueError("k must be >= 1")
    if b_block.dim() != 2:
        raise ValueError(
            f"b_block must be (n, p), got shape {tuple(b_block.shape)}")
    n, p = b_block.shape
    if p < 1 or p > n:
        raise ValueError(f"block width p={p} must be in [1, n={n}]")


@full_f32_matmul()
def block_pass_one(matvec, b_block: torch.Tensor, k: int, *,
                   emit_basis: bool = True):
    """``k`` block recurrence steps from ``b_block`` (n, p).

    Returns ``(BlockDecomposition, basis)``, ``basis`` (k, n, p) with block
    row j = V_{j+1} and zeros beyond ``steps_taken``, or None with
    ``emit_basis=False`` (O(n·p) memory: pass one of the two-pass
    variant). A zero or rank-deficient B gives ``steps_taken == 0``."""
    _validate_block(b_block, k)
    n, p = b_block.shape
    dt, dev = b_block.dtype, b_block.device
    tol = breakdown_tolerance(dt)
    block_mv = _block_matvec(matvec)
    eye = torch.eye(p, dtype=dt, device=dev)

    r0 = _r_pos(b_block)
    ok0 = _rank_ok(r0, torch.zeros((), dtype=real_dtype(dt), device=dev),
                   tol)
    v_curr = torch.where(ok0, _right_tri_solve(b_block, r0),
                         torch.zeros_like(b_block))
    v_prev = torch.zeros_like(b_block)
    b_prev = torch.zeros((p, p), dtype=dt, device=dev)
    done = ~ok0
    steps = torch.zeros((), dtype=torch.int32, device=dev)
    a_blocks = torch.zeros((k, p, p), dtype=dt, device=dev)
    b_blocks = torch.zeros((k, p, p), dtype=dt, device=dev)
    basis = (torch.zeros((k, n, p), dtype=dt, device=dev) if emit_basis
             else None)
    for j in range(k):
        executed = ~done
        w, a_j = _block_recurrence_body(block_mv, v_prev, v_curr, b_prev)
        b_j = _r_pos(w)
        full_rank = _rank_ok(b_j, a_j.diagonal().abs().max(), tol)
        advance = executed & full_rank
        v_next = _right_tri_solve(w, torch.where(full_rank, b_j, eye))
        a_blocks[j] = torch.where(executed, a_j, torch.zeros_like(a_j))
        b_blocks[j] = torch.where(advance, b_j, torch.zeros_like(b_j))
        if emit_basis:
            basis[j] = torch.where(executed, v_curr,
                                   torch.zeros_like(v_curr))
        v_prev = torch.where(advance, v_curr, v_prev)
        v_curr = torch.where(advance, v_next, v_curr)
        b_prev = torch.where(advance, b_j, b_prev)
        done = done | ~full_rank
        steps = steps + executed.to(torch.int32)
    decomp = BlockDecomposition(
        a_blocks=a_blocks, b_blocks=b_blocks,
        r0=torch.where(ok0, r0, torch.zeros_like(r0)), steps_taken=steps)
    return decomp, basis


@full_f32_matmul()
def block_pass_two(matvec, b_block: torch.Tensor,
                   decomp: BlockDecomposition, y_blocks: torch.Tensor, *,
                   emit_basis: bool = False):
    """Regenerate the block basis from the stored decomposition and
    accumulate ``X = Σ_j V_{j+1}·Y_j``: O(n·p) memory, no stored basis.

    The same body and the same stored R as pass one, so the replay issues
    the same products at the same shapes; the QRs are not recomputed. The
    JAX package promises ≤ 1e-12 absolute drift over 25 f64 steps there
    (separately compiled programs); here both passes run the same eager
    calls. ``y_blocks`` is (k, p, q); returns x (n, q), and the
    regenerated (k, n, p) basis too with ``emit_basis=True``."""
    n, p = b_block.shape
    dt, dev = b_block.dtype, b_block.device
    steps = decomp.steps_taken
    block_mv = _block_matvec(matvec)
    eye = torch.eye(p, dtype=dt, device=dev)
    y_blocks = y_blocks.to(dt)

    ok0 = steps > 0
    v_curr = torch.where(
        ok0, _right_tri_solve(b_block, torch.where(ok0, decomp.r0, eye)),
        torch.zeros_like(b_block))
    v_prev = torch.zeros_like(b_block)
    b_prev = torch.zeros((p, p), dtype=dt, device=dev)
    k = decomp.a_blocks.shape[0]
    x = torch.zeros((n, y_blocks.shape[-1]), dtype=dt, device=dev)
    basis = (torch.zeros((k, n, p), dtype=dt, device=dev) if emit_basis
             else None)
    for j in range(k):
        executed = j < steps
        part = v_curr @ y_blocks[j]
        x = x + torch.where(executed, part, torch.zeros_like(part))
        if emit_basis:
            basis[j] = torch.where(executed, v_curr,
                                   torch.zeros_like(v_curr))
        w, _ = _block_recurrence_body(block_mv, v_prev, v_curr, b_prev)
        advance = j + 1 < steps  # the last block needs no successor
        b_j = decomp.b_blocks[j]
        v_next = _right_tri_solve(w, torch.where(advance, b_j, eye))
        v_prev = torch.where(advance, v_curr, v_prev)
        v_curr = torch.where(advance, v_next, v_curr)
        b_prev = torch.where(advance, b_j, b_prev)
    return (x, basis) if emit_basis else x


def _assemble_t(decomp: BlockDecomposition) -> np.ndarray:
    """The dense (s·p, s·p) Hermitian block tridiagonal on the host
    (s = steps), f64 for a real decomposition, c128 for a complex one."""
    s = int(decomp.steps_taken)
    p = decomp.r0.shape[0]
    a = decomp.a_blocks.detach().cpu().numpy()
    b = decomp.b_blocks.detach().cpu().numpy()
    cdt = np.complex128 if np.iscomplexobj(a) else np.float64
    a, b = a.astype(cdt), b.astype(cdt)
    t = np.zeros((s * p, s * p), cdt)
    for j in range(s):
        t[j * p:(j + 1) * p, j * p:(j + 1) * p] = a[j]
        if j + 1 < s:
            # A V_j = ... + V_{j+1} B_j  ⇒  the T[j+1, j] block is B_j
            t[(j + 1) * p:(j + 2) * p, j * p:(j + 1) * p] = b[j]
            t[j * p:(j + 1) * p, (j + 1) * p:(j + 2) * p] = b[j].conj().T
    return t


def host_f_e1_r0(decomp: BlockDecomposition, f: FSpec, k: int) -> np.ndarray:
    """``f(T_s)·E₁·R₀`` on the host in f64 (c128), padded to (k, p, p)
    with zero blocks past ``steps_taken``; the projected solve of
    :func:`solve_fAb_block` and of the row-sharded operator's."""
    from two_pass_lanczos_tpu_torch.spectrum import _f_of_theta

    s = int(decomp.steps_taken)
    p = decomp.r0.shape[0]
    t = _assemble_t(decomp)
    lam, q = np.linalg.eigh(t)
    flam = _f_of_theta(lam, f)
    e1 = np.zeros((s * p, p))
    e1[:p, :p] = np.eye(p)
    r0 = decomp.r0.detach().cpu().numpy().astype(t.dtype)
    y = (q * flam) @ (q.conj().T @ (e1 @ r0))
    y_pad = np.zeros((k, p, p), t.dtype)
    y_pad[:s] = y.reshape(s, p, p)
    return y_pad


def _block_rhs(operator, b_block) -> torch.Tensor:
    # solvers.py imports this package's core; import it at the call
    from two_pass_lanczos_tpu_torch.solvers import _rhs

    return _rhs(operator, b_block)


def _check_f(f: FSpec) -> None:
    if not callable(f):
        from two_pass_lanczos_tpu_torch.spectrum import _f_of_theta

        _f_of_theta(np.ones(1), f)  # reject unknown strings before any work


def _contract(basis: torch.Tensor, y: torch.Tensor, s: int) -> torch.Tensor:
    """``Σ_{j<s} V_{j+1}·Y_j``, in pass two's order of accumulation."""
    x = torch.zeros((basis.shape[1], y.shape[-1]), dtype=basis.dtype,
                    device=basis.device)
    for j in range(s):
        x = x + basis[j] @ y[j]
    return x


@full_f32_matmul()
def solve_fAb_block(operator, b_block, k: int, f: FSpec = "exp",
                    method: str = "one_pass") -> torch.Tensor:
    """``f(A)·B`` for B (n, p) from one block Krylov space:
    x = V_k·f(T_k)·E₁·R₀, the projected f(T_k) evaluated on the host in f64
    from the dense eigendecomposition of the (s·p, s·p) block tridiagonal.
    A zero or rank-deficient B returns zeros.

    ``method="one_pass"`` stores the (k, n, p) basis and contracts it;
    ``"two_pass"`` stores only the (k, p, p) blocks and replays the basis
    (O(n·p) memory, 2k block matvecs). ``b_block`` (a tensor or an array)
    moves to the operator's device in its own dtype; returns a tensor
    there."""
    if method not in ("one_pass", "two_pass"):
        raise ValueError(f"unknown method {method!r}")
    _check_f(f)
    b_block = _block_rhs(operator, b_block)
    decomp, basis = block_pass_one(operator.matvec, b_block, k,
                                   emit_basis=method == "one_pass")
    s = int(decomp.steps_taken)
    if s == 0:
        return torch.zeros_like(b_block)
    y = torch.from_numpy(host_f_e1_r0(decomp, f, k)).to(
        device=b_block.device, dtype=b_block.dtype)
    if method == "two_pass":
        return block_pass_two(operator.matvec, b_block, decomp, y)
    return _contract(basis, y, s)


@full_f32_matmul()
def block_padded_f_e1(decomp: BlockDecomposition, f: FSpec) -> torch.Tensor:
    """``Y = f(T_pad)·E₁·R₀`` on the padded block decomposition, on its
    device in its dtype: the block analogue of ``functions.padded_f_e1``.
    Identity padding past ``steps_taken`` makes T_pad block diagonal
    ``[T_s, I]``, so the padded rows of Y are exact zeros. Returns
    (k, p, p)."""
    from two_pass_lanczos_tpu_torch.slq import _f_of_theta

    a, bb = decomp.a_blocks, decomp.b_blocks
    k, p, _ = a.shape
    dt, dev = a.dtype, a.device
    steps = decomp.steps_taken
    jj = torch.arange(k, device=dev)
    eye = torch.eye(p, dtype=dt, device=dev)
    a_pad = torch.where((jj < steps)[:, None, None], a, eye)
    # sub-diagonal block j couples blocks j and j+1: valid while j+1 < s
    b_pad = torch.where((jj + 1 < steps)[:, None, None], bb,
                        torch.zeros_like(bb))
    t4 = torch.zeros((k, p, k, p), dtype=dt, device=dev)
    t4[jj, :, jj, :] = a_pad
    if k > 1:
        j1 = jj[:k - 1]
        sub = b_pad[:k - 1]
        t4[j1 + 1, :, j1, :] = sub
        t4[j1, :, j1 + 1, :] = sub.mH
    lam, q = torch.linalg.eigh(t4.reshape(k * p, k * p))
    flam = _f_of_theta(lam, f).to(lam.dtype)
    e1r0 = torch.zeros((k * p, p), dtype=dt, device=dev)
    e1r0[:p] = decomp.r0
    y = ((q * flam) @ (q.mH @ e1r0)).reshape(k, p, p)
    # an explicit mask: eigensolver noise on degenerate pads stays out
    return torch.where((jj < steps)[:, None, None], y, torch.zeros_like(y))


@full_f32_matmul()
def solve_fAb_block_jit(operator, b_block, *, k: int, f: FSpec = "exp",
                        method: str = "one_pass") -> torch.Tensor:
    """``f(A)·B`` with fixed shapes end to end and no host read: the
    block analogue of ``solvers.solve_fAb``, the projected solve on the
    device in the working dtype (:func:`block_padded_f_e1`); the host
    :func:`solve_fAb_block` evaluates it in f64 instead."""
    if method not in ("one_pass", "two_pass"):
        raise ValueError(f"unknown method {method!r}")
    _check_f(f)
    b_block = _block_rhs(operator, b_block)
    emit = method == "one_pass"
    decomp, basis = block_pass_one(operator.matvec, b_block, k,
                                   emit_basis=emit)
    y = block_padded_f_e1(decomp, f).to(b_block.dtype)
    if emit:
        return _contract(basis, y, k)
    return block_pass_two(operator.matvec, b_block, decomp, y)
