"""Reorthogonalised one-pass Lanczos: full (CGS2) and selective.

Counterpart of ``two_pass_lanczos_tpu/algorithms/reorth.py``. The plain
recurrence (``algorithms/core.py``) loses orthogonality on indefinite or
clustered spectra; where the one-pass variant stores the basis anyway,
each new vector can be orthogonalised against all of it:

* :func:`pass_one_scan_reorth` sweeps every step: ``sweeps`` classical
  Gram-Schmidt passes ("twice is enough", Kahan–Parlett), each two GEMVs,
  ``proj = conj(V)·w`` and ``w -= Vᵀ·proj``, and folds ``proj[j]`` of the
  first sweep into α, so T_k stays the projection of A onto the
  orthogonalised basis;
* :func:`pass_one_scan_selective` follows Simon's ω-recurrence on the
  (α, β) history and sweeps only when it predicts a loss above √ε (and on
  the step after, the Parlett–Scott pairing). A step that does not sweep
  is the plain step itself, so a run that never sweeps is bitwise
  ``pass_one_scan(emit_basis=True)``.

Both are built on the plain recurrence's own pieces: ``_start`` for ‖b‖
and v₁, ``_residual`` / ``lanczos_recurrence_step`` for α and w, and
``_advance`` for the breakdown test, v_next = w·(1/β) and the masked
carry, so there is one update routine. The sweeps contract the prefix
``basis[:j+1]`` of the stored rows, not the whole ``(k, n)`` basis as the
JAX scan does (its rows past j are zero there): the same result in exact
arithmetic at half the bytes over a run. The products are ``torch.mv``,
which cuBLAS never runs in TF32.

Selective mode decides each step on the host, one read of the step's
trigger (JAX branches with ``lax.cond``); full mode reads nothing back.

Distribution hooks: ``dot`` reduces α and the norms (as in
``core.pass_one_scan``), ``reduce`` the ``(j+1,)`` projection partials;
the row-sharded operator passes ``parallel/comm.gather_fold`` for both, so
every rank holds the same bits.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from two_pass_lanczos_tpu_torch.algorithms.core import (
    ChunkCarry,
    Dot,
    LanczosDecomposition,
    _advance,
    _residual,
    _start,
    breakdown_tolerance,
    inner,
    l2_norm,
    lanczos_recurrence_step,
    real_dtype,
)

__all__ = [
    "pass_one_scan_reorth",
    "make_pass_one_step_reorth",
    "pass_one_scan_selective",
]

Reduce = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _check(k: int, sweeps: int) -> None:
    if k < 1:
        raise ValueError("k must be >= 1")
    if sweeps < 1:
        raise ValueError("sweeps must be >= 1")


def _enter_row(basis: torch.Tensor, j: int, c: ChunkCarry,
               executed: torch.Tensor) -> torch.Tensor:
    """Row j of the basis becomes v_{j+1} (frozen after a breakdown or a
    zero b, so the rows past ``steps_taken`` stay zero); returns the
    prefix ``basis[:j+1]`` the sweeps contract."""
    basis[j] = torch.where(executed, c.v_curr, basis[j])
    return basis[:j + 1]


def _cgs(prefix: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor,
         sweeps: int, reduce: Reduce) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sweeps`` classical Gram-Schmidt sweeps of w against the stored
    rows; the first sweep's component along the newest row corrects α."""
    for s in range(sweeps):
        proj = torch.mv(prefix.conj(), w)
        if reduce is not None:
            proj = reduce(proj)
        w = w - torch.mv(prefix.t(), proj)
        if s == 0:
            alpha = alpha + proj[-1].real
    return w, alpha


def make_pass_one_step_reorth(matvec, dtype: torch.dtype, *, sweeps: int = 2,
                              dot: Dot = inner, reduce: Reduce = None):
    """Step factory of the fully reorthogonalised pass one:
    ``step((carry, basis), j) -> ((carry, basis), (α_j, β_j))`` with
    ``carry`` a :class:`~algorithms.core.ChunkCarry` and ``basis`` the
    ``(k, n)`` rows, written in place."""
    tol = breakdown_tolerance(dtype)

    def step(state, j: int):
        c, basis = state
        executed = ~c.done
        prefix = _enter_row(basis, j, c, executed)
        alpha, w = _residual(matvec, c.v_curr, c.v_prev, c.beta_prev, dot)
        w, alpha = _cgs(prefix, w, alpha, sweeps, reduce)
        a_out, b_out, c = _advance(c, executed, alpha, l2_norm(w, dot), w,
                                   tol)
        return (c, basis), (a_out, b_out)

    return step


def _scan(step, b: torch.Tensor, k: int, state) -> Tuple:
    rdt = real_dtype(b.dtype)
    alphas = torch.zeros(k, dtype=rdt, device=b.device)
    betas = torch.zeros(k, dtype=rdt, device=b.device)
    for j in range(k):
        state, (alphas[j], betas[j]) = step(state, j)
    return state, alphas, betas


def pass_one_scan_reorth(matvec, b: torch.Tensor, k: int, *,
                         sweeps: int = 2, dot: Dot = inner,
                         reduce: Reduce = None
                         ) -> Tuple[LanczosDecomposition, torch.Tensor]:
    """Reorthogonalised pass one: ``(decomposition, basis)`` as
    ``pass_one_scan(..., emit_basis=True)`` returns them (basis row i =
    v_{i+1}, zero beyond ``steps_taken``), with the basis orthonormal to
    working precision whatever k, and α, β the projections onto it."""
    _check(k, sweeps)
    c = _start(b, dot)
    basis = torch.zeros((k,) + tuple(b.shape), dtype=b.dtype,
                        device=b.device)
    step = make_pass_one_step_reorth(matvec, b.dtype, sweeps=sweeps, dot=dot,
                                     reduce=reduce)
    (c, basis), alphas, betas = _scan(step, b, k, (c, basis))
    return LanczosDecomposition(alphas, betas, c.steps, c.b_norm), basis


# ---------------------------------------------------------------------------
# Selective reorthogonalisation (Parlett–Scott / Simon ω-recurrence)
# ---------------------------------------------------------------------------

def _shift_left(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[1:], x.new_zeros(1)])


def _shift_right(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x.new_zeros(1), x[:-1]])


def make_pass_one_step_selective(matvec, dtype: torch.dtype, *,
                                 sweeps: int = 2, dot: Dot = inner,
                                 reduce: Reduce = None):
    """Step factory of the selectively reorthogonalised pass one (Simon,
    1984): the ω rows estimate ⟨v_{j+1}, v_i⟩ from (α, β) alone,

        β_j·ω_{j+1,i} = β_i·ω_{j,i+1} + (α_i − α_j)·ω_{j,i}
                        + β_{i−1}·ω_{j,i−1} − β_{j−1}·ω_{j−1,i}

    plus an ε·‖T‖ noise floor; the CGS sweeps run only when max|ω| > √ε
    or the previous step's trigger forces them. The ω bookkeeping runs on
    the device in the working real dtype, in the JAX step's order; the
    trigger is read once a step. The state is ``(carry, basis, ω_prev,
    ω_curr, α history, β history, ‖T‖ estimate, force, sweeps fired)``. A
    step that does not sweep is ``lanczos_recurrence_step`` and
    ``_advance``, the plain step itself."""
    tol = breakdown_tolerance(dtype)
    rdt = real_dtype(dtype)
    eps = float(torch.finfo(rdt).eps)
    thresh = eps ** 0.5

    def step(state, j: int):
        c, basis, om_prev, om_curr, ah, bh, anorm, force, nre = state
        executed = ~c.done
        idx = torch.arange(om_curr.shape[0], device=om_curr.device)
        prefix = _enter_row(basis, j, c, executed)
        alpha, beta_tent, w = lanczos_recurrence_step(
            matvec, c.v_curr, c.v_prev, c.beta_prev, dot)
        one = torch.ones((), dtype=rdt, device=om_curr.device)
        safe_beta = torch.where(beta_tent > 0, beta_tent, one)
        anorm = torch.maximum(anorm, alpha.abs() + beta_tent + c.beta_prev)
        num = (bh * _shift_left(om_curr) + (ah - alpha) * om_curr
               + _shift_right(bh * om_curr) - c.beta_prev * om_prev)
        noise = eps * anorm / safe_beta
        sgn = torch.where(num < 0, -one, one)
        om_next = torch.where(idx < j, num / safe_beta + sgn * noise,
                              torch.zeros_like(num))
        om_trigger = om_next.abs().max() > thresh
        do_reorth = executed & (om_trigger | force)
        beta = beta_tent
        if bool(do_reorth):  # the step's one read back
            w, alpha = _cgs(prefix, w, alpha, sweeps, reduce)
            om_next = torch.where(idx <= j, eps * one, torch.zeros_like(num))
            beta = l2_norm(w, dot)
        om_next = torch.where(idx == j, eps * one, om_next)
        om_next = torch.where(idx == j + 1, one, om_next)
        a_out, b_out, c = _advance(c, executed, alpha, beta, w, tol)
        ah = torch.where(idx == j, a_out, ah)
        bh = torch.where(idx == j, b_out, bh)
        return (
            c, basis, torch.where(executed, om_curr, om_prev),
            torch.where(executed, om_next, om_curr), ah, bh, anorm,
            executed & om_trigger, nre + do_reorth.to(torch.int32),
        ), (a_out, b_out)

    return step


def pass_one_scan_selective(matvec, b: torch.Tensor, k: int, *,
                            sweeps: int = 2, dot: Dot = inner,
                            reduce: Reduce = None
                            ) -> Tuple[LanczosDecomposition, torch.Tensor,
                                       torch.Tensor]:
    """Selectively reorthogonalised pass one: ``(decomposition, basis,
    reorth_steps)``, the first two as :func:`pass_one_scan_reorth`'s and
    ``reorth_steps`` (an int32 0-d tensor) the steps on which the sweeps
    fired: 0 on a benign spectrum (then the run is bitwise the plain
    ``pass_one_scan(emit_basis=True)``), up to k where the spectrum forces
    full reorthogonalisation. The defect stays below ~√ε throughout."""
    _check(k, sweeps)
    rdt = real_dtype(b.dtype)
    c = _start(b, dot)
    basis = torch.zeros((k,) + tuple(b.shape), dtype=b.dtype,
                        device=b.device)

    def zeros():
        return torch.zeros(k + 1, dtype=rdt, device=b.device)

    om0 = zeros()
    om0[0] = 1.0  # ω_{0,0} = 1
    state = (c, basis, zeros(), om0, zeros(), zeros(),
             torch.zeros((), dtype=rdt, device=b.device),
             torch.zeros((), dtype=torch.bool, device=b.device),
             torch.zeros((), dtype=torch.int32, device=b.device))
    step = make_pass_one_step_selective(matvec, b.dtype, sweeps=sweeps,
                                        dot=dot, reduce=reduce)
    state, alphas, betas = _scan(step, b, k, state)
    c, basis, nre = state[0], state[1], state[8]
    return (LanczosDecomposition(alphas, betas, c.steps, c.b_norm), basis,
            nre)
