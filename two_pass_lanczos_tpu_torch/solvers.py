"""High-level f(A)·b solvers over any operator: the generic tier.

Counterpart of ``two_pass_lanczos_tpu/solvers.py`` (reference
``solvers::lanczos`` and ``solvers::lanczos_two_pass``,
``src/solvers.rs:46,133``). Two flavours:

* :func:`lanczos` / :func:`lanczos_two_pass` — host-orchestrated, the
  reference's semantics: a user ``f_tk_solver(alphas, betas) -> y'`` is
  called with the valid coefficient prefix, its result's length is checked,
  and errors map onto the reference taxonomy. α and β come to the host
  once, after pass one, and only there.
* :func:`solve_fAb` — the built-in matrix functions with fixed shapes end
  to end (breakdown handled by block-diagonal padding) and no host
  synchronisation: the fast path.

``reorth=`` (one-pass only, beyond the reference) runs the reorthogonalised
pass one of ``algorithms/reorth.py``: ``True``/``"full"`` sweeps CGS2 every
step, ``"selective"`` only where Simon's ω-recurrence predicts a loss of
semi-orthogonality (one host read a step).

Every pass is the plain PyTorch recurrence of ``algorithms/core.py`` around
``operator.matvec``; a KKT operator on the card runs the hand-written K8
there. ``b`` may be a tensor or an array; it is moved to the operator's
device in its own dtype.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.algorithms.core import (
    LanczosDecomposition,
    basis_product,
    inner,
    pass_one_scan,
    zero_tolerance,
)
from two_pass_lanczos_tpu_torch.algorithms.two_pass import (
    lanczos_pass_two,
    lanczos_pass_two_with_basis,
)
from two_pass_lanczos_tpu_torch.errors import (
    BreakdownError,
    DimensionMismatchError,
    InputError,
    ParameterMismatchError,
    SolverError,
)
from two_pass_lanczos_tpu_torch.functions import padded_f_e1
from two_pass_lanczos_tpu_torch.observability import trace

__all__ = ["lanczos", "lanczos_two_pass", "solve_fAb"]


def _rhs(operator, b) -> torch.Tensor:
    """``b`` as a tensor on the operator's device, in its own dtype."""
    t = b if isinstance(b, torch.Tensor) else torch.from_numpy(np.array(b))
    return t.to(operator.device)


def _validate_inputs(operator, b: torch.Tensor, k: int) -> None:
    n = operator.shape[0]
    if operator.shape[0] != operator.shape[1]:
        raise DimensionMismatchError(operator.shape[0], operator.shape[1],
                                     "operator")
    if tuple(b.shape) != (n,):
        raise DimensionMismatchError(n, b.shape[0] if b.dim() else 0,
                                     "vector b")
    if k < 1:
        raise InputError(f"k must be >= 1, got {k}")


def reorth_mode(reorth):
    """Normalise the ``reorth`` argument: False/None → None, True →
    "full", or one of {"full", "selective"}; anything else raises
    ``ValueError``."""
    if reorth is False or reorth is None:
        return None
    if reorth is True:
        return "full"
    if reorth in ("full", "selective"):
        return reorth
    raise ValueError(
        f"reorth must be a bool, 'full' or 'selective', got {reorth!r}")


def pass_one_reorth(matvec, b: torch.Tensor, k: int, mode: str, *,
                    sweeps: int = 2, dot=inner, reduce=None):
    """The reorthogonalised pass one of ``mode``: ``(decomposition,
    basis)``."""
    from two_pass_lanczos_tpu_torch.algorithms.reorth import (
        pass_one_scan_reorth,
        pass_one_scan_selective,
    )

    if mode == "selective":
        decomp, basis, _ = pass_one_scan_selective(
            matvec, b, k, sweeps=sweeps, dot=dot, reduce=reduce)
        return decomp, basis
    return pass_one_scan_reorth(matvec, b, k, sweeps=sweeps, dot=dot,
                                reduce=reduce)


def _run_f_solver(f_tk_solver, decomp: LanczosDecomposition) -> np.ndarray:
    """Call the user closure(s) on the valid (α, β) prefix and validate.

    ``f_tk_solver`` may be one closure (a ``(steps,)`` result) or a
    sequence of them (a stacked ``(nf, steps)`` result; the solvers then
    share the basis work across all of them)."""
    steps = decomp.steps()
    alphas = decomp.alphas_valid()
    betas = decomp.betas_valid()
    multi = isinstance(f_tk_solver, (list, tuple))
    solvers = list(f_tk_solver) if multi else [f_tk_solver]
    ys = []
    for solver in solvers:
        try:
            y = solver(alphas, betas)
        except Exception as e:  # noqa: BLE001 — the reference wraps any error
            raise SolverError(str(e)) from e
        if isinstance(y, torch.Tensor):
            y = y.detach().cpu().numpy()
        y = np.asarray(y).reshape(-1)
        if y.shape[0] != steps:
            raise ParameterMismatchError("y_k_prime", steps, y.shape[0])
        ys.append(y)
    return np.stack(ys) if multi else ys[0]


def _check_zero_b(decomp: LanczosDecomposition, b: torch.Tensor) -> None:
    if float(decomp.b_norm) <= zero_tolerance(b.dtype):
        raise InputError("Input vector `b` must not be a zero vector.")


def _check_strict_breakdown(decomp: LanczosDecomposition, k: int,
                            strict: bool) -> None:
    """Opt-in fatal breakdown (reference ``LanczosErrorKind::Breakdown``):
    raise if the subspace became invariant before k steps. A callback stop
    is not a breakdown: its residual β stays positive."""
    if strict and decomp.steps() < k and decomp.beta_last() == 0.0:
        raise BreakdownError(decomp.steps())


def _scaled_y(y: np.ndarray, k: int, decomp: LanczosDecomposition,
              b: torch.Tensor) -> torch.Tensor:
    """``y`` padded with zeros to length ``k``, on b's device and dtype,
    times ‖b‖."""
    steps = y.shape[-1]
    y_full = np.zeros(y.shape[:-1] + (k,), dtype=y.dtype)
    y_full[..., :steps] = y
    return (torch.from_numpy(y_full).to(device=b.device, dtype=b.dtype)
            * decomp.b_norm.to(b.dtype))


def lanczos(operator, b, k: int, f_tk_solver: Callable, *,
            callback: Callable = None, callback_chunk: int = 16,
            strict_breakdown: bool = False, reorth=False,
            reorth_sweeps: int = 2) -> torch.Tensor:
    """One-pass f(A)·b: ``lanczos_standard``, the projected solve, then
    ``x_k = V_kᵀ·y'·‖b‖`` as one GEMV per f (reference ``solvers::lanczos``,
    ``src/solvers.rs:46-105``).

    ``f_tk_solver`` may be a sequence of closures (result ``(nf, n)``).
    ``callback(steps, V_view, (alphas, betas)) -> bool`` stops the run in
    place (``algorithms/chunked.py``), checked every ``callback_chunk``
    steps. ``strict_breakdown=True`` raises :class:`BreakdownError` instead
    of truncating when the Krylov subspace becomes invariant before ``k``.
    ``reorth=True``/``"full"`` reorthogonalises every step against the
    stored basis (``reorth_sweeps`` CGS sweeps, 2 by default), and
    ``"selective"`` only where the ω-recurrence asks for it
    (``algorithms/reorth.py``); neither takes a ``callback``.
    """
    b = _rhs(operator, b)
    _validate_inputs(operator, b, k)
    mode = reorth_mode(reorth)
    if mode is not None:
        if callback is not None:
            raise InputError(
                "reorth= is not supported together with callback= (the "
                "chunked early-stop driver runs the plain recurrence); use "
                "a plain run to locate the stopping step, or reorth without "
                "a callback.")
        decomp, v_k = pass_one_reorth(operator.matvec, b, k, mode,
                                      sweeps=reorth_sweeps)
    elif callback is not None:
        from two_pass_lanczos_tpu_torch.algorithms.chunked import (
            lanczos_standard_chunked,
        )

        decomp, v_k = lanczos_standard_chunked(operator, b, k, callback,
                                               chunk=callback_chunk)
    else:
        decomp, v_k = pass_one_scan(operator.matvec, b, k, emit_basis=True)
    _check_zero_b(decomp, b)
    _check_strict_breakdown(decomp, k, strict_breakdown)
    y = _run_f_solver(f_tk_solver, decomp)
    # rows of v_k beyond `steps` are zero
    return basis_product(_scaled_y(y, k, decomp, b), v_k)


def lanczos_two_pass(operator, b, k: int, f_tk_solver: Callable, *,
                     return_basis: bool = False, callback: Callable = None,
                     callback_chunk: int = 16,
                     strict_breakdown: bool = False):
    """Two-pass f(A)·b with O(n) memory (reference
    ``solvers::lanczos_two_pass``, ``src/solvers.rs:133-175``): pass one →
    ``f_tk_solver`` → scale by ‖b‖ → reconstruction pass.

    ``f_tk_solver`` may be a sequence of closures: the reconstruction pass
    fans the accumulate out over all of them (2k matvecs for nf functions,
    result ``(nf, n)``). ``return_basis=True`` also returns the regenerated
    ``(k, n)`` basis. ``callback`` stops pass one in place, and a stop at
    step s shortens pass two to s steps. ``strict_breakdown=True`` raises
    :class:`BreakdownError` on an invariant subspace instead of truncating.
    """
    b = _rhs(operator, b)
    _validate_inputs(operator, b, k)
    if callback is not None:
        from two_pass_lanczos_tpu_torch.algorithms.chunked import (
            lanczos_pass_one_chunked,
        )

        decomp = lanczos_pass_one_chunked(operator, b, k, callback,
                                          chunk=callback_chunk)
    else:
        decomp, _ = pass_one_scan(operator.matvec, b, k)
    _check_zero_b(decomp, b)
    _check_strict_breakdown(decomp, k, strict_breakdown)
    steps = decomp.steps()
    y = _run_f_solver(f_tk_solver, decomp)
    # pass two runs the executed prefix only: after an early stop or a
    # breakdown the masked loop would still run k matvecs on frozen state
    # (the reference's pass two runs steps-1 matvecs,
    # src/algorithms/lanczos_two_pass.rs:266)
    if steps < k:
        decomp = LanczosDecomposition(
            alphas=decomp.alphas[:steps], betas=decomp.betas[:steps],
            steps_taken=decomp.steps_taken, b_norm=decomp.b_norm)
    y_dev = _scaled_y(y, decomp.k_max, decomp, b)
    if return_basis:
        x, basis = lanczos_pass_two_with_basis(operator, b, decomp, y_dev)
        if steps < k:  # the static (k, n) shape of the basis
            basis = torch.cat([basis, basis.new_zeros((k - steps,
                                                       basis.shape[1]))])
        return x, basis
    return lanczos_pass_two(operator, b, decomp, y_dev)


def solve_fAb(operator, b, *, k: int, f="exp", method: str = "two_pass",
              reorth=False) -> torch.Tensor:
    """f(A)·b for built-in matrix functions.

    On a card the passes over a ``SparseOperator`` queue their work
    without waiting for the device; f(T_k)·e₁ waits for it, twice a solve
    for ``f="inv"`` (``ops/tridiag._e1`` stores e₁'s 1 from the host, and
    ``torch.linalg.solve`` reads the LU's ``info`` back), inside the span
    ``tpl.f_tk``.

    ``f`` ∈ {"exp", "inv"} or a callable on a tensor of eigenvalues, or a
    TUPLE of those: the Krylov work is paid once and the result is stacked
    ``(nf, n)``. ``method`` ∈ {"one_pass", "two_pass"}. Fixed shapes
    throughout: a breakdown and a zero b degrade gracefully (zero output).
    ``reorth=True``/``"full"`` or ``"selective"`` (one-pass only) runs the
    reorthogonalised pass one of ``algorithms/reorth.py``.
    """
    mode = reorth_mode(reorth)
    if mode is not None and method != "one_pass":
        raise ValueError(
            "reorth= requires method='one_pass' (reorthogonalisation "
            "needs the stored basis; two-pass exists precisely to avoid "
            "storing it)")
    if method not in ("one_pass", "two_pass"):
        raise ValueError(f"unknown method {method!r}")
    multi = isinstance(f, tuple)
    with trace("tpl.solve"):
        b = _rhs(operator, b)
        with trace("tpl.pass_one"):
            if mode is not None:
                decomp, v_k = pass_one_reorth(operator.matvec, b, k, mode)
            else:
                decomp, v_k = pass_one_scan(operator.matvec, b, k,
                                            emit_basis=method == "one_pass")
        with trace("tpl.f_tk"):
            y = torch.stack([padded_f_e1(decomp, fi)
                             for fi in (f if multi else (f,))])
            y = (y * decomp.b_norm).to(b.dtype)
        y = y if multi else y[0]
        if method == "one_pass":
            with trace("tpl.basis_product"):
                return basis_product(y, v_k)
        with trace("tpl.pass_two"):
            return lanczos_pass_two(operator, b, decomp, y)
