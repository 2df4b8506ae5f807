"""Coefficient-only convergence estimation and ready-made stopping callbacks.

A NumPy-only copy of ``two_pass_lanczos_tpu/convergence.py`` for the port
(importing the JAX package's module would run that package's ``__init__``,
which imports jax). In the port the callbacks plug into
``FusedKKTSolver.solve(callback=...)`` and ``pass_one_chunked`` unchanged.

The reference exposes a per-iteration ``LanczosCallback`` hook
(``src/algorithms/mod.rs:69-86``, ``src/algorithms/lanczos.rs:93-113``) but
leaves the stopping *criterion* entirely to the user. This module supplies
the standard criterion for f(A)·b Lanczos — the lagged difference of
iterates — in a form that needs **only the (α, β) coefficients**, so it
plugs into every callback-accepting path (in the port, the fused chunked
pass one) without ever materializing the Krylov basis.

The identity it rests on: the Lanczos approximation after ``s`` steps is
``x_s = ‖b‖ · V_s · y_s`` with ``y_s = f(T_s)e₁``. For ``j < s``, ``x_j``
lies in the same basis (``x_j = ‖b‖ · V_s · ŷ_j`` with ``ŷ_j`` the
zero-padding of ``y_j`` to length ``s``), so while V is orthonormal,

    ‖x_s − x_j‖₂ = ‖b‖ · ‖y_s − ŷ_j‖₂            (exactly)

— the *n*-dimensional update norm collapses to an *s*-dimensional one that
involves only the tridiagonal coefficients. The lagged difference
``d_s = ‖y_s − ŷ_{s−lag}‖ / ‖y_s‖`` is the classical practical estimate of
the relative error decrement (Golub & Meurant's quadrature view of the same
quantity); ``lag > 1`` guards against the plateaus that single-step
differences show on indefinite spectra.

Caveat (documented, tested): in finite precision orthonormality degrades as
k grows (see the orthogonality CSVs), so past the orthogonality cliff the
identity holds only approximately — the estimator remains the standard
practical criterion but is no longer an exact norm translation.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from two_pass_lanczos_tpu_torch.functions import host_f_tk_solve

__all__ = [
    "update_norm",
    "convergence_history",
    "make_convergence_callback",
    "radau_error_bound",
    "make_radau_error_callback",
]


def update_norm(alphas, betas, f, *, lag: int = 10) -> float:
    """Relative lagged update ``‖ŷ_s − ŷ_{s−lag}‖ / ‖y_s‖`` from coefficients.

    ``alphas``/``betas`` are the valid coefficient prefix after ``s`` steps
    (lengths ``s`` and ``s−1``, the callback/view convention); ``f`` is
    anything :func:`~two_pass_lanczos_tpu_torch.functions.host_f_tk_solve` accepts
    ("inv", "exp", or a scalar callable). Returns ``inf`` while ``s ≤ lag``.
    """
    alphas = np.asarray(alphas, np.float64)
    s = alphas.shape[0]
    if s <= lag:
        return float("inf")
    betas = np.asarray(betas, np.float64)
    y_s = host_f_tk_solve(alphas, betas[: s - 1], f)
    y_j = host_f_tk_solve(alphas[: s - lag], betas[: s - lag - 1], f)
    diff = y_s.copy()
    diff[: s - lag] -= y_j
    denom = np.linalg.norm(y_s)
    return float(np.linalg.norm(diff) / denom) if denom > 0 else float("inf")


def convergence_history(
    alphas,
    betas,
    f,
    *,
    lag: int = 10,
    stride: int = 1,
) -> List[Tuple[int, float]]:
    """Post-hoc ``(s, d_s)`` series over a stored coefficient sequence.

    Evaluates the lagged relative update at ``s = lag+1, lag+1+stride, …``
    up to ``len(alphas)``. Cost is one tiny host projected solve per entry
    (O(s) for "inv" via the tridiagonal solve inside ``host_f_tk_solve``'s
    LU, O(s³) worst-case for the EVD route) — use ``stride`` to thin the
    series for the EVD functions at large k.
    """
    alphas = np.asarray(alphas, np.float64)
    betas = np.asarray(betas, np.float64)
    out: List[Tuple[int, float]] = []
    for s in range(lag + 1, alphas.shape[0] + 1, stride):
        out.append((s, update_norm(alphas[:s], betas[: s - 1], f, lag=lag)))
    return out


def make_convergence_callback(
    f,
    tol: float,
    *,
    lag: int = 10,
    stride: Optional[int] = None,
    min_steps: int = 0,
) -> Callable:
    """A ready-made early-stop callback: stop when the lagged relative
    update drops below ``tol``.

    Returns a callback with the library-wide signature
    ``callback(steps, V_view, (alphas, betas)) -> bool`` (``False`` = stop)
    accepted by ``FusedKKTSolver.solve`` and
    ``FusedKKTSolver.pass_one_chunked`` (and, in the JAX package, by its
    host and sharded solvers) — it ignores the basis view, so the
    scalars-only paths work unchanged.

    ``stride`` sets how often the projected solve runs (default: every
    ``lag`` iterations — the estimate cannot change class faster than its
    own lag); ``min_steps`` defers the first check (e.g. past a known
    indefinite-spectrum transient). The evaluated series is recorded on the
    returned callback as ``callback.history`` (list of ``(s, d_s)``) and the
    triggering step as ``callback.stopped_at`` (``None`` if it never fired).
    """
    stride_eff = lag if stride is None else stride
    if stride_eff < 1:
        raise ValueError("stride must be >= 1")
    history: List[Tuple[int, float]] = []

    def callback(steps, v_view, coeffs):  # noqa: ARG001 — basis unused
        if steps < max(min_steps, lag + 1) or (steps - lag - 1) % stride_eff:
            return True
        alphas, betas = coeffs
        d = update_norm(alphas, betas, f, lag=lag)
        history.append((int(steps), d))
        if d <= tol:
            callback.stopped_at = int(steps)
            return False
        return True

    callback.history = history
    callback.stopped_at = None
    return callback


def radau_error_bound(alphas, betas, lambda_min: float) -> float:
    """Rigorous RELATIVE A-norm error bound for the f = inv iterate, from
    the live coefficient prefix (the callback view): with ``s = len
    (alphas)`` steps visible, certifies the step-``s−1`` iterate —
    the Radau extension needs the coupling β_{s−1}, which in the callback
    convention (``betas`` has ``s−1`` entries) is the last visible β.

    Returns ``sqrt(max(U_j − G_j, 0) / G_j)`` with ``j = s−1``: the
    Golub–Meurant enclosure ``‖x − x_j‖_A ≤ ‖b‖·√(U_j − G_j)`` scaled by
    ``‖x_j‖_A ≈ ‖b‖·√(G_j)`` (see :func:`spectrum.a_norm_error_history`
    for the identity). ``inf`` until j ≥ 1; ``0.0`` on breakdown
    (β = 0 ⇒ the subspace is invariant and the iterate exact). SPD A
    only (``lambda_min`` > 0 required).
    """
    from two_pass_lanczos_tpu_torch.spectrum import (
        _radau_inv_e1_first,
        _tridiag_inv_e1_first,
    )

    if lambda_min <= 0.0:
        raise ValueError("radau_error_bound requires lambda_min > 0 (SPD A)")
    alphas = np.asarray(alphas, np.float64)
    betas = np.asarray(betas, np.float64)
    j = alphas.shape[0] - 1
    if j < 1:
        return float("inf")
    beta_j = betas[j - 1]
    if beta_j == 0.0:
        return 0.0
    from two_pass_lanczos_tpu_torch.spectrum import _cert_slack

    g_j = _tridiag_inv_e1_first(alphas[:j], betas[: j - 1])
    u_j = _radau_inv_e1_first(alphas[:j], betas[: j - 1], beta_j, lambda_min)
    if g_j <= 0.0:
        return float("inf")
    # floor at the f64 resolution of the subtraction (see _cert_slack):
    # the bound saturates near sqrt(4*eps) ~ 3e-8 relative — tolerances
    # below that are not certifiable from f64 coefficients.
    return float(np.sqrt(max(u_j - g_j, _cert_slack(u_j, g_j)) / g_j))


def make_radau_error_callback(lambda_min: float, tol: float, *,
                              stride: int = 1, min_steps: int = 2):
    """An early-stop callback with a CERTIFICATE: stop once the rigorous
    Gauss–Radau bound on the relative A-norm error of the f = inv solve
    drops below ``tol`` (SPD A with λ_min ≥ ``lambda_min`` > 0).

    Unlike :func:`make_convergence_callback` (a lagged-update *estimate*,
    any f, any symmetric A), this stop is backed by the Golub–Meurant
    enclosure — when it fires, ``‖x − x_j‖_A / ‖x_j‖_A ≤ tol`` holds up to
    finite-precision slack. Same library-wide callback signature; works on
    every callback-accepting path (in the port, the fused chunked pass
    one). Evaluated bounds are recorded as ``callback.history``
    (``(step_certified, bound)`` pairs) and the firing step as
    ``callback.stopped_at``.

    Resolution floor: the bound saturates near √(4ε_f64) ≈ 3e−8 relative
    (see :func:`radau_error_bound`) — a ``tol`` below that never fires
    (except on exact breakdown) and the run honestly continues to k.
    """
    if stride < 1:
        raise ValueError("stride must be >= 1")
    history: List[Tuple[int, float]] = []

    def callback(steps, v_view, coeffs):  # noqa: ARG001 — basis unused
        if steps < max(min_steps, 2) or (steps - 2) % stride:
            return True
        alphas, betas = coeffs
        bound = radau_error_bound(alphas, betas, lambda_min)
        history.append((int(steps) - 1, bound))
        if bound <= tol:
            callback.stopped_at = int(steps)
            return False
        return True

    callback.history = history
    callback.stopped_at = None
    return callback
