"""Chebyshev expansion f(A)·b — the storage-free alternative to Lanczos.

Counterpart of ``two_pass_lanczos_tpu/algorithms/chebyshev.py``:

    f(A)·b  ≈  Σ_{j=0}^{d} c_j · T_j(Ã)·b,      Ã = (2A − (a+b)I)/(b − a)

by the three-term recurrence T_{j+1} = 2Ã·T_j − T_{j-1}: d matvecs, O(n)
memory, one pass, no basis and no inner product. The interval [a, b] must
hold spec(A); :func:`estimate_interval` finds one with two small
:func:`~two_pass_lanczos_tpu_torch.eigen.eigsh` runs. Coefficients come
from Chebyshev interpolation at the d+1 Chebyshev nodes (host f64 DCT;
exact for polynomials of degree ≤ d).

:func:`chebyshev_scan` runs the recurrence over any matvec on one (n,)
tensor, in the JAX scan's operation order; on a card the matvec is the
operator's kernel (K8 for a KKT operator, K1 in
``FusedKKTSolver.chebyshev_fAb``) and the updates are eager PyTorch.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.algorithms.core import real_dtype
from two_pass_lanczos_tpu_torch.devices import cpu_generator
from two_pass_lanczos_tpu_torch.eigen import eigsh

__all__ = [
    "chebyshev_coefficients",
    "chebyshev_fAb",
    "chebyshev_scan",
    "estimate_interval",
]

FSpec = Union[str, Callable[[np.ndarray], np.ndarray]]


def _f_host(x: np.ndarray, f: FSpec) -> np.ndarray:
    if f == "inv":
        return 1.0 / x
    if f == "exp":
        return np.exp(x)
    if f == "log":
        return np.log(x)
    if callable(f):
        return np.asarray(f(x), np.float64)
    raise ValueError(f"unknown function spec {f!r} (expected 'inv', 'exp', 'log' or a callable)")


def validate_interval_for_f(f: FSpec, a: float, bb: float) -> None:
    """Reject intervals on which the named function is singular: ``inv``
    must not straddle 0 (either sign-definite side is fine); ``log`` needs
    a strictly positive interval."""
    if f == "inv" and a <= 0.0 <= bb:
        raise ValueError(
            f"f='inv' needs a sign-definite spectral interval (not "
            f"containing 0), got ({a}, {bb})")
    if f == "log" and a <= 0.0:
        raise ValueError(
            f"f='log' needs a positive spectral interval, got ({a}, {bb})")


def chebyshev_coefficients(
    f: FSpec, interval: Tuple[float, float], degree: int
) -> np.ndarray:
    """Coefficients c_0..c_degree of the degree-``degree`` Chebyshev
    interpolant of ``f`` on ``interval`` (host f64, cosine-node DCT).
    Exact (to roundoff) for polynomials of degree ≤ ``degree``."""
    a, b = float(interval[0]), float(interval[1])
    if not a < b:
        raise ValueError(f"interval must satisfy a < b, got ({a}, {b})")
    if degree < 0:
        raise ValueError("degree must be >= 0")
    n = degree + 1
    k = np.arange(n)
    x = np.cos(np.pi * (k + 0.5) / n)  # Chebyshev nodes on [-1, 1]
    with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
        fx = _f_host(0.5 * (b - a) * x + 0.5 * (b + a), f)
    if not np.all(np.isfinite(fx)):
        raise ValueError(
            f"f is not finite everywhere on the interval ({a}, {b}) — the "
            "expansion would be NaN. Rescale the operator (e.g. A/‖A‖ for "
            "exp) or shrink the interval.")
    j = np.arange(n)[:, None]
    c = (2.0 / n) * (np.cos(j * np.pi * (k + 0.5) / n) @ fx)
    c[0] *= 0.5
    return c


def estimate_interval(operator, *, margin: float = 0.05, tol: float = 1e-3,
                      key=None) -> Tuple[float, float]:
    """Spectral interval estimate [λ_min, λ_max] via two small
    :func:`~two_pass_lanczos_tpu_torch.eigen.eigsh` runs (LA, then SA, on
    one generator from ``key``, seed 0 by default), widened by the residual
    norms plus a relative ``margin`` (Ritz values approach the spectrum
    from inside)."""
    gen = cpu_generator(0 if key is None else key)
    ncv = min(20, operator.shape[0])
    hi = eigsh(operator, nev=1, which="LA", tol=tol, ncv=ncv, key=gen)
    lo = eigsh(operator, nev=1, which="SA", tol=tol, ncv=ncv, key=gen)
    return interval_from_extremes(hi, lo, margin)


def interval_from_extremes(hi, lo, margin: float) -> Tuple[float, float]:
    """Widen two extreme-eigenpair results (LA and SA
    :class:`~two_pass_lanczos_tpu_torch.eigen.EigshResult`) into a
    Chebyshev interval: residual plus relative margin."""
    lam_hi = float(hi.eigenvalues[-1]) + float(hi.residual_norms[-1])
    lam_lo = float(lo.eigenvalues[0]) - float(lo.residual_norms[0])
    width = max(lam_hi - lam_lo, 1e-12 * max(abs(lam_hi), abs(lam_lo), 1.0))
    a = lam_lo - margin * width
    if lam_lo > 0.0 and a <= 0.0:
        # SPD spectrum: never let the additive margin cross 0 (it would
        # wrongly disqualify f='inv'/'log'); floor at margin·λ_min, which
        # stays below the (residual-widened) λ_min estimate
        a = margin * lam_lo
    return a, lam_hi + margin * width


def chebyshev_fAb(operator, b, f: FSpec, *, degree: int = 100,
                  interval: Optional[Tuple[float, float]] = None,
                  key=None) -> torch.Tensor:
    """``f(A)·b`` by a degree-``degree`` Chebyshev expansion: ``degree``
    matvecs on the operator's device, O(n) memory. ``interval`` must hold
    spec(A); when omitted it is estimated with :func:`estimate_interval`
    (two small eigsh runs — pass it in production). For f = "inv" the
    interval must not contain 0, for "log" it must be positive. ``b`` is
    moved to the operator's device and dtype; returns a tensor there."""
    if interval is None:
        interval = estimate_interval(operator, key=key)
    a, bb = float(interval[0]), float(interval[1])
    validate_interval_for_f(f, a, bb)
    c_host = chebyshev_coefficients(f, interval, degree)
    dev = operator.device
    rdt = real_dtype(operator.dtype)
    coeffs = torch.as_tensor(c_host, dtype=rdt, device=dev)
    scale = torch.tensor([2.0 / (bb - a), (bb + a) / (bb - a)], dtype=rdt,
                         device=dev)
    b = torch.as_tensor(b).to(device=dev, dtype=operator.dtype)
    return chebyshev_scan(operator.matvec, b, coeffs, scale)


def chebyshev_scan(matvec, b_in: torch.Tensor, cs: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """``Σ c_j·T_j(Ã)·b`` over any ``matvec``: ``cs`` (degree + 1,) and
    ``scale`` = (2/(b−a), (b+a)/(b−a)) are tensors on ``b_in``'s device, so
    no step reads anything back. ``len(cs) − 1`` matvecs; the recurrence
    needs no reduction."""
    alpha, beta = scale[0], scale[1]

    def a_tilde(v):
        return alpha * matvec(v) - beta * v

    acc = cs[0] * b_in
    if cs.shape[0] == 1:
        return acc
    t_prev, t_curr = b_in, a_tilde(b_in)
    acc = acc + cs[1] * t_curr
    for c_j in cs[2:]:
        t_next = 2.0 * a_tilde(t_curr) - t_prev
        acc = acc + c_j * t_next
        t_prev, t_curr = t_curr, t_next
    return acc
