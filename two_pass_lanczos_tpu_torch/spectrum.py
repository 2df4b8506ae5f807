"""Spectral analysis from a Lanczos decomposition: host-side NumPy/SciPy f64.

Counterpart of ``two_pass_lanczos_tpu/spectrum.py`` (NumPy only, copied so
the port never imports jax). This slice carries the Gauss–Radau helpers
that ``convergence.radau_error_bound`` stands on; the Ritz and quadrature
functions of the JAX module are still to be copied (ROADMAP Queue 1 item 2).
"""

from __future__ import annotations

import numpy as np

__all__ = []


def _tridiag_inv_e1_first(d, e):
    """``e₁ᵀT⁻¹e₁`` for symmetric tridiagonal T — one O(s) banded solve."""
    s = d.size
    if s == 1:
        return 1.0 / d[0]
    from scipy.linalg import solve_banded

    rhs = np.zeros(s)
    rhs[0] = 1.0
    ab = np.zeros((3, s))
    ab[0, 1:] = e
    ab[1, :] = d
    ab[2, :-1] = e
    return float(solve_banded((1, 1), ab, rhs)[0])


def _radau_extended(d, e, beta, zeta):
    """The Golub–Meurant Gauss–Radau extension of tridiagonal T (node
    fixed at ζ): append α̂ = ζ + δ_s with δ = (T − ζI)⁻¹·β²e_s (the
    boundary modification), coupled by β. Returns ``(d_hat, e_hat)`` —
    the ONE implementation shared by :func:`gauss_radau_bracket` and the
    error-certificate path. One O(s) banded solve."""
    s = d.size
    rhs = np.zeros(s)
    rhs[-1] = beta**2
    if s == 1:
        delta_last = rhs[0] / (d[0] - zeta)
    else:
        from scipy.linalg import solve_banded

        ab = np.zeros((3, s))
        ab[0, 1:] = e
        ab[1, :] = d - zeta
        ab[2, :-1] = e
        delta_last = solve_banded((1, 1), ab, rhs)[-1]
    return (np.concatenate([d, [zeta + delta_last]]),
            np.concatenate([e, [beta]]))


def _radau_inv_e1_first(d, e, beta_j, zeta):
    """``e₁ᵀT̂⁻¹e₁`` over the Radau extension — two O(s) banded solves."""
    d_hat, e_hat = _radau_extended(d, e, beta_j, zeta)
    return _tridiag_inv_e1_first(d_hat, e_hat)


def _cert_slack(u: float, g: float) -> float:
    """Resolution floor of the quadrature-difference certificate: once
    ``U − G`` shrinks to a few ulps of the quadrature values themselves,
    the f64 subtraction is noise and can even go ≤ 0 while the true error
    is still ~√ε·‖x‖_A. Flooring the difference at 4 ulps keeps the upper
    bound VALID (never smaller than what f64 can resolve) at the cost of
    saturating around √(4ε) ≈ 3e−8 relative — certifying below that needs
    higher-precision coefficients (the df path)."""
    return 4.0 * float(np.finfo(np.float64).eps) * max(abs(u), abs(g))
