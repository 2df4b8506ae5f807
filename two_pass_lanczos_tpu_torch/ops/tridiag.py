"""Tridiagonal utilities for the projected system T_k.

Counterpart of ``two_pass_lanczos_tpu/ops/tridiag.py``. T_k is tiny
(k ≤ ~1000), so it is assembled dense and handed to ``torch.linalg``: a
pivoted LU solve for ``f = inv`` (stable on the indefinite spectra, unlike
the Thomas algorithm) and a symmetric eigendecomposition for any other f.
"""

from __future__ import annotations

import torch

__all__ = ["assemble_tridiagonal", "tridiagonal_solve_e1", "eigh_tridiagonal"]


def assemble_tridiagonal(alphas: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """Dense symmetric tridiagonal matrix from the diagonal ``alphas``
    (length k) and the off-diagonal ``betas`` (length k-1)."""
    t = torch.diag(alphas)
    if alphas.shape[0] > 1:
        t = t + torch.diag(betas, 1) + torch.diag(betas, -1)
    return t


def _e1(k: int, like: torch.Tensor) -> torch.Tensor:
    e1 = torch.zeros(k, dtype=like.dtype, device=like.device)
    e1[0] = 1.0
    return e1


def tridiagonal_solve_e1(alphas: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """Solve ``T_k y = e₁`` with a pivoted dense LU."""
    t = assemble_tridiagonal(alphas, betas)
    return torch.linalg.solve(t, _e1(t.shape[0], t))


def eigh_tridiagonal(alphas: torch.Tensor, betas: torch.Tensor):
    """``T_k = Q Λ Qᵀ``; returns ``(eigenvalues, eigenvectors)``."""
    return torch.linalg.eigh(assemble_tridiagonal(alphas, betas))
