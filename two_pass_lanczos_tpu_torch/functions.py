"""``f(T_k) e₁`` solvers for the projected tridiagonal problem.

Counterpart of ``two_pass_lanczos_tpu/functions.py``:

* :func:`host_f_tk_solve` — NumPy f64 on the valid (α, β) prefix;
* :func:`padded_f_e1` — on the fixed-shape ``(k,)`` decomposition tensors,
  on the decomposition's own device. Padding the diagonal with 1.0 beyond
  ``steps_taken`` makes T block-diagonal ``[T_s, I]``, hence
  ``f(T_pad)·e₁ = [f(T_s)·e₁ ; 0]`` exactly: breakdown costs no accuracy.

The k×k solve is plain ``torch.linalg``, outside any hand-written kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.algorithms.core import LanczosDecomposition
from two_pass_lanczos_tpu_torch.ops.tridiag import _e1, assemble_tridiagonal

__all__ = ["host_f_tk_solve", "padded_f_e1", "FUNC_EXP", "FUNC_INV"]

FUNC_EXP = "exp"
FUNC_INV = "inv"


def host_f_tk_solve(alphas, betas, f) -> np.ndarray:
    """NumPy f64 ``y' = f(T_k)·e1``: ``f`` is "inv" (LU solve), "exp", or a
    callable applied to the spectrum."""
    alphas = np.asarray(alphas, np.float64)
    betas = np.asarray(betas, np.float64)
    steps = len(alphas)
    t = np.diag(alphas)
    if steps > 1:
        t += np.diag(betas, 1) + np.diag(betas, -1)
    e1 = np.zeros(steps)
    e1[0] = 1.0
    if f == FUNC_INV:
        return np.linalg.solve(t, e1)
    if f == FUNC_EXP:
        fn = np.exp
    elif callable(f):
        fn = f
    else:
        raise ValueError(f"unknown matrix function {f!r}")
    lam, q = np.linalg.eigh(t)
    return q @ (fn(lam) * q[0, :])


def _padded_tridiagonal(decomp: LanczosDecomposition) -> torch.Tensor:
    """k×k T with the identity beyond ``steps_taken`` (the residual β_k and
    everything after a breakdown dropped from the off-diagonal)."""
    k = decomp.k_max
    steps = decomp.steps_taken
    i = torch.arange(k, device=decomp.alphas.device)
    one = torch.ones((), dtype=decomp.alphas.dtype, device=decomp.alphas.device)
    diag = torch.where(i < steps, decomp.alphas, one)
    off = torch.where(i[: k - 1] < steps - 1, decomp.betas[: k - 1],
                      torch.zeros_like(one))
    return assemble_tridiagonal(diag, off)


def padded_f_e1(decomp: LanczosDecomposition, f) -> torch.Tensor:
    """``y' = f(T_k)·e₁`` on the padded decomposition, shape ``(k,)``, exact
    zeros beyond ``steps_taken``. ``f`` is "inv" (pivoted solve), "exp", or a
    callable on a tensor of eigenvalues."""
    t = _padded_tridiagonal(decomp)
    k = t.shape[0]
    if f == FUNC_INV:
        y = torch.linalg.solve(t, _e1(k, t))
    else:
        if f == FUNC_EXP:
            fn = torch.exp
        elif callable(f):
            fn = f
        else:
            raise ValueError(f"unknown matrix function {f!r}")
        lam, q = torch.linalg.eigh(t)
        y = q @ (fn(lam) * q[0, :])
    keep = torch.arange(k, device=y.device) < decomp.steps_taken
    return torch.where(keep, y, torch.zeros((), dtype=y.dtype, device=y.device))
