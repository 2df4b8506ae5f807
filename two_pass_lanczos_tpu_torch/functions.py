"""``f(T_k) e₁`` solvers for the projected tridiagonal problem.

Counterpart of ``two_pass_lanczos_tpu/functions.py``:

* :func:`host_f_tk_solve` — NumPy f64 on the valid (α, β) prefix;
* host closures (:func:`make_inv_solver` etc.) — the reference's pluggable
  ``f_tk_solver(alphas, betas) -> f(T_k)·e₁`` for the generic solvers
  (``solvers.py``): called with the valid (α, β) prefix as NumPy arrays,
  they compute on the CPU in the prefix's dtype and return a
  length-``steps`` tensor;
* :func:`padded_f_e1` — on the fixed-shape ``(k,)`` decomposition tensors,
  on the decomposition's own device. Padding the diagonal with 1.0 beyond
  ``steps_taken`` makes T block-diagonal ``[T_s, I]``, hence
  ``f(T_pad)·e₁ = [f(T_s)·e₁ ; 0]`` exactly: breakdown costs no accuracy.

The k×k solve is plain ``torch.linalg``, outside any hand-written kernel.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.algorithms.core import LanczosDecomposition
from two_pass_lanczos_tpu_torch.ops.tridiag import (
    _e1,
    assemble_tridiagonal,
    eigh_tridiagonal,
    tridiagonal_solve_e1,
)

__all__ = ["host_f_tk_solve", "make_inv_solver", "make_exp_solver",
           "make_function_solver", "make_poly_solver", "padded_f_e1",
           "FUNC_EXP", "FUNC_INV"]

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


def make_inv_solver() -> Callable:
    """``f(z) = 1/z``: solve ``T_k y = e₁`` with a pivoted dense LU (stable
    on the indefinite spectra; the reference uses faer's sparse LU,
    ``src/bin/stability.rs:161-170``)."""

    def solver(alphas, betas):
        return tridiagonal_solve_e1(torch.as_tensor(alphas),
                                    torch.as_tensor(betas))

    return solver


def make_exp_solver() -> Callable:
    """``f(z) = exp(z)`` via the symmetric eigendecomposition,
    ``Q·exp(Λ)·Qᵀ·e₁`` (reference ``exp_tk_solver``,
    ``src/bin/stability.rs:175-193``)."""
    return make_function_solver(torch.exp)


def make_function_solver(f: Callable) -> Callable:
    """``f(T_k)·e₁`` for any scalar function ``f`` of a tensor of
    eigenvalues, via the symmetric eigendecomposition of T_k."""

    def solver(alphas, betas):
        lam, q = eigh_tridiagonal(torch.as_tensor(alphas),
                                  torch.as_tensor(betas))
        # f(T) e1 = Q f(Λ) Qᵀ e1: only the first row of Q is needed
        return q @ (f(lam) * q[0, :])

    return solver


def make_poly_solver(coeffs) -> Callable:
    """``f(z) = Σ c_i z^i`` (ascending coefficients), exact when
    ``k > deg f``: the sharp oracle of the reference's ``z²`` test
    (``tests/correctness.rs:42-51``)."""
    coeffs = list(coeffs)

    def f(lam):
        acc = torch.zeros_like(lam)
        for c in reversed(coeffs):
            acc = acc * lam + c
        return acc

    return make_function_solver(f)


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
