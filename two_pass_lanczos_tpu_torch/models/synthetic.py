"""Synthetic problems with controlled spectra.

Counterpart of ``two_pass_lanczos_tpu/models/synthetic.py``. Reference
parity: ``create_diagonal_problem`` (``src/bin/stability.rs:98-157``) — four
(function × conditioning) scenarios whose analytic ground truth
``x_true_i = f(λ_i)·b_i`` drives the accuracy and orthogonality
experiments — and the dense random symmetric benchmark matrix of
``dense_tradeoff`` (``src/bin/dense_tradeoff.rs:156-158``). Besides them,
the port's complex Hermitian sparse problem: the Hofstadter magnetic
Laplacian (:func:`hofstadter_triplets`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.devices import DEFAULT_DEVICE
from two_pass_lanczos_tpu_torch.operators import DenseOperator, DiagonalOperator

__all__ = ["create_diagonal_problem", "dense_random_symmetric", "SCENARIOS",
           "hofstadter_triplets"]

#: (function, scenario) pairs accepted by :func:`create_diagonal_problem`.
SCENARIOS = [
    ("exp", "well-conditioned"),
    ("exp", "ill-conditioned"),
    ("inv", "well-conditioned"),
    ("inv", "ill-conditioned"),
]


def create_diagonal_problem(n: int, scenario: str, func: str,
                            dtype=torch.float64, device=DEFAULT_DEVICE
                            ) -> Tuple[DiagonalOperator, np.ndarray]:
    """Diagonal operator with the reference's controlled spectra.

    Exact constants from ``src/bin/stability.rs:106-145``:

    * exp / well-conditioned: λ linspaced over ``[-10, -0.1]``
    * exp / ill-conditioned:  λ linspaced over ``[-1000, -0.1]``
    * inv / well-conditioned: λ linspaced over ``[0.1, 100]``
    * inv / ill-conditioned:  indefinite ``[0.1, 1] ∪ [-1, -0.1]`` with the
      critical eigenvalue ``λ[n//2] = 1e-8``

    Returns ``(operator, eigenvalues)``, the eigenvalues as NumPy f64 for
    the exact ground truth on the host.
    """
    if func not in ("exp", "inv"):
        raise ValueError(f"unknown function {func!r}")
    if scenario not in ("well-conditioned", "ill-conditioned"):
        raise ValueError(f"unknown scenario {scenario!r}")

    i = np.arange(n, dtype=np.float64)
    denom = max(n - 1, 1)
    if func == "exp" and scenario == "well-conditioned":
        eigs = -10.0 + (9.9 / denom) * i
    elif func == "exp" and scenario == "ill-conditioned":
        eigs = -1000.0 + (999.9 / denom) * i
    elif func == "inv" and scenario == "well-conditioned":
        eigs = 0.1 + (99.9 / denom) * i
    else:  # inv / ill-conditioned
        mid = n // 2
        eigs = np.empty(n, dtype=np.float64)
        lo = np.arange(mid, dtype=np.float64)
        eigs[:mid] = 0.1 + (0.9 / max(mid - 1, 1)) * lo
        hi = np.arange(n - mid, dtype=np.float64)
        eigs[mid:] = -1.0 + (0.9 / max(n - mid - 1, 1)) * hi
        eigs[mid] = 1e-8  # the critical near-singular eigenvalue

    op = DiagonalOperator(torch.from_numpy(eigs).to(dtype), device=device)
    return op, eigs


def dense_random_symmetric(n: int, seed: int = 42, dtype=torch.float64,
                           device=DEFAULT_DEVICE) -> DenseOperator:
    """Dense symmetric ``A = B + Bᵀ`` with i.i.d. uniform B (NumPy seed
    ``seed``): the compute-bound matrix of the reference's dense tradeoff
    experiment (``src/bin/dense_tradeoff.rs:150-158``, seed 42)."""
    rng = np.random.default_rng(seed)
    b = rng.uniform(-1.0, 1.0, size=(n, n))
    return DenseOperator(torch.from_numpy(b + b.T).to(dtype), device=device)


def hofstadter_triplets(side: int, flux_den: int, shift: float = 0.0):
    """COO triplets ``(n, rows, cols, vals)`` of the magnetic Laplacian
    ``H + shift·I`` of a particle on the periodic ``side`` × ``side`` square
    lattice in a uniform field of flux ``1/flux_den`` quanta per plaquette
    (Hofstadter, Phys. Rev. B 14, 2239, 1976), in the Landau gauge::

        (Hψ)(x, y) = 4ψ(x, y) − ψ(x+1, y) − ψ(x−1, y)
                     − e^{2πiφx} ψ(x, y+1) − e^{−2πiφx} ψ(x, y−1)

    with φ = 1/flux_den; ``flux_den`` must divide ``side`` for the gauge to
    close around the torus. Site (x, y) is row ``x·side + y``; the five
    entries of a row are its diagonal and its four bonds, so
    ``nnz = 5·side²``, and the values are complex128. H is Hermitian with
    its spectrum in [0, 8], so ``shift > 0`` makes it positive definite
    with κ ≤ (8 + shift)/shift. Built on the host with NumPy."""
    if side < 3 or flux_den < 1 or side % flux_den:
        raise ValueError(f"flux 1/{flux_den} does not close on a "
                         f"{side} x {side} torus (side >= 3)")
    x, y = np.divmod(np.arange(side * side, dtype=np.int64), side)
    site = x * side + y
    phase = np.exp(2j * np.pi * x / flux_den)

    def at(xx, yy):
        return (xx % side) * side + (yy % side)

    rows = np.concatenate([site] * 5)
    cols = np.concatenate([site, at(x + 1, y), at(x - 1, y), at(x, y + 1),
                           at(x, y - 1)])
    ones = np.ones(site.size, np.complex128)
    vals = np.concatenate([(4.0 + shift) * ones, -ones, -ones, -phase,
                           -phase.conj()])
    return side * side, rows, cols, vals
