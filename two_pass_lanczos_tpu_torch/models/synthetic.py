"""Synthetic problems with controlled spectra.

Counterpart of ``two_pass_lanczos_tpu/models/synthetic.py``. Reference
parity: ``create_diagonal_problem`` (``src/bin/stability.rs:98-157``) — four
(function × conditioning) scenarios whose analytic ground truth
``x_true_i = f(λ_i)·b_i`` drives the accuracy and orthogonality
experiments — and the dense random symmetric benchmark matrix of
``dense_tradeoff`` (``src/bin/dense_tradeoff.rs:156-158``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.devices import DEFAULT_DEVICE
from two_pass_lanczos_tpu_torch.operators import DenseOperator, DiagonalOperator

__all__ = ["create_diagonal_problem", "dense_random_symmetric", "SCENARIOS"]

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
