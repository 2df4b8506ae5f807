"""Property-test runners: the reference's four-property correctness harness.

Counterpart of ``two_pass_lanczos_tpu/testing.py``. The reference
code-generates one test per (data instance × property) at build time
(``build.rs:53-110``, runners at ``src/algorithms/mod.rs:434-587``); here
the runners are a library module, usable from pytest or against any user
operator, with the same four properties at the same tolerances (k = 30,
tol 5e-9, seeded b — ``mod.rs:360``):

1. **decomposition consistency** — one-pass and two-pass pass one produce
   elementwise-identical (α, β) (``mod.rs:434-482``);
2. **Lanczos relation** — ``‖(A·V_k − V_k·T_k) − β_k·v_{k+1}·e_kᵀ‖_F < tol``
   (``mod.rs:486-529``);
3. **orthonormality** — ``‖I − V_kᴴ·V_k‖_F < tol`` (``mod.rs:532-554``);
4. **reconstruction stability** — ``‖V_k − V′_k‖_F² < tol`` with V′ the
   pass-two regenerated basis (``mod.rs:558-587``).

The bases are computed on the operator's device; the norms on the host in
NumPy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.algorithms.one_pass import lanczos_standard
from two_pass_lanczos_tpu_torch.algorithms.two_pass import (
    lanczos_pass_one,
    lanczos_pass_two_with_basis,
)
from two_pass_lanczos_tpu_torch.devices import DEFAULT_DEVICE, resolve_device
from two_pass_lanczos_tpu_torch.ops.tridiag import assemble_tridiagonal

__all__ = [
    "PropertyReport",
    "seeded_b",
    "check_decomposition_consistency",
    "check_lanczos_relation",
    "check_orthonormality",
    "check_reconstruction_stability",
    "run_all_properties",
    "DEFAULT_K",
    "DEFAULT_TOL",
]

DEFAULT_K = 30
DEFAULT_TOL = 5e-9


class PropertyReport(NamedTuple):
    name: str
    value: float
    tolerance: float

    @property
    def passed(self) -> bool:
        return self.value < self.tolerance


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def seeded_b(n: int, seed: int = 42, dtype=torch.float64,
             device=DEFAULT_DEVICE) -> torch.Tensor:
    """Deterministic random starting vector (the harness convention):
    NumPy's ``default_rng(seed)`` normals, as the JAX package draws them."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(n)).to(
        device=resolve_device(device), dtype=dtype)


def check_decomposition_consistency(operator, b, k=DEFAULT_K,
                                    tol=DEFAULT_TOL) -> PropertyReport:
    """One-pass and pass-one (α, β) must match elementwise."""
    d1, _ = lanczos_standard(operator, b, k)
    d2 = lanczos_pass_one(operator, b, k)
    if d1.steps() != d2.steps():
        raise AssertionError("steps_taken differs between variants")
    da = float(np.max(np.abs(d1.alphas_valid() - d2.alphas_valid()),
                      initial=0.0))
    db = float(np.max(np.abs(d1.betas_valid() - d2.betas_valid()),
                      initial=0.0))
    return PropertyReport("decomposition_consistency", max(da, db), tol)


def check_lanczos_relation(operator, b, k=DEFAULT_K,
                           tol=DEFAULT_TOL) -> PropertyReport:
    """``A·V_k − V_k·T_k = β_k·v_{k+1}·e_kᵀ`` to tolerance.

    Runs k+1 steps so that v_{k+1} is available (the reference checks both
    k and k+1; parameterise ``k`` to cover both)."""
    decomp, v_all = lanczos_standard(operator, b, k + 1)
    if decomp.steps() <= 1:
        return PropertyReport("lanczos_relation", 0.0, tol)
    v = _host(v_all)  # (k+1, n): v_1..v_{k+1}
    alphas = _host(decomp.alphas)
    betas = _host(decomp.betas)
    t_k = _host(assemble_tridiagonal(torch.from_numpy(alphas[:k]),
                                     torch.from_numpy(betas[:k - 1])))
    av = np.column_stack([_host(operator.matvec(v_all[i])) for i in range(k)])
    residual = av - v[:k].T @ t_k
    residual[:, -1] -= betas[k - 1] * v[k]
    return PropertyReport("lanczos_relation", float(np.linalg.norm(residual)),
                          tol)


def check_orthonormality(operator, b, k=DEFAULT_K,
                         tol=DEFAULT_TOL) -> PropertyReport:
    """``‖I − V_kᴴ·V_k‖_F`` of the one-pass basis."""
    decomp, v = lanczos_standard(operator, b, k)
    s = decomp.steps()
    v = _host(v)[:s]
    gram = v.conj() @ v.T
    return PropertyReport("orthonormality",
                          float(np.linalg.norm(np.eye(s) - gram)), tol)


def check_reconstruction_stability(operator, b, k=DEFAULT_K,
                                   tol=DEFAULT_TOL) -> PropertyReport:
    """``‖V_k − V′_k‖_F²`` between the stored and the regenerated bases.

    The exact replay makes this 0.0 bit for bit (the reference observes
    exactly 0.0 at every k — ``tex/report.tex:492``)."""
    decomp, v = lanczos_standard(operator, b, k)
    s = decomp.steps()
    # a dummy y (the reference uses ones — orthogonality.rs:190-197)
    y = torch.ones(decomp.k_max, dtype=b.dtype, device=b.device)
    _, v_regen = lanczos_pass_two_with_basis(operator, b, decomp, y)
    drift = float(np.linalg.norm(_host(v)[:s] - _host(v_regen)[:s]) ** 2)
    return PropertyReport("reconstruction_stability", drift, tol)


def run_all_properties(operator, b=None, k=DEFAULT_K,
                       tol=DEFAULT_TOL) -> list:
    """The four-property harness; ``b`` defaults to :func:`seeded_b` in
    the operator's dtype, on its device."""
    if b is None:
        b = seeded_b(operator.shape[0], dtype=operator.dtype,
                     device=operator.device)
    return [
        check_decomposition_consistency(operator, b, k, tol),
        check_lanczos_relation(operator, b, k, tol),
        check_orthonormality(operator, b, k, tol),
        check_reconstruction_stability(operator, b, k, tol),
    ]
