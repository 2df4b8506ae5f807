"""Two-pass Lanczos: O(n) memory, 2k matvecs.

Counterpart of ``two_pass_lanczos_tpu/algorithms/two_pass.py`` (reference
``src/algorithms/lanczos_two_pass.rs``). Pass one keeps only the scalars;
pass two regenerates the basis from the stored α and β, never recomputing
an inner product, and accumulates ``x_k = Σ y_j·v_j``. Both passes run the
plain recurrence of ``algorithms/core.py`` on ``operator.matvec``, with the
identical floating-point sequence, so the regenerated basis is bitwise pass
one's (``basis_drift_fro == 0``) as long as the matvec rounds the same way
twice: on a card, the KKT operators' matvec is the deterministic kernel K8.
"""

from __future__ import annotations

from typing import Tuple

import torch

from two_pass_lanczos_tpu_torch.algorithms.core import (
    LanczosDecomposition,
    pass_one_scan,
    pass_two_scan,
)

__all__ = ["lanczos_pass_one", "lanczos_pass_two",
           "lanczos_pass_two_with_basis"]


def lanczos_pass_one(operator, b: torch.Tensor, k: int
                     ) -> LanczosDecomposition:
    """First pass: k recurrence steps, vectors discarded, scalars kept."""
    decomp, _ = pass_one_scan(operator.matvec, b, k)
    return decomp


def _masked(decomposition: LanczosDecomposition, y_k: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """``y_k`` (``(k,)`` or ``(nf, k)``) on b's device and dtype, zero from
    ``steps_taken`` on."""
    y = torch.as_tensor(y_k).to(device=b.device, dtype=b.dtype)
    keep = (torch.arange(decomposition.k_max, device=b.device)
            < decomposition.steps_taken.to(b.device))
    return torch.where(keep, y, torch.zeros((), dtype=b.dtype, device=b.device))


def lanczos_pass_two(operator, b: torch.Tensor,
                     decomposition: LanczosDecomposition,
                     y_k: torch.Tensor) -> torch.Tensor:
    """Second pass: ``x_k = Σ y_j v_j`` with O(n) memory; ``y_k`` may be a
    ``(k,)`` vector or an ``(nf, k)`` stack (``x`` then ``(nf, n)``)."""
    x, _ = pass_two_scan(operator.matvec, b, decomposition,
                         _masked(decomposition, y_k, b))
    return x


def lanczos_pass_two_with_basis(operator, b: torch.Tensor,
                                decomposition: LanczosDecomposition,
                                y_k: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass two that also returns the regenerated ``(k, n)`` basis (zero
    rows beyond ``steps_taken``), for the orthogonality studies and the
    reconstruction-stability property."""
    return pass_two_scan(operator.matvec, b, decomposition,
                         _masked(decomposition, y_k, b), emit_basis=True)
