"""Standard one-pass Lanczos: full basis stored, O(nk) memory.

Counterpart of ``two_pass_lanczos_tpu/algorithms/one_pass.py`` (reference
``lanczos_standard``, ``src/algorithms/lanczos.rs:55-156``). The basis is a
``(k, n)`` tensor on the operator's device, row ``i`` = v_{i+1}, so
``x = Vᵀ·y`` is one GEMV; rows past a breakdown are zero.
"""

from __future__ import annotations

from typing import Tuple

import torch

from two_pass_lanczos_tpu_torch.algorithms.core import (
    LanczosDecomposition,
    pass_one_scan,
)

__all__ = ["lanczos_standard"]


def lanczos_standard(operator, b: torch.Tensor, k: int
                     ) -> Tuple[LanczosDecomposition, torch.Tensor]:
    """Run k Lanczos steps storing the basis: ``(decomposition, v_k)`` with
    ``v_k`` of shape ``(k, n)``."""
    return pass_one_scan(operator.matvec, b, k, emit_basis=True)
