"""Plain PyTorch KKT matvec: the oracle for the CUDA matvec kernel.

Counterpart of ``kkt_matvec`` in ``two_pass_lanczos_tpu/ops/spmv.py``. The
KKT matrix ``A = [[D, Eᵀ], [E, 0]]`` is never materialised: ``E`` is the
node–arc incidence matrix with ``E[u_j, j] = +1`` and ``E[v_j, j] = -1``, so

* top block:    ``y_a = d ⊙ x_a + x_n[u] − x_n[v]``   (D·x_a + Eᵀ·x_n)
* bottom block: ``y_n = scatter_add(+x_a → u, −x_a → v)``  (E·x_a)

with ``x = [x_a (m), x_n (p)]``. On CUDA ``index_add_`` is atomic, so this
version is nondeterministic there; it is a reference, never the Lanczos path
(the path uses ``csrc/kkt_matvec.cu``).
"""

from __future__ import annotations

import torch

__all__ = ["kkt_matvec"]


def kkt_matvec(d: torch.Tensor, arc_u: torch.Tensor, arc_v: torch.Tensor,
               num_nodes: int, x: torch.Tensor) -> torch.Tensor:
    """``y = A·x`` for the KKT matrix; dtype-generic (``d`` and ``x`` share
    a dtype), ``arc_u``/``arc_v`` are 0-based integer endpoint tensors."""
    m = d.shape[0]
    x_a, x_n = x[:m], x[m:]
    y_a = d * x_a + x_n[arc_u] - x_n[arc_v]
    y_n = torch.zeros(num_nodes, dtype=x.dtype, device=x.device)
    y_n.index_add_(0, arc_u, x_a)
    y_n.index_add_(0, arc_v, -x_a)
    return torch.cat([y_a, y_n])
