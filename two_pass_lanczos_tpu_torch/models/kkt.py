"""KKT system construction: files → operators.

Counterpart of ``two_pass_lanczos_tpu/models/kkt.py``. The reference
assembles an explicit sparse ``A = [[D, Eᵀ], [E, 0]]``
(``src/utils/data_loader.rs:211-258``); the port keeps the structure
implicit in a :class:`KKTOperator` (K8 on the card, the plain matvec on the
CPU), and builds the explicit :class:`SortedCOO` form for the generic
sparse path and for dense cross-checks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.devices import DEFAULT_DEVICE
from two_pass_lanczos_tpu_torch.operators import KKTOperator, make_kkt_operator
from two_pass_lanczos_tpu_torch.ops.spmv import SortedCOO, csr_from_triplets
from two_pass_lanczos_tpu_torch.utils.data_loader import (
    KKTArrays,
    load_kkt_arrays,
)

__all__ = ["KKTSystem", "kkt_operator_from_files", "kkt_operator_from_arrays",
           "kkt_sorted_coo"]


class KKTSystem(NamedTuple):
    """A loaded KKT problem (reference ``KKTSystem``, ``data_loader.rs:51-58``)."""

    operator: KKTOperator
    num_nodes: int
    num_arcs: int

    @property
    def n(self) -> int:
        return self.num_arcs + self.num_nodes


def kkt_operator_from_arrays(arrays: KKTArrays, dtype=torch.float64,
                             device=DEFAULT_DEVICE) -> KKTSystem:
    """The KKT operator of ``arrays`` through :func:`make_kkt_operator`
    (K8 on the card, the plain matvec on the CPU)."""
    return KKTSystem(
        operator=make_kkt_operator(arrays.quad_costs, arrays.arc_u,
                                   arrays.arc_v, arrays.num_nodes,
                                   dtype=dtype, device=device),
        num_nodes=arrays.num_nodes,
        num_arcs=arrays.num_arcs,
    )


def kkt_operator_from_files(dmx_path, qfc_path, dtype=torch.float64,
                            device=DEFAULT_DEVICE) -> KKTSystem:
    """Load a (``.dmx``, ``.qfc``) pair into a matrix-free KKT operator."""
    return kkt_operator_from_arrays(load_kkt_arrays(dmx_path, qfc_path),
                                    dtype=dtype, device=device)


def kkt_sorted_coo(arrays: KKTArrays, dtype=np.float64,
                   device=DEFAULT_DEVICE) -> SortedCOO:
    """Explicit sparse assembly of ``A = [[D, Eᵀ], [E, 0]]`` (generic path).

    Triplet layout mirrors the reference assembly
    (``src/utils/data_loader.rs:222-249``): D at (j, j); E entries shifted to
    rows ``num_arcs + node``; Eᵀ mirrored. Duplicates (u == v self-loop
    arcs) collapse by summation, as faer's triplets do.
    """
    m = arrays.num_arcs
    n = m + arrays.num_nodes
    j = np.arange(m, dtype=np.int64)
    u = arrays.arc_u.astype(np.int64) + m
    v = arrays.arc_v.astype(np.int64) + m
    rows = np.concatenate([j, u, v, j, j])
    cols = np.concatenate([j, j, j, u, v])
    ones = np.ones(m, dtype=dtype)
    vals = np.concatenate([arrays.quad_costs.astype(dtype), ones, -ones, ones,
                           -ones])
    return csr_from_triplets(n, n, rows, cols, vals, dtype=dtype,
                             device=device)
