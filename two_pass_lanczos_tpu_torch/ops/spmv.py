"""Sparse matrix–vector products in plain PyTorch.

Counterpart of ``two_pass_lanczos_tpu/ops/spmv.py``:

* :class:`SortedCOO`, :func:`csr_from_triplets` and :func:`coo_spmv`, the
  generic sparse operator's matrix and product. The JAX package padded the
  nonzeros to a lane-aligned length for XLA's static shapes; PyTorch runs
  eagerly, so the port keeps exactly ``nnz`` entries, sorted by row, and a
  CSR row pointer ``indptr`` beside them.
* :func:`kkt_matvec`, the plain version of the KKT matvec kernel (K1 and
  K8, ``csrc/kkt_matvec.cu``). The KKT matrix ``A = [[D, Eᵀ], [E, 0]]`` is
  never materialised: ``E`` is the node–arc incidence matrix with
  ``E[u_j, j] = +1`` and ``E[v_j, j] = -1``, so

  * top block:    ``y_a = d ⊙ x_a + x_n[u] − x_n[v]``   (D·x_a + Eᵀ·x_n)
  * bottom block: ``y_n = scatter_add(+x_a → u, −x_a → v)``  (E·x_a)

  with ``x = [x_a (m), x_n (p)]``. On CUDA ``index_add_`` is atomic, so this
  version is nondeterministic there; it is a reference, never the Lanczos
  path (the path uses ``csrc/kkt_matvec.cu``).

:func:`coo_spmv` sums each row in the fixed order of its CSR segment
(``torch.segment_reduce``), never with an atomic scatter, so pass two's
matvec rounds as pass one's did on either device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.devices import DEFAULT_DEVICE, resolve_device
from two_pass_lanczos_tpu_torch.observability import trace

__all__ = ["SortedCOO", "csr_from_triplets", "coo_spmv", "kkt_matvec"]


@dataclasses.dataclass(frozen=True)
class SortedCOO:
    """Row-sorted COO sparse matrix with its CSR row pointer, on one device.

    ``rows``, ``cols`` (int64) and ``vals`` hold the ``nnz`` entries sorted
    by row (then column); ``indptr`` (int64, ``n_rows + 1``) delimits each
    row's segment of them.
    """

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    indptr: torch.Tensor
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def to(self, device) -> "SortedCOO":
        dev = resolve_device(device)
        return SortedCOO(rows=self.rows.to(dev), cols=self.cols.to(dev),
                         vals=self.vals.to(dev), indptr=self.indptr.to(dev),
                         shape=self.shape)

    def todense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        return out.index_put_((self.rows, self.cols), self.vals,
                              accumulate=True)


def csr_from_triplets(n_rows: int, n_cols: int, rows, cols, vals, dtype=None,
                      sum_duplicates: bool = True,
                      device=DEFAULT_DEVICE) -> SortedCOO:
    """Build a :class:`SortedCOO` from triplets (host-side, NumPy), then
    upload it to ``device``.

    Duplicate ``(row, col)`` entries are summed, as faer's
    ``try_new_from_triplets`` does in the reference loader.
    """
    dev = resolve_device(device)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    if dtype is not None:
        vals = vals.astype(dtype)
    if rows.shape != cols.shape or rows.shape != vals.shape:
        raise ValueError("rows/cols/vals must have identical shapes")
    if rows.size and (rows.min() < 0 or rows.max() >= n_rows):
        raise ValueError("row index out of bounds")
    if cols.size and (cols.min() < 0 or cols.max() >= n_cols):
        raise ValueError("col index out of bounds")
    lin = rows * np.int64(n_cols) + cols
    order = np.argsort(lin, kind="stable")
    lin, vals = lin[order], vals[order]
    if sum_duplicates and lin.size:
        lin, start = np.unique(lin, return_index=True)
        vals = np.add.reduceat(vals, start)
    rows, cols = lin // n_cols, lin % n_cols
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=indptr[1:])

    def up(a):
        return torch.from_numpy(np.array(a)).to(dev)

    return SortedCOO(rows=up(rows), cols=up(cols), vals=up(vals),
                     indptr=up(indptr), shape=(int(n_rows), int(n_cols)))


def coo_spmv(a: SortedCOO, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x``: gather, multiply, and one fixed-order sum per row.
    A complex product is summed as its ``(nnz, 2)`` real view, the real
    and imaginary parts of each row in the same fixed order."""
    with trace("tpl.spmv"):
        prod = a.vals * x[a.cols]
        if prod.is_complex():
            return torch.view_as_complex(torch.segment_reduce(
                torch.view_as_real(prod), "sum", offsets=a.indptr, axis=0))
        return torch.segment_reduce(prod, "sum", offsets=a.indptr)


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
