"""Sparse matrix–vector products in plain PyTorch.

Counterpart of ``two_pass_lanczos_tpu/ops/spmv.py``:

* :class:`SortedCOO`, :func:`csr_from_triplets` and :func:`coo_spmv`, the
  generic sparse operator's matrix and product. The JAX package padded the
  nonzeros to a lane-aligned length for XLA's static shapes; PyTorch runs
  eagerly, so the port keeps exactly ``nnz`` entries, sorted by row, a CSR
  row pointer ``indptr`` beside them, and the row-block plan ``blocks``
  (:func:`row_blocks`) of the CUDA kernel K15 (``csrc/csr_spmv.cu``).
* :func:`kkt_matvec`, the plain version of the KKT matvec kernel (K1 and
  K8, ``csrc/kkt_matvec.cu``). The KKT matrix ``A = [[D, Eᵀ], [E, 0]]`` is
  never materialised: ``E`` is the node–arc incidence matrix with
  ``E[u_j, j] = +1`` and ``E[v_j, j] = -1``, so

  * top block:    ``y_a = d ⊙ x_a + x_n[u] − x_n[v]``   (D·x_a + Eᵀ·x_n)
  * bottom block: ``y_n = scatter_add(+x_a → u, −x_a → v)``  (E·x_a)

  with ``x = [x_a (m), x_n (p)]``. On CUDA ``index_add_`` is atomic, so this
  version is nondeterministic there; it is a reference, never the Lanczos
  path (the path uses ``csrc/kkt_matvec.cu``).

:func:`coo_spmv` sums each row in a fixed order that depends only on the
matrix, never with an atomic scatter, so pass two's matvec rounds as pass
one's did: on a CUDA tensor one launch of K15 (``ops/spmv_kernel
.csr_spmv_cuda``), on a CPU tensor its plain version :func:`coo_spmv_plain`
(a gather, a multiply and ``torch.segment_reduce`` over the CSR segments).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.devices import DEFAULT_DEVICE, resolve_device
from two_pass_lanczos_tpu_torch.observability import trace

__all__ = ["SortedCOO", "csr_from_triplets", "row_blocks", "coo_spmv",
           "coo_spmv_plain", "row_sum_bound", "kkt_matvec", "ROW_BLOCK_NNZ"]

#: the row-block plan's budget: the nonzeros (and the rows) one block of
#: K15 takes, and the entries of its shared-memory stage
ROW_BLOCK_NNZ = 1024


def row_blocks(indptr, budget: int = ROW_BLOCK_NNZ) -> np.ndarray:
    """K15's row-block plan from a CSR row pointer (host, NumPy): the
    ``(blocks + 1,)`` int64 first rows of the blocks, then ``n_rows``.
    Each block takes consecutive rows, as many as fit in ``budget``
    nonzeros and ``budget`` rows; a row of more than ``budget`` nonzeros
    takes a block alone. It depends on ``indptr`` alone, and so does the
    kernel's order of summation. Zero rows give ``[0]``, no block."""
    indptr = np.asarray(indptr, dtype=np.int64)
    n = indptr.shape[0] - 1
    starts = [0]
    r = 0
    while r < n:
        end = int(np.searchsorted(indptr, indptr[r] + budget, "right")) - 1
        end = min(end, r + budget, n)
        r = max(end, r + 1)
        starts.append(r)
    return np.asarray(starts, dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class SortedCOO:
    """Row-sorted COO sparse matrix with its CSR row pointer, on one device.

    ``rows``, ``cols`` (int64) and ``vals`` hold the ``nnz`` entries sorted
    by row (then column); ``indptr`` (int64, ``n_rows + 1``) delimits each
    row's segment of them; ``blocks`` (int64) is K15's row-block plan,
    :func:`row_blocks` of ``indptr``, built where the matrix is made.
    """

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    indptr: torch.Tensor
    blocks: torch.Tensor
    shape: Tuple[int, int]

    def __post_init__(self):
        # checked once here, so that K15's wrapper checks only x a product
        for name in ("rows", "cols", "vals", "indptr", "blocks"):
            t = getattr(self, name)
            if (t.device != self.vals.device or not t.is_contiguous()
                    or (name != "vals" and t.dtype != torch.int64)):
                raise ValueError(
                    f"{name}: expected a contiguous "
                    f"{'' if name == 'vals' else 'int64 '}tensor on "
                    f"{self.vals.device}, got {t.dtype} on {t.device}")

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
                         blocks=self.blocks.to(dev), shape=self.shape)

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
                     indptr=up(indptr), blocks=up(row_blocks(indptr)),
                     shape=(int(n_rows), int(n_cols)))


def coo_spmv(a: SortedCOO, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x``, each row summed in a fixed order: K15 for a CUDA x,
    :func:`coo_spmv_plain` for a CPU x. There is no other route."""
    with trace("tpl.spmv"):
        if x.is_cuda:
            # imported here: spmv_kernel imports this module
            from two_pass_lanczos_tpu_torch.ops.spmv_kernel import (
                csr_spmv_cuda,
            )
            return csr_spmv_cuda(a, x.contiguous())
        return coo_spmv_plain(a, x)


def coo_spmv_plain(a: SortedCOO, x: torch.Tensor) -> torch.Tensor:
    """The plain version of K15 on any device: gather, multiply, and one
    sum per row over its CSR segment (``torch.segment_reduce``). A complex
    product is summed as its ``(nnz, 2)`` real view, the real and imaginary
    parts of each row in the same order."""
    prod = a.vals * x[a.cols]
    if prod.is_complex():
        return torch.view_as_complex(torch.segment_reduce(
            torch.view_as_real(prod), "sum", offsets=a.indptr, axis=0))
    return torch.segment_reduce(prod, "sum", offsets=a.indptr)


def row_sum_bound(a: SortedCOO, x: torch.Tensor) -> torch.Tensor:
    """Per row, ``2·(deg + 2)·ε·(|A|·|x|)`` in f64 on ``a``'s device: the
    most two orders of one row's sum (and a complex product's rounding)
    can differ, so the tolerance between K15 and :func:`coo_spmv_plain`."""
    eps = torch.finfo(a.vals.real.dtype if a.vals.is_complex()
                      else a.vals.dtype).eps
    deg = (a.indptr[1:] - a.indptr[:-1]).double()
    mag = torch.segment_reduce(a.vals.abs().double()
                               * x.abs().double()[a.cols], "sum",
                               offsets=a.indptr)
    return 2.0 * (deg + 2.0) * eps * mag


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
