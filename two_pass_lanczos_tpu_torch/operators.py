"""Matrix-free linear operators.

Counterpart of ``two_pass_lanczos_tpu/operators.py``: every generic
algorithm takes an operator defined only by its action (the reference's
``LinOp``). An operator holds its tensors on one device, the card unless
the caller passes ``device="cpu"``, and ``matvec`` takes a tensor there.

* :class:`DenseOperator`    — dense symmetric/Hermitian A (``torch.mv``).
* :class:`DiagonalOperator` — diagonal A (the stability scenarios).
* :class:`SparseOperator`   — generic sparse A (:class:`SortedCOO`), summed
  row by row in a fixed order: K15 (``csrc/csr_spmv.cu``) on a card, one
  launch a product, in f32, f64, c64 or c128.
* :class:`KKTOperator`      — structure-aware ``[[D, Eᵀ], [E, 0]]``: the
  plain ``kkt_matvec`` on the CPU, K8 (``csrc/kkt_matvec.cu``) on a card.
  ``CudaKKTOperator``, the name of JAX's ``PallasKKTOperator`` here, is the
  same class: K8 needs no padding and no layout of its own.
* :class:`CallableOperator` — wraps any ``matvec`` closure.

On a CUDA device no operator's matvec scatters with ``index_add_``: its
atomics would make pass two's matvec round differently from pass one's.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.devices import DEFAULT_DEVICE, resolve_device
from two_pass_lanczos_tpu_torch.ops.kkt_fused import KKTLayout
from two_pass_lanczos_tpu_torch.ops.spmv import SortedCOO, coo_spmv
from two_pass_lanczos_tpu_torch.ops.spmv_kernel import kkt_operator_matvec

__all__ = [
    "LinearOperator",
    "DenseOperator",
    "DiagonalOperator",
    "SparseOperator",
    "KKTOperator",
    "CudaKKTOperator",
    "make_kkt_operator",
    "CallableOperator",
    "as_operator",
]


def _tensor(a, device, dtype=None) -> torch.Tensor:
    """``a`` (array-like or tensor) as a contiguous tensor on ``device``."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    return t.to(device=resolve_device(device), dtype=dtype).contiguous()


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


class LinearOperator:
    """Protocol: ``shape``, ``dtype``, ``device`` and ``matvec(x)``."""

    shape: Tuple[int, int]
    dtype: torch.dtype
    device: torch.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x)


class DenseOperator(LinearOperator):
    """Dense (symmetric/Hermitian) operator; one GEMV per matvec, which
    cuBLAS never runs in TF32."""

    def __init__(self, a, device=DEFAULT_DEVICE):
        self.a = _tensor(a, device)
        if self.a.dim() != 2:
            raise ValueError(f"a must be 2-D, got {tuple(self.a.shape)}")
        self.shape = tuple(self.a.shape)
        self.dtype = self.a.dtype
        self.device = self.a.device

    def matvec(self, x):
        return torch.mv(self.a, x)


class DiagonalOperator(LinearOperator):
    """Diagonal operator (the reference's synthetic spectra)."""

    def __init__(self, diag, device=DEFAULT_DEVICE):
        self.diag = _tensor(diag, device)
        n = self.diag.shape[0]
        self.shape = (n, n)
        self.dtype = self.diag.dtype
        self.device = self.diag.device

    def matvec(self, x):
        return self.diag * x


class SparseOperator(LinearOperator):
    """Generic sparse operator over a row-sorted :class:`SortedCOO`, moved
    to ``device`` with its row-block plan. Its matvec is
    ``ops/spmv.coo_spmv``: one launch of K15 for a CUDA x, each row summed
    in an order fixed by the matrix alone (so pass two replays pass one's
    basis bit for bit), the plain gather, multiply and
    ``torch.segment_reduce`` for a CPU x."""

    def __init__(self, mat: SortedCOO, device=DEFAULT_DEVICE):
        self.mat = mat.to(device)
        self.shape = mat.shape
        self.dtype = mat.dtype
        self.device = self.mat.device

    def matvec(self, x):
        return coo_spmv(self.mat, x)


class KKTOperator(LinearOperator):
    """Structure-aware KKT operator ``A = [[D, Eᵀ], [E, 0]]``.

    Never materialises A: holds the diagonal ``d`` of D (the quadratic arc
    costs) and the arc endpoints of the incidence matrix E in a
    :class:`KKTLayout` (arcs in their original order plus a node-sorted
    incidence CSR), arc block first, node block after. ``dtype`` defaults
    to the dtype of ``quad_costs``; on a card it must be f32 or f64, the
    instances of K8.
    """

    def __init__(self, quad_costs, arc_u, arc_v, num_nodes: int, dtype=None,
                 device=DEFAULT_DEVICE):
        dev = resolve_device(device)
        d = _host(quad_costs)
        np_dtype = d.dtype if dtype is None else _np_dtype(dtype)
        if dev.type == "cuda" and np_dtype not in (np.float32, np.float64):
            raise ValueError(f"K8 has f32 and f64 instances, not {np_dtype}")
        self.layout = KKTLayout.build(d, _host(arc_u), _host(arc_v),
                                      num_nodes, dev, dtype=np_dtype)
        n = self.layout.n
        self.shape = (n, n)
        self.dtype = self.layout.d.dtype
        self.device = dev

    @property
    def num_arcs(self) -> int:
        return self.layout.m

    @property
    def num_nodes(self) -> int:
        return self.layout.p

    @property
    def nnz(self) -> int:
        # D has m entries, E and Eᵀ have 2m each
        return 5 * self.layout.m

    def matvec(self, x):
        return kkt_operator_matvec(self.layout, x)


#: JAX's ``PallasKKTOperator`` under its port's name: :class:`KKTOperator`
CudaKKTOperator = KKTOperator


def make_kkt_operator(quad_costs, arc_u, arc_v, num_nodes, dtype=None,
                      backend: str = "auto",
                      device=DEFAULT_DEVICE) -> KKTOperator:
    """The :class:`KKTOperator` of an instance; ``dtype`` defaults to that
    of ``quad_costs``.

    The device alone decides the matvec: K8 on a card, the plain
    ``kkt_matvec`` on the CPU. ``backend`` ∈ {'auto', 'plain', 'cuda'}
    stands for JAX's {'auto', 'xla', 'pallas'} and is only checked:
    'plain' with a CUDA device raises, because the plain scatter is atomic
    there, and every other valid value builds the same operator.
    """
    dev = resolve_device(device)
    if backend not in ("auto", "plain", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "plain" and dev.type == "cuda":
        raise ValueError(
            "backend='plain' is the CPU reference (its index_add_ scatter is "
            "atomic on CUDA); a CUDA device always runs K8")
    return KKTOperator(quad_costs, arc_u, arc_v, num_nodes, dtype=dtype,
                       device=dev)


class CallableOperator(LinearOperator):
    """Wraps any ``matvec`` closure on tensors of ``device``."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], n: int,
                 dtype: torch.dtype = torch.float64, device=DEFAULT_DEVICE):
        self.fn = fn
        self.shape = (int(n), int(n))
        self.dtype = dtype
        self.device = resolve_device(device)

    def matvec(self, x):
        return self.fn(x)


def as_operator(a, device=DEFAULT_DEVICE) -> LinearOperator:
    """Coerce an array / tensor / :class:`SortedCOO` to a LinearOperator
    (2-D: dense, 1-D: diagonal)."""
    if isinstance(a, LinearOperator):
        return a
    if isinstance(a, SortedCOO):
        return SparseOperator(a, device=device)
    t = _tensor(a, device)
    if t.dim() == 2:
        return DenseOperator(t, device=device)
    if t.dim() == 1:
        return DiagonalOperator(t, device=device)
    raise TypeError(f"cannot interpret {type(a)!r} as a linear operator")
