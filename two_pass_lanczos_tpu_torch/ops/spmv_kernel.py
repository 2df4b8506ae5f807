"""The generic operators' products on hand-written kernels: K8, the KKT
matvec, and K15, the CSR SpMV of the sparse operators.

Counterpart of ``two_pass_lanczos_tpu/ops/spmv_pallas.py``, whose
``_kkt_kernel`` (``:52``) backs ``PallasKKTOperator`` under the generic
solvers. The TPU needed its own kernel for that: arcs padded to a multiple
of 2048, a (128, ⌈p/128⌉) node table for the per-lane gather, and one-hot
MXU contractions with a bf16×3 split for the scatter. On Hopper the
function is exactly K1's, so K8 is K1's kernel (``csrc/kkt_matvec.cu``,
``kkt_matvec_kernel<T>``) on the operator's own :class:`KKTLayout`, in an
f32 and an f64 instance: the generic tier runs in f64 too, and the plain
``index_add_`` scatter is atomic on CUDA, so it would break pass two's
bitwise replay of pass one's basis.

:func:`kkt_operator_matvec` launches the kernel for a CUDA tensor and
counts ``LAUNCHES["kkt_operator_matvec"]``; for a CPU tensor it runs the
plain version, ``ops/spmv.kkt_matvec``. There is no other route.

K15 (``csrc/csr_spmv.cu``, ``csr_spmv_kernel<V>``) replaces no TPU kernel:
the JAX ``SparseOperator``'s product is XLA's gather and sorted
scatter-add. :func:`csr_spmv_cuda` launches it once a product for a
:class:`SortedCOO` on the card, in f32, f64, c64 or c128, over the
matrix's own row-block plan (``SortedCOO.blocks``), and counts
``LAUNCHES["csr_spmv"]``; ``ops/spmv.coo_spmv`` calls it for a CUDA x and
runs its plain version, ``coo_spmv_plain``, for a CPU x.
"""

from __future__ import annotations

import torch

from two_pass_lanczos_tpu_torch.ops._build import load_library
from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
    LAUNCHES,
    KKTLayout,
    _check,
    _layout_args,
    _need,
    _ptr,
    _stream,
)
from two_pass_lanczos_tpu_torch.ops.spmv import (
    ROW_BLOCK_NNZ,
    SortedCOO,
    kkt_matvec,
)

__all__ = ["kkt_operator_matvec", "kkt_operator_matvec_cuda",
           "csr_spmv_cuda"]

#: the C entry point of each dtype's instance of ``kkt_matvec_kernel<T>``
_ENTRY = {torch.float32: "tpl_kkt_matvec", torch.float64: "tpl_kkt_matvec_f64"}
#: the C entry point of each dtype's instance of ``csr_spmv_kernel<V>``
_CSR_ENTRY = {torch.float32: "tpl_csr_spmv_f32",
              torch.float64: "tpl_csr_spmv_f64",
              torch.complex64: "tpl_csr_spmv_c64",
              torch.complex128: "tpl_csr_spmv_c128"}


def kkt_operator_matvec_cuda(lay: KKTLayout, x: torch.Tensor) -> torch.Tensor:
    """K8: ``y = A·x`` for an (n,) CUDA x in the layout's dtype (f32 or
    f64)."""
    dt = lay.d.dtype
    if dt not in _ENTRY:
        raise ValueError(f"K8 has f32 and f64 instances, not {dt}")
    if lay.d.device.type != "cuda":
        raise ValueError(f"K8 takes a layout on a CUDA device, not {lay.d.device}")
    _need(x, (lay.n,), dt, lay.d.device, "x")
    lib = load_library()
    y = torch.empty_like(x)
    code = getattr(lib, _ENTRY[dt])(*_layout_args(lay), _ptr(x), _ptr(y),
                                    _stream())
    _check(lib, code, _ENTRY[dt])
    LAUNCHES["kkt_operator_matvec"] += 1
    return y


def kkt_operator_matvec(lay: KKTLayout, x: torch.Tensor) -> torch.Tensor:
    """``y = A·x``: K8 for a CUDA x, the plain ``kkt_matvec`` for a CPU x."""
    if x.is_cuda:
        return kkt_operator_matvec_cuda(lay, x.contiguous())
    return kkt_matvec(lay.d, lay.u, lay.v, lay.p, x)


def csr_spmv_cuda(a: SortedCOO, x: torch.Tensor) -> torch.Tensor:
    """K15: ``y = A·x`` for a :class:`SortedCOO` on a CUDA device and an
    (n_cols,) contiguous x there in the matrix's dtype (f32, f64, c64 or
    c128); one launch over ``a.blocks``, which the kernel's shared-memory
    stage sizes by :data:`ROW_BLOCK_NNZ`. The matrix's own tensors were
    checked when it was made (``SortedCOO.__post_init__``)."""
    dt = a.dtype
    if dt not in _CSR_ENTRY:
        raise ValueError(f"K15 has f32, f64, c64 and c128 instances, not {dt}")
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"K15 takes a matrix on a CUDA device, not {dev}")
    _need(x, (a.shape[1],), dt, dev, "x")
    y = torch.empty(a.shape[0], dtype=dt, device=dev)
    n_blocks = a.blocks.shape[0] - 1
    if n_blocks <= 0:
        return y
    lib = load_library()
    code = getattr(lib, _CSR_ENTRY[dt])(
        _ptr(a.vals), _ptr(a.cols), _ptr(a.indptr), _ptr(a.blocks),
        n_blocks, ROW_BLOCK_NNZ, _ptr(x), _ptr(y), _stream())
    _check(lib, code, _CSR_ENTRY[dt])
    LAUNCHES["csr_spmv"] += 1
    return y
