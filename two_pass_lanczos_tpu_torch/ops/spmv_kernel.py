"""K8: the KKT matvec of the generic operators, on the hand-written kernel.

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
from two_pass_lanczos_tpu_torch.ops.spmv import kkt_matvec

__all__ = ["kkt_operator_matvec", "kkt_operator_matvec_cuda"]

#: the C entry point of each dtype's instance of ``kkt_matvec_kernel<T>``
_ENTRY = {torch.float32: "tpl_kkt_matvec", torch.float64: "tpl_kkt_matvec_f64"}


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
