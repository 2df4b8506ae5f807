"""K14d, the pipeline probe: K7 with its arc part fed through a
double-buffered ``cp.async`` copy pipeline, on the hand-written kernel
``csrc/probe_pipeline.cu``.

Counterpart of the Pallas probe ``stream_manual.py`` (``man_kernel``, the
streaming matvec on a hand-built double-buffered DMA pipeline).
:func:`pipeline` takes K7's arguments; it launches the kernel for CUDA
tensors (counted in ``LAUNCHES["probe_pipeline"]``), whose y is bitwise
K7's, and runs the plain version, K7's own (``kkt_shard_matvec``), for CPU
tensors.
"""

from __future__ import annotations

from typing import Optional

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
    kkt_shard_matvec,
)

__all__ = ["pipeline", "pipeline_cuda", "pipeline_plain"]


def pipeline_plain(lay: KKTLayout, x: torch.Tensor,
                   e_scale: float = 1.0) -> torch.Tensor:
    """The plain version: K7's, ``ops/kkt_fused.kkt_shard_matvec``."""
    return kkt_shard_matvec(lay, x, e_scale)


def pipeline_cuda(lay: KKTLayout, x: torch.Tensor, e_scale: float = 1.0,
                  arcs_only: bool = False,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K14d for an (m + p,) f32 CUDA x on a CUDA shard layout; the arc
    arrays and x must be 16-byte aligned (fresh allocations are). With
    ``arcs_only`` the launch holds the pipelined arc part alone and leaves
    y_n as ``out`` had it (zeros when ``out`` is None)."""
    if lay.d.device.type != "cuda":
        raise ValueError(f"probe_pipeline takes a CUDA layout, not "
                         f"{lay.d.device}")
    _need(x, (lay.n,), torch.float32, lay.d.device, "x")
    if any(t.data_ptr() % 16 for t in (lay.d, lay.u, lay.v, x)):
        raise ValueError("d, u, v and x must be 16-byte aligned")
    if out is None:
        out = torch.zeros_like(x) if arcs_only else torch.empty_like(x)
    _need(out, (lay.n,), torch.float32, lay.d.device, "out")
    lib = load_library()
    code = lib.tpl_probe_pipeline(*_layout_args(lay), float(e_scale),
                                  _ptr(x), _ptr(out), int(not arcs_only),
                                  _stream())
    _check(lib, code, "probe_pipeline")
    LAUNCHES["probe_pipeline"] += 1
    return out


def pipeline(lay: KKTLayout, x: torch.Tensor,
             e_scale: float = 1.0) -> torch.Tensor:
    """K14d for a CUDA x, the plain version for a CPU one."""
    if x.is_cuda:
        return pipeline_cuda(lay, x, e_scale)
    return pipeline_plain(lay, x, e_scale)
