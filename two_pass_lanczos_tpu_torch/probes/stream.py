"""K14b, the streaming probe: ``y = d·x + 1e-30·(float(u) + float(v))`` per
arc on the hand-written kernel ``csrc/probe_stream.cu``.

Counterpart of the Pallas streaming probes ``stream_blocks.py`` (the pure
streaming floor against the block size) and ``stream_planes.py`` (four
planes against one interleaved record at constant bytes). :func:`stream`
takes the four planes ``d, u, v, x`` (struct of arrays), and
:func:`stream_records` the ``(m, 4)`` record of :func:`pack_records`
(``{d, u, v, x}`` per arc, u and v as their int bits); both launch the
kernel for CUDA tensors (counted in ``LAUNCHES["probe_stream"]``) with
``threads`` ∈ {128, 256, 512, 1024} per block and ``apt`` ∈ {1, 2, 4, 8}
arcs per thread, and run the plain version for CPU tensors. The kernel
spells its roundings, so the plain version is bitwise its result.
"""

from __future__ import annotations

import torch

from two_pass_lanczos_tpu_torch.ops._build import load_library
from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
    LAUNCHES,
    _check,
    _need,
    _ptr,
    _stream,
)

__all__ = ["THREADS", "ARCS_PER_THREAD", "TINY", "pack_records", "stream",
           "stream_cuda", "stream_plain", "stream_records",
           "stream_records_cuda", "stream_records_plain"]

THREADS = (128, 256, 512, 1024)
ARCS_PER_THREAD = (1, 2, 4, 8)
#: the scale at which the probes fold what they must not drop (``kTiny``)
TINY = 1e-30


def stream_plain(d, u, v, x) -> torch.Tensor:
    """The plain version: ``(d·x) + (1e-30·(float(u) + float(v)))``, each
    operation rounded as the kernel rounds it."""
    return d * x + TINY * (u.float() + v.float())


def pack_records(d, u, v, x) -> torch.Tensor:
    """The ``(m, 4)`` f32 record ``{d, u, v, x}`` of each arc (16 bytes),
    u and v as their int32 bits."""
    return torch.stack([d, u.view(torch.float32), v.view(torch.float32), x],
                       dim=1).contiguous()


def stream_records_plain(rec: torch.Tensor) -> torch.Tensor:
    """The plain version on the interleaved record."""
    return stream_plain(rec[:, 0], rec[:, 1].view(torch.int32),
                        rec[:, 2].view(torch.int32), rec[:, 3])


def _block_shape(threads: int, apt: int) -> None:
    if threads not in THREADS or apt not in ARCS_PER_THREAD:
        raise ValueError(f"threads must be in {THREADS} and arcs per thread "
                         f"in {ARCS_PER_THREAD}, got {threads}, {apt}")


def _launch(planes, rec, m, threads, apt, dev) -> torch.Tensor:
    _block_shape(threads, apt)
    if dev.type != "cuda":
        raise ValueError(f"probe_stream takes CUDA tensors, not {dev}")
    lib = load_library()
    y = torch.empty(m, dtype=torch.float32, device=dev)
    ptrs = [None] * 4 if planes is None else [_ptr(t) for t in planes]
    code = lib.tpl_probe_stream(*ptrs, None if rec is None else _ptr(rec), m,
                                threads, apt, _ptr(y), _stream())
    _check(lib, code, "probe_stream")
    LAUNCHES["probe_stream"] += 1
    return y


def stream_cuda(d, u, v, x, threads: int = 256, apt: int = 1
                ) -> torch.Tensor:
    """K14b on four CUDA planes: f32 ``d``, ``x`` and int32 ``u``, ``v``,
    each ``(m,)``."""
    m = d.shape[0]
    for t, dt, name in ((d, torch.float32, "d"), (u, torch.int32, "u"),
                        (v, torch.int32, "v"), (x, torch.float32, "x")):
        _need(t, (m,), dt, d.device, name)
    return _launch((d, u, v, x), None, m, threads, apt, d.device)


def stream_records_cuda(rec: torch.Tensor, threads: int = 256,
                        apt: int = 1) -> torch.Tensor:
    """K14b on the CUDA ``(m, 4)`` f32 record, read as one float4 an arc."""
    _need(rec, (rec.shape[0], 4), torch.float32, rec.device, "rec")
    if rec.data_ptr() % 16:
        raise ValueError("the record must be 16-byte aligned")
    return _launch(None, rec, rec.shape[0], threads, apt, rec.device)


def stream(d, u, v, x, threads: int = 256, apt: int = 1) -> torch.Tensor:
    """K14b on four planes for CUDA tensors, the plain version for CPU
    ones."""
    if d.is_cuda:
        return stream_cuda(d, u, v, x, threads, apt)
    _block_shape(threads, apt)
    return stream_plain(d, u, v, x)


def stream_records(rec: torch.Tensor, threads: int = 256,
                   apt: int = 1) -> torch.Tensor:
    """K14b on the interleaved record for a CUDA tensor, the plain version
    for a CPU one."""
    if rec.is_cuda:
        return stream_records_cuda(rec, threads, apt)
    _block_shape(threads, apt)
    return stream_records_plain(rec)
