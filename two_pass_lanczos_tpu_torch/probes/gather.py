"""K14a, the gather probe: ``g = tab[idx]`` on the hand-written kernel
``csrc/probe_gather.cu``.

Counterpart of the Pallas gather probes ``probe_sublane``,
``probe_twostep``, ``probe_int16``, ``probe_time``
(``scripts/probe_gather.py``) and ``bench`` (``scripts/probe/
bench_gather.py``). :func:`gather` launches the kernel for CUDA tensors
(counted in ``LAUNCHES["probe_gather"]``) and runs :func:`gather_plain`
for CPU tensors; there is no other route. ``mode`` picks where the table is
read from (``"smem"``, ``"ldg"`` or ``"plain"``, see the source); ``idx`` is
int32, int16 or uint8; with ``hi`` (uint16 held as int16 bits) the index is
two-level, ``tab[hi·128 + idx]``.
"""

from __future__ import annotations

from typing import Optional

import torch

from two_pass_lanczos_tpu_torch.ops._build import load_library
from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
    LAUNCHES,
    _check,
    _need,
    _ptr,
    _stream,
)

__all__ = ["MODES", "SMEM_MAX_ENTRIES", "gather", "gather_cuda",
           "gather_plain", "two_level"]

#: where the kernel reads the table (``tpl::GatherMode``)
MODES = {"smem": 0, "ldg": 1, "plain": 2}
#: the index types the kernel widens (``idx_type`` of ``tpl_probe_gather``)
_IDX_TYPES = {torch.int32: 0, torch.int16: 1, torch.uint8: 2}
#: the largest table the smem mode stages: 227 KB of f32
SMEM_MAX_ENTRIES = 232448 // 4


def two_level(idx: torch.Tensor):
    """``(hi, lo)`` of int indices: ``hi = idx >> 7`` as uint16 bits in an
    int16 tensor, ``lo = idx & 127`` as uint8, so ``hi·128 + lo == idx``."""
    t = idx.long()
    hi = t >> 7
    if t.numel() and int(hi.max()) > 0xFFFF:
        raise ValueError("a two-level index holds at most 2^23 entries")
    return ((hi - ((hi >> 15) << 16)).to(torch.int16),
            (t & 127).to(torch.uint8))


def _flat_index(idx: torch.Tensor, hi: Optional[torch.Tensor]):
    t = idx.long()
    return t if hi is None else t + ((hi.long() & 0xFFFF) << 7)


def gather_plain(tab: torch.Tensor, idx: torch.Tensor,
                 hi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: ``tab[idx]`` (``tab[hi·128 + idx]`` with ``hi``)."""
    return tab[_flat_index(idx, hi)]


def gather_cuda(tab: torch.Tensor, idx: torch.Tensor,
                hi: Optional[torch.Tensor] = None,
                mode: str = "ldg") -> torch.Tensor:
    """K14a on CUDA tensors: a 1-D f32 ``tab``, a 1-D ``idx`` of int32,
    int16 or uint8 and an optional int16 ``hi`` of the same length; every
    index in ``[0, len(tab))``."""
    dev = tab.device
    if dev.type != "cuda":
        raise ValueError(f"probe_gather takes CUDA tensors, not {dev}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, not {mode!r}")
    if idx.dtype not in _IDX_TYPES:
        raise ValueError(f"idx must be int32, int16 or uint8, not {idx.dtype}")
    if tab.dim() != 1 or idx.dim() != 1:
        raise ValueError("tab and idx must be 1-D")
    _need(tab, tab.shape, torch.float32, dev, "tab")
    _need(idx, idx.shape, idx.dtype, dev, "idx")
    if hi is not None:
        _need(hi, idx.shape, torch.int16, dev, "hi")
    if mode == "smem" and tab.numel() > SMEM_MAX_ENTRIES:
        raise ValueError(f"a {tab.numel()}-entry table does not fit the "
                         f"227 KB of shared memory ({SMEM_MAX_ENTRIES})")
    lib = load_library()
    g = torch.empty(idx.shape[0], dtype=torch.float32, device=dev)
    code = lib.tpl_probe_gather(
        _ptr(tab), tab.numel(), _ptr(idx), _IDX_TYPES[idx.dtype],
        None if hi is None else _ptr(hi), idx.shape[0], MODES[mode], _ptr(g),
        _stream())
    _check(lib, code, "probe_gather")
    LAUNCHES["probe_gather"] += 1
    return g


def gather(tab: torch.Tensor, idx: torch.Tensor,
           hi: Optional[torch.Tensor] = None,
           mode: str = "ldg") -> torch.Tensor:
    """``tab[idx]``: K14a for CUDA tensors, the plain version for CPU
    ones (where ``mode`` only names the kernel's variant)."""
    if tab.is_cuda:
        return gather_cuda(tab, idx, hi, mode)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, not {mode!r}")
    return gather_plain(tab, idx, hi)
