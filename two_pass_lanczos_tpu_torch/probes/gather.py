"""K14a, the gather probe: ``g = tab[idx]`` on the hand-written kernel
``csrc/probe_gather.cu``.

Counterpart of the Pallas gather probes ``probe_sublane``,
``probe_twostep``, ``probe_int16``, ``probe_time``
(``scripts/probe_gather.py``) and ``bench`` (``scripts/probe/
bench_gather.py``). :func:`gather` launches the kernel for CUDA tensors
(counted in ``LAUNCHES["probe_gather"]``) and runs :func:`gather_plain`
for CPU tensors; there is no other route. ``mode`` picks where the table is
read from (``"smem"``, ``"ldg"``, ``"plain"`` or ``"cluster"``, see the
source); ``idx`` is int32, int16 or uint8; with ``hi`` (uint16 held as
int16 bits) the index is two-level, ``tab[hi·128 + idx]``.

The host side's plans, each with a pure-Python twin that the CPU tests
walk: :func:`vector_plan` (the kernel's scalar head, its quads of 4
entries and its tail), :func:`walk` (which entries each thread of the
kernel takes) and :func:`cluster_plan` / :func:`cluster_slices` (the
cluster tier's cluster size and slices). A table that no cluster the
kernel can stage holds, or that no resident cluster of the card holds,
raises :class:`TableNotStaged`, with the reason: it is never gathered by
another tier.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from two_pass_lanczos_tpu_torch.ops._build import load_library
from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
    LAUNCHES,
    _check,
    _need,
    _ptr,
    _stream,
)

__all__ = ["MODES", "STAGE_ONLY", "SMEM_MAX_ENTRIES", "MAX_CLUSTER",
           "TableNotStaged", "cluster_plan", "cluster_slices",
           "cluster_shape", "gather", "gather_cuda", "gather_plain",
           "two_level", "vector_plan", "walk"]

#: where the kernel reads the table (``tpl::GatherMode``)
MODES = {"smem": 0, "ldg": 1, "plain": 2, "cluster": 3}
#: the cluster tier's staging alone: no gather, nothing written
STAGE_ONLY = "cluster_stage_only"
_KERNEL_MODES = {**MODES, STAGE_ONLY: 4}
#: the index types the kernel widens (``idx_type`` of ``tpl_probe_gather``)
_IDX_TYPES = {torch.int32: 0, torch.int16: 1, torch.uint8: 2}
#: a block's shared memory on the H100 (227 KB) and the staging header
#: (the mbarrier, 16 bytes)
SMEM_BYTES, STAGE_HEADER = 232448, 16
#: the floats a block stages: its shared memory less the header and the
#: up to 3 floats that align the bulk copy (``kMaxStaged``)
SMEM_MAX_ENTRIES = (SMEM_BYTES - STAGE_HEADER - 16) // 4
#: the largest cluster (non-portable past 8 blocks)
MAX_CLUSTER = 16
#: entries a thread takes a step, and quads it issues together
VEC, UNROLL = 4, 2


class TableNotStaged(ValueError):
    """The cluster tier cannot hold this table, or the card holds no such
    cluster at once; the message says which."""


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


# ---------------------------------------------------------------------------
# The host side's plans and their twins
# ---------------------------------------------------------------------------

def phase(t: torch.Tensor) -> int:
    """The element phase of ``t``'s address mod 4: 0 where a quad of its
    elements starts on a vector load's alignment (4 elements)."""
    return (t.data_ptr() // t.element_size()) % VEC


def vector_plan(n: int, idx_phase: int,
                hi_phase: Optional[int] = None) -> Tuple[int, int]:
    """``(head, quads)``: the kernel takes entries ``[0, head)`` one by one,
    then ``quads`` quads of 4 from ``head`` with one vector load of
    indices and one 16-byte store each, then the tail ``[head + 4·quads,
    n)`` one by one. ``head`` aligns ``idx + head`` (and ``hi + head``, and
    ``g + head``, which the wrapper allocates at the indices' phase); where
    ``hi``'s phase differs from ``idx``'s no quad is aligned for both and
    every entry is scalar."""
    if hi_phase is not None and hi_phase != idx_phase:
        return n, 0
    head = min((VEC - idx_phase) % VEC, n)
    return head, (n - head) // VEC


def walk(n: int, head: int, quads: int, threads: int) -> List[List[int]]:
    """The entries each of ``threads`` threads (the grid's) writes, in the
    kernel's loops: the scalar ends strided over the threads, then the
    quads, ``UNROLL`` a thread a round, ``UNROLL·threads`` apart."""
    out: List[List[int]] = [[] for _ in range(threads)]
    ends = n - VEC * quads
    for tid in range(threads):
        for s in range(tid, ends, threads):
            out[tid].append(s if s < head else s + VEC * quads)
        for q0 in range(tid, quads, UNROLL * threads):
            for k in range(UNROLL):
                q = q0 + k * threads
                if q < quads:
                    out[tid].extend(range(head + VEC * q,
                                          head + VEC * (q + 1)))
    return out


def cluster_plan(ntab: int) -> Tuple[int, int]:
    """``(cluster, slice_log2)``: the smallest power of two ``cluster`` ≤ 16
    whose slices of ``2^slice_log2`` floats (the power of two ≥ ntab /
    cluster, at least 4) fit a block's :data:`SMEM_MAX_ENTRIES`; a table
    past 16 such slices raises :class:`TableNotStaged`."""
    if ntab < 1:
        raise ValueError("a table needs an entry")
    cluster = 1
    while cluster <= MAX_CLUSTER:
        per = -(-ntab // cluster)
        slice_log2 = max(2, (per - 1).bit_length())
        if (1 << slice_log2) <= SMEM_MAX_ENTRIES:
            return cluster, slice_log2
        cluster *= 2
    raise TableNotStaged(
        f"a {ntab}-entry table ({4 * ntab} bytes) needs more than "
        f"{MAX_CLUSTER} slices of at most {SMEM_MAX_ENTRIES} floats "
        f"({4 * SMEM_MAX_ENTRIES} bytes of a block's shared memory): no "
        "cluster holds it")


def cluster_slices(ntab: int, cluster: int,
                   slice_log2: int) -> List[Tuple[int, int, int]]:
    """``(rank, first, count)`` of each block's slice: rank r stages table
    entries ``[first, first + count)``, ``first = r·2^slice_log2``; entry
    t lives in rank ``t >> slice_log2`` at ``t & (2^slice_log2 − 1)``."""
    size = 1 << slice_log2
    return [(r, r * size, max(0, min(ntab - r * size, size)))
            for r in range(cluster)]


#: resident clusters per (idx type, two-level, kernel mode, ntab, cluster,
#: slice_log2), as the card's occupancy query gave them
_ACTIVE: Dict[tuple, int] = {}


def cluster_shape(ntab: int, idx_dtype=torch.int32, two: bool = False,
                  mode: str = "cluster") -> dict:
    """The cluster tier's launch for a table of ``ntab`` entries on the
    card: ``cluster``, ``slice_entries`` and ``active_clusters`` (the
    clusters of that shape the card holds at once, from
    ``cudaOccupancyMaxActiveClusters``, cached). Raises
    :class:`TableNotStaged` where no cluster holds the table or none is
    resident; a failed query raises RuntimeError."""
    cluster, slice_log2 = cluster_plan(ntab)
    key = (_IDX_TYPES[idx_dtype], int(two), _KERNEL_MODES[mode], ntab,
           cluster, slice_log2)
    if key not in _ACTIVE:
        lib = load_library()
        active = ctypes.c_int(0)
        code = lib.tpl_probe_gather_clusters(*key, ctypes.byref(active))
        _check(lib, code, "probe_gather_clusters")
        _ACTIVE[key] = active.value
    if not _ACTIVE[key]:
        raise TableNotStaged(
            f"no cluster of {cluster} blocks with {4 << slice_log2} bytes of "
            f"shared memory each is resident on this card "
            f"(cudaOccupancyMaxActiveClusters gave 0) for a {ntab}-entry "
            "table")
    return {"cluster": cluster, "slice_entries": 1 << slice_log2,
            "slice_log2": slice_log2, "active_clusters": _ACTIVE[key]}


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

def gather_cuda(tab: torch.Tensor, idx: torch.Tensor,
                hi: Optional[torch.Tensor] = None,
                mode: str = "ldg") -> Optional[torch.Tensor]:
    """K14a on CUDA tensors: a 1-D f32 ``tab``, a 1-D ``idx`` of int32,
    int16 or uint8 and an optional int16 ``hi`` of the same length; every
    index in ``[0, len(tab))``. ``mode`` is one of :data:`MODES` or
    :data:`STAGE_ONLY` (which stages the table as ``"cluster"`` does and
    gathers nothing: returns None). Views at any offset are taken; ``g`` is
    a view of a buffer allocated at ``idx``'s phase."""
    dev = tab.device
    if dev.type != "cuda":
        raise ValueError(f"probe_gather takes CUDA tensors, not {dev}")
    if mode not in _KERNEL_MODES:
        raise ValueError(
            f"mode must be one of {sorted(_KERNEL_MODES)}, not {mode!r}")
    if idx.dtype not in _IDX_TYPES:
        raise ValueError(f"idx must be int32, int16 or uint8, not {idx.dtype}")
    if tab.dim() != 1 or idx.dim() != 1:
        raise ValueError("tab and idx must be 1-D")
    _need(tab, tab.shape, torch.float32, dev, "tab")
    _need(idx, idx.shape, idx.dtype, dev, "idx")
    if hi is not None:
        _need(hi, idx.shape, torch.int16, dev, "hi")
    ntab, n = tab.numel(), idx.shape[0]
    if mode == "smem" and ntab > SMEM_MAX_ENTRIES:
        raise ValueError(f"a {ntab}-entry table does not fit a block's "
                         f"shared memory ({SMEM_MAX_ENTRIES} floats)")
    cluster = slice_log2 = clusters = 0
    if mode in ("cluster", STAGE_ONLY):
        shape = cluster_shape(ntab, idx.dtype, hi is not None, mode)
        cluster, slice_log2 = shape["cluster"], shape["slice_log2"]
        clusters = shape["active_clusters"]
    ph = phase(idx)
    head, quads = vector_plan(n, ph, None if hi is None else phase(hi))
    buf = torch.empty(n + VEC - 1, dtype=torch.float32, device=dev)
    off = (ph - phase(buf)) % VEC
    g = buf[off:off + n]
    lib = load_library()
    code = lib.tpl_probe_gather(
        _ptr(tab), ntab, _ptr(idx), _IDX_TYPES[idx.dtype],
        None if hi is None else _ptr(hi), n, head, quads,
        _KERNEL_MODES[mode], cluster, slice_log2, clusters, _ptr(g),
        _stream())
    _check(lib, code, "probe_gather")
    LAUNCHES["probe_gather"] += 1
    return None if mode == STAGE_ONLY else g


def gather(tab: torch.Tensor, idx: torch.Tensor,
           hi: Optional[torch.Tensor] = None,
           mode: str = "ldg") -> torch.Tensor:
    """``tab[idx]``: K14a for CUDA tensors, the plain version for CPU
    ones (where ``mode`` only names the kernel's variant)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, not {mode!r}")
    if tab.is_cuda:
        return gather_cuda(tab, idx, hi, mode)
    return gather_plain(tab, idx, hi)
