"""K14d, the pipeline probe: K7 with its arc stream fed by a ring of bulk
copies (TMA) on mbarriers, and K7's node blocks in a kernel of their own
beside it, on the hand-written kernels of ``csrc/probe_pipeline.cu``.

Counterpart of the Pallas probe ``stream_manual.py`` (``man_kernel``, the
streaming matvec on a hand-built double-buffered DMA pipeline, which asked
whether a hand-managed pipeline lets the arc stream overlap the compute).
:func:`pipeline` takes K7's arguments and a ``mode`` (:data:`MODES`:
``full`` is ``man_full``, ``stream_only`` ``man_stream``, ``alu`` N
``man_alu<N>``; ``arc_only`` and ``no_gather`` split the stages). Each
mode is bitwise the stage probe's mode of the same name (K14c,
:mod:`.stages`), so its plain version is :func:`.stages.stages_plain`; a
mode without the node part leaves y_n as ``out`` had it. The ring's tile T
(:data:`TILES`), stages S (:data:`STAGE_COUNTS`) and output store
(:data:`STORES`: the consumers store y_a, or one bulk store a tile) are
chosen at the call; :data:`TILE`, :data:`STAGES` and :data:`STORE` are the
best ``full`` of the sweep at the headline (PERF.md §6). The
wrapper launches the node kernel on a stream forked from the current one
and joins it back (``concurrent``), or both kernels on the current stream;
a CUDA-graph capture keeps the fork as two branches. A CUDA call counts
one in ``LAUNCHES["probe_pipeline"]``.

:func:`ring_plan` and :func:`ring_walk` are the Python twins of the arc
kernel's tile plan (the body of each tile by bulk copy, the up to 3 tail
words by the threads) and of its ring (each block's tiles, their stage and
the parities its producer and consumers wait for).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from two_pass_lanczos_tpu_torch.ops._build import load_library
from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
    LAUNCHES,
    KKTLayout,
    _check,
    _layout_args,
    _need,
    _ptr,
)
from two_pass_lanczos_tpu_torch.probes.stages import (
    MODES as STAGE_MODES,
    stages_plain,
)

__all__ = ["MODES", "NODE_MODES", "TILES", "STAGE_COUNTS", "STORES", "TILE",
           "STAGES", "STORE", "Tile", "ring_plan", "ring_walk", "pipeline",
           "pipeline_blocks", "pipeline_cuda", "pipeline_plain"]

#: the modes (``tpl::PipelineMode``), numbered as the stage probe's
MODES = {name: STAGE_MODES[name] for name in
         ("full", "arc_only", "no_gather", "stream_only", "alu")}
#: the modes that run the node kernel
NODE_MODES = frozenset({"full", "no_gather", "alu"})
#: the ring's shapes: arcs a tile, stages, and how y_a is stored
TILES = (512, 1024, 2048)
STAGE_COUNTS = (2, 3, 4)
STORES = ("direct", "bulk")
#: the best ``full`` at the headline (PERF.md §6)
TILE, STAGES, STORE = 1024, 3, "direct"

_SIDE: Dict[int, torch.cuda.Stream] = {}


class Tile(NamedTuple):
    """One tile of the arc kernel: arcs [base, base + count), of which the
    first ``body`` (a multiple of 4) come by bulk copy."""

    base: int
    count: int
    body: int


def ring_plan(m: int, tile: int = TILE, phase: int = 0) -> List[Tile]:
    """The arc kernel's tiles of m arcs whose arrays start at float phase
    ``phase`` (their address / 4 mod 4). A bulk copy needs 16-byte ends, so
    only phase 0 is planned (a tile then starts aligned); the consumers read
    the tail words ``[base + body, base + count)`` from global memory."""
    if tile not in TILES:
        raise ValueError(f"tile must be one of {TILES}, not {tile}")
    if phase % 4:
        raise ValueError("d, u, v, x and y must be 16-byte aligned: the "
                         "bulk copies need 16-byte ends")
    if m < 0:
        raise ValueError(f"m must be >= 0, not {m}")
    return [Tile(b, min(tile, m - b), min(tile, m - b) & ~3)
            for b in range(0, m, tile)]


def ring_walk(ntiles: int, grid: int, stages: int = STAGES
              ) -> List[List[Tuple[int, int, int, int]]]:
    """Each block's walk of the ring: (tile, stage, full parity, empty
    parity) of its k-th tile, tile = block + k·grid, stage k mod S; the
    consumers wait for the full barrier's phase of parity (k / S) mod 2,
    the producer for the empty barrier's phase of the other parity (a
    fresh barrier passes parity 1 at once)."""
    if stages not in STAGE_COUNTS:
        raise ValueError(f"stages must be one of {STAGE_COUNTS}")
    return [[(t, k % stages, (k // stages) & 1, ((k // stages) & 1) ^ 1)
             for k, t in enumerate(range(b, ntiles, grid))]
            for b in range(grid)]


def _check_mode(mode: str, param: int) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, not {mode!r}")
    if param < 0 or (param and mode != "alu"):
        raise ValueError(f"param {param} out of range for mode {mode!r}")


def _check_ring(tile: int, stages: int, store: str) -> None:
    if tile not in TILES or stages not in STAGE_COUNTS or store not in STORES:
        raise ValueError(f"the ring takes tile in {TILES}, stages in "
                         f"{STAGE_COUNTS} and store in {STORES}, not "
                         f"{tile}, {stages}, {store!r}")


def pipeline_plain(lay: KKTLayout, x: torch.Tensor, e_scale: float = 1.0,
                   mode: str = "full", param: int = 0) -> torch.Tensor:
    """The plain version: the stage probe's (:func:`.stages.stages_plain`)
    of the same mode; ``full`` is K7's, ``ops/kkt_fused.kkt_shard_matvec``."""
    _check_mode(mode, param)
    return stages_plain(lay, x, mode, param, e_scale)


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _SIDE:
        _SIDE[index] = torch.cuda.Stream(device=index)
    return _SIDE[index]


def pipeline_cuda(lay: KKTLayout, x: torch.Tensor, e_scale: float = 1.0,
                  arcs_only: bool = False,
                  out: Optional[torch.Tensor] = None, *, mode: str = "full",
                  param: int = 0, tile: int = TILE, stages: int = STAGES,
                  store: str = STORE, concurrent: bool = True,
                  nodes: bool = True) -> torch.Tensor:
    """K14d for an (m + p,) f32 CUDA x on a CUDA shard layout; ``out``
    receives y (allocated with zeros when None). ``arcs_only`` is mode
    ``arc_only``. The arc arrays, x and ``out`` must be 16-byte aligned
    (fresh allocations are). With ``concurrent`` the node kernel runs on a
    stream forked from the current one and joined back; else both kernels
    run on the current stream, the node kernel first. ``nodes=False``
    launches the arc kernel alone (y_n as ``out`` had it), to part the two
    kernels' times. A refused launch raises."""
    if arcs_only:
        if mode not in ("full", "arc_only"):
            raise ValueError(f"arcs_only is mode 'arc_only', not {mode!r}")
        mode = "arc_only"
    _check_mode(mode, param)
    _check_ring(tile, stages, store)
    if lay.d.device.type != "cuda":
        raise ValueError(f"probe_pipeline takes a CUDA layout, not "
                         f"{lay.d.device}")
    _need(x, (lay.n,), torch.float32, lay.d.device, "x")
    if out is None:
        out = torch.zeros_like(x)
    _need(out, (lay.n,), torch.float32, lay.d.device, "out")
    if any(t.data_ptr() % 16 for t in (lay.d, lay.u, lay.v, x, out)):
        raise ValueError("d, u, v, x and out must be 16-byte aligned")
    lib = load_library()
    cur = torch.cuda.current_stream(x.device)
    side = (_side_stream(x.device)
            if concurrent and nodes and mode in NODE_MODES else cur)
    if side is not cur:
        side.wait_stream(cur)
    try:
        code = lib.tpl_probe_pipeline(
            *_layout_args(lay), float(e_scale), _ptr(x), _ptr(out),
            MODES[mode], int(param), int(tile), int(stages),
            STORES.index(store), int(nodes), ctypes.c_void_p(cur.cuda_stream),
            ctypes.c_void_p(side.cuda_stream))
    finally:
        if side is not cur:
            cur.wait_stream(side)
    _check(lib, code, "probe_pipeline")
    LAUNCHES["probe_pipeline"] += 1
    return out


def pipeline_blocks(mode: str = "full", tile: int = TILE,
                    stages: int = STAGES, store: str = STORE
                    ) -> Tuple[int, int]:
    """(blocks resident per SM, dynamic shared memory bytes) of the arc
    kernel of mode, tile, stages and store on the current card
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    _check_mode(mode, 0)
    _check_ring(tile, stages, store)
    lib = load_library()
    per_sm, smem = ctypes.c_int(0), ctypes.c_int(0)
    _check(lib, lib.tpl_probe_pipeline_blocks(
        MODES[mode], int(tile), int(stages), STORES.index(store),
        ctypes.byref(per_sm), ctypes.byref(smem)), "probe_pipeline_blocks")
    return per_sm.value, smem.value


def pipeline(lay: KKTLayout, x: torch.Tensor, e_scale: float = 1.0,
             mode: str = "full", param: int = 0) -> torch.Tensor:
    """K14d for a CUDA x, the plain version for a CPU one."""
    if x.is_cuda:
        return pipeline_cuda(lay, x, e_scale, mode=mode, param=param)
    return pipeline_plain(lay, x, e_scale, mode, param)
