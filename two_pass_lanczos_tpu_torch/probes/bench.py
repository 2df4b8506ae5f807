"""Run the K14 probes on the card and report each variant's time.

Usage, on a machine with an NVIDIA GPU::

    python -m two_pass_lanczos_tpu_torch.probes {gather,stream,stages,pipeline} [--arcs N]

on ``generate_mcf_instance(N, rho=3, instance_id=1)`` (default the
500,000-arc headline) in the f32 solver's layout, with x from
``default_rng(--seed)``. Each variant is first checked against its plain
version (bitwise, or the node sums within 2·deg·ε·Σ|x|; a failed check
raises), then timed:

* warm: ``--reps`` calls captured in one CUDA graph, the replay timed by
  CUDA events, per call;
* cold: the same with a write of a 128 MB scratch buffer (past the 50 MB
  L2) before each call inside the graph, less the flush's own time measured
  alone.

One JSON record per variant: ``us`` and ``us_cold`` per call, ``bytes`` the
function moves (each input read once, each output written once),
``bound_us`` those bytes over the H100 SXM's 3.35 TB/s, ``gbps`` and
``share`` (of the bound) warm and cold, ``library_us`` and
``library_us_cold`` where one PyTorch call computes the same function,
``max_abs_err`` of the checked call against its plain version, and the
card's ``nvidia-smi`` name and power limit. The bound is HBM's: only the
cold time is held to it, since a warm call may read its inputs from L2. A
gather of the cluster tier carries its ``cluster``, ``slice_entries`` and
``active_clusters``; a table that no resident cluster holds gets a record
with ``not_run`` (the reason) and no time.
``LAUNCHES`` counts the kernels the timing graphs ran, once per replay.
Without a card it raises; nothing runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.devices import resolve_device
from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
    LAUNCHES,
    KKTLayout,
    kkt_shard_matvec_cuda,
)
from two_pass_lanczos_tpu_torch.probes.gather import (
    SMEM_MAX_ENTRIES,
    STAGE_ONLY,
    TableNotStaged,
    cluster_shape,
    gather_cuda,
    gather_plain,
    two_level,
)
from two_pass_lanczos_tpu_torch.probes.pipeline import (
    STAGE_COUNTS as PIPE_STAGE_COUNTS,
    STAGES as PIPE_STAGES,
    STORE as PIPE_STORE,
    STORES as PIPE_STORES,
    TILE as PIPE_TILE,
    TILES as PIPE_TILES,
    pipeline_blocks,
    pipeline_cuda,
)
from two_pass_lanczos_tpu_torch.probes.stages import (
    ARC_MODES,
    NODE_MODES,
    node_sorted_copy,
    stages_cuda,
    stages_plain,
)
from two_pass_lanczos_tpu_torch.probes.stream import (
    ARCS_PER_THREAD,
    THREADS,
    TINY,
    pack_records,
    stream_cuda,
    stream_plain,
    stream_records_cuda,
)

__all__ = ["HBM_BPS", "Timer", "card_name", "kkt_function_bytes", "run",
           "stage_split", "pipeline_split", "RUNS", "main"]

#: H100 SXM HBM3 bytes/s (NVIDIA's data sheet)
HBM_BPS = 3.35e12
#: H100 SXM f32 instructions/s: its 67 TFLOP/s count an FMA as two
F32_ISSUE = 33.5e12
#: the cold-L2 flush: a write of 128 MB, past the 50 MB L2
FLUSH_BYTES = 128 * 2 ** 20
REPS = 200
#: replays of each timing graph: one to warm up, the rest timed
REPLAYS = 4
#: table sizes of the gather sweep, 1K to 8M entries
SWEEP = tuple(1 << s for s in (10, 12, 14, 16, 18, 20, 22, 23))
#: the stage probe's variants: (mode, param)
STAGES = (("full", 0), ("arc_only", 0), ("node_only", 0),
          ("node_no_gather", 0), ("no_gather", 0), ("stream_only", 0),
          ("alu", 4), ("alu", 16), ("alu", 64), ("gather", 1), ("gather", 2),
          ("gather", 4), ("node_sorted", 0))
#: the pipeline probe's modes, each beside its stage-probe twin: (mode,
#: param), the JAX probe's man_full, man_stream and man_alu<N>
PIPELINE_MODES = (("full", 0), ("arc_only", 0), ("stream_only", 0),
                  ("no_gather", 0), ("alu", 4), ("alu", 16), ("alu", 64))


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out = f"{torch.cuda.get_device_name(0)}, power limit not read"
    return out


def kkt_function_bytes(m: int, p: int) -> int:
    """K7's function: d, u, v, x_a, x_n read once, y_a, y_n written once."""
    return 20 * m + 8 * p


class Timer:
    """Device time per call of a function on the card, warm and cold."""

    def __init__(self, device, reps: int = REPS):
        self.reps = reps
        self._scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                                    device=device)
        self._flush_us: Optional[float] = None

    def flush(self) -> None:
        self._scratch.fill_(1.0)

    def warm(self, fn: Callable) -> float:
        """µs per call: ``reps`` calls in one CUDA graph, replayed and timed
        by CUDA events. A capture launches nothing, so ``LAUNCHES`` gets
        what the capture's wrapper calls added once for each replay."""
        side = torch.cuda.Stream()  # warm up off the default stream
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        before = dict(LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(self.reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPLAYS - 1):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        del graph
        for name, at in before.items():
            LAUNCHES[name] = at + REPLAYS * (LAUNCHES[name] - at)
        return start.elapsed_time(end) * 1e3 / ((REPLAYS - 1) * self.reps)

    def flush_us(self) -> float:
        if self._flush_us is None:
            self._flush_us = self.warm(self.flush)
        return self._flush_us

    def cold(self, fn: Callable) -> float:
        """µs per call after a 128 MB write evicted L2, the write's own time
        taken out."""
        def flushed():
            self.flush()
            fn()
        return self.warm(flushed) - self.flush_us()


def _record(probe: str, variant: str, nbytes: int, us: float, us_cold: float,
            **extra) -> dict:
    bound_us = nbytes / HBM_BPS * 1e6
    return {"probe": probe, "variant": variant, "us": us, "us_cold": us_cold,
            "bytes": nbytes, "bound_us": bound_us,
            "gbps": nbytes / us / 1e3, "gbps_cold": nbytes / us_cold / 1e3,
            "share": bound_us / us, "share_cold": bound_us / us_cold,
            **extra}


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"probe check failed: {what}")


def _node_bound(lay: KKTLayout, terms: torch.Tensor) -> torch.Tensor:
    """2·deg·ε·Σ|term| per node: two summation orders of one node sum."""
    absum = torch.zeros(lay.p, dtype=terms.dtype, device=terms.device)
    absum.index_add_(0, lay.u, terms.abs()).index_add_(0, lay.v, terms.abs())
    deg = (lay.ptr[1:] - lay.ptr[:-1]).to(terms.dtype)
    return 2 * deg * torch.finfo(terms.dtype).eps * absum


# ---------------------------------------------------------------------------
# The four probes
# ---------------------------------------------------------------------------

def run_gather(lay: KKTLayout, x: torch.Tensor, timer: Timer,
               seed: int = 0, **_) -> List[dict]:
    """K14a on the instance's gathers (x_n[u], x_n[v], x_a in the CSR's
    node order) and on uniform random indices over 1K to 8M entries, each
    table on every tier that can hold it; the cluster tier also stages
    alone (``cluster_stage_only``), and a table it cannot hold gets a
    ``not_run`` record with the reason."""
    m = lay.m
    xa, xn = x[:m], x[m:]
    cases = []  # (variant, table, idx, hi, mode)
    for mode in ("smem", "ldg", "plain", "cluster"):
        cases.append((f"arc_u/{mode}/int32", xn, lay.u, None, mode))
    cases.append(("arc_v/ldg/int32", xn, lay.v, None, "ldg"))
    if lay.p <= 32767:
        cases.append(("arc_u/ldg/int16", xn, lay.u.to(torch.int16), None,
                      "ldg"))
    hi, lo = two_level(lay.u)
    cases.append(("arc_u/ldg/two_level", xn, lo, hi, "ldg"))
    arcs_of_ent = torch.where(lay.ent >= 0, lay.ent, ~lay.ent)
    for mode in ("ldg", "plain", "cluster", STAGE_ONLY):
        cases.append((f"node/{mode}/int32", xa, arcs_of_ent, None, mode))
    gen = torch.Generator(device=x.device).manual_seed(seed)
    for ntab in SWEEP:
        tab = torch.randn(ntab, generator=gen, device=x.device)
        idx = torch.randint(0, ntab, (m,), generator=gen, device=x.device,
                            dtype=torch.int32)
        for mode in ("smem", "ldg", "plain", "cluster", STAGE_ONLY):
            if mode != "smem" or ntab <= SMEM_MAX_ENTRIES:
                cases.append((f"sweep{ntab}/{mode}/int32", tab, idx, None,
                              mode))
        if ntab <= 32768:
            cases.append((f"sweep{ntab}/ldg/int16", tab, idx.to(torch.int16),
                          None, "ldg"))
    out = []
    for variant, tab, idx, hi_, mode in cases:
        extra = {}
        if mode in ("cluster", STAGE_ONLY):
            try:
                extra = cluster_shape(tab.numel(), idx.dtype, hi_ is not None,
                                      mode)
            except TableNotStaged as why:
                out.append({"probe": "gather", "variant": variant,
                            "entries": idx.numel(), "table": tab.numel(),
                            "not_run": str(why)})
                continue
            del extra["slice_log2"]

        def fn(t=tab, i=idx, h=hi_, mo=mode):
            return gather_cuda(t, i, h, mo)
        if mode == STAGE_ONLY:  # writes nothing: no check; the table once
            fn()
            out.append(_record("gather", variant, 4 * tab.numel(),
                               timer.warm(fn), timer.cold(fn),
                               entries=idx.numel(), table=tab.numel(),
                               **extra))
            continue
        g = fn()
        ref = gather_plain(tab, idx, hi_)
        _require(torch.equal(g, ref), f"gather {variant} is not tab[idx]")
        flat = gather_plain(torch.arange(tab.numel(), device=tab.device,
                                         dtype=torch.int32), idx, hi_)
        per = idx.element_size() + (2 if hi_ is not None else 0) + 4

        def lib(t=tab, f=flat):
            return torch.index_select(t, 0, f)
        out.append(_record(
            "gather", variant, per * idx.numel() + 4 * tab.numel(),
            timer.warm(fn), timer.cold(fn), entries=idx.numel(),
            table=tab.numel(), max_abs_err=float((g - ref).abs().max()),
            library_us=timer.warm(lib), library_us_cold=timer.cold(lib),
            **extra))
    return out


def run_stream(lay: KKTLayout, x: torch.Tensor, timer: Timer,
               **_) -> List[dict]:
    """K14b over the instance's arcs: every block shape, four planes and
    one interleaved record; and a device-to-device copy of the same bytes
    as the card's achieved streaming rate."""
    m = lay.m
    d, u, v, xa = lay.d, lay.u, lay.v, x[:m]
    rec = pack_records(d, u, v, xa)
    ref = stream_plain(d, u, v, xa)
    nbytes = 20 * m
    out = []
    for layout in ("soa", "aos"):
        for threads in THREADS:
            for apt in ARCS_PER_THREAD:
                if layout == "soa":
                    def fn(t=threads, a=apt):
                        return stream_cuda(d, u, v, xa, t, a)
                else:
                    def fn(t=threads, a=apt):
                        return stream_records_cuda(rec, t, a)
                y = fn()
                _require(torch.equal(y, ref),
                         f"stream {layout} {threads}x{apt} is not bitwise "
                         "its plain version")
                out.append(_record("stream", f"{layout}/{threads}x{apt}",
                                   nbytes, timer.warm(fn), timer.cold(fn),
                                   max_abs_err=float((y - ref).abs().max())))
    src = torch.empty(nbytes // 8, dtype=torch.float32, device=x.device)
    dst = torch.empty_like(src)
    out.append(_record("stream", "copy_d2d", nbytes,
                       timer.warm(lambda: dst.copy_(src)),
                       timer.cold(lambda: dst.copy_(src))))
    return out


def run_stages(lay: KKTLayout, x: torch.Tensor, timer: Timer,
               a_csr: Optional[torch.Tensor] = None, **_) -> List[dict]:
    """K14c: each stage of K7 on the instance, with K7 itself (and a
    cuSPARSE CSR SpMV of the assembled A, when ``a_csr`` is given) timed in
    the same run."""
    m = lay.m
    nbytes = kkt_function_bytes(m, lay.p)
    y7 = kkt_shard_matvec_cuda(lay, x)
    copy = node_sorted_copy(lay, x)  # built once, outside every timing
    buf = torch.zeros_like(x)
    out = []
    for mode, param in STAGES:
        y = stages_cuda(lay, x, mode, param, copy=copy)
        ref = stages_plain(lay, x, mode, param)
        err = float((y - ref).abs().max())
        if mode == "full":
            _require(torch.equal(y, y7), "stages full is not bitwise K7")
        if mode == "node_sorted":
            _require(torch.equal(y[m:], y7[m:]),
                     "stages node_sorted's y_n is not bitwise K7's")
        if mode in ARC_MODES:
            _require(torch.equal(y[:m], ref[:m]),
                     f"stages {mode} arc part is not bitwise its plain "
                     "version")
        if mode in NODE_MODES:
            terms = (TINY * torch.arange(m, device=x.device).float()
                     if "no_gather" in mode else x[:m])
            _require(bool(((y[m:] - ref[m:]).abs()
                           <= _node_bound(lay, terms)).all()),
                     f"stages {mode} node part outside 2·deg·eps·Σ|x|")

        def fn(mo=mode, pa=param):
            return stages_cuda(lay, x, mo, pa, out=buf, copy=copy)
        out.append(_record("stages", mode if not param else f"{mode}{param}",
                           nbytes, timer.warm(fn), timer.cold(fn),
                           max_abs_err=err))
    out.append(_record("stages", "k7", nbytes,
                       timer.warm(lambda: kkt_shard_matvec_cuda(lay, x)),
                       timer.cold(lambda: kkt_shard_matvec_cuda(lay, x))))
    if a_csr is not None:
        out.append(_record("stages", "cusparse", nbytes,
                           timer.warm(lambda: torch.mv(a_csr, x)),
                           timer.cold(lambda: torch.mv(a_csr, x))))
    return out


def _variant(mode: str, param: int) -> str:
    return f"{mode}{param}" if param else mode


def run_pipeline(lay: KKTLayout, x: torch.Tensor, timer: Timer,
                 **_) -> List[dict]:
    """K14d on the instance, K7 and K14c timed in the same run. Every mode
    of :data:`PIPELINE_MODES` with both stores at the default ring
    (``{mode}/{store}``), each bitwise its K14c twin (``k14c/{mode}``,
    also timed) and ``full`` bitwise K7; the arc kernel alone with each
    ALU chain (``alu{N}/arcs/{store}``, ``nodes=False``); the
    T × S × store sweep of ``full`` and ``arc_only``
    (``sweep/{mode}/T{t}xS{s}/{store}``, with the arc kernel's blocks per
    SM and dynamic shared memory); and the default ``full`` concurrent
    (``pipeline``, :data:`PROBE_MAIN`'s variant) and serialised on one
    stream (``pipeline_serial``) beside K7, K7's arc blocks alone
    (``k7_arc_only``) and its node blocks alone (``k7_node_only``: the
    node kernel's instruction stream). A check that fails raises."""
    m = lay.m
    nbytes = kkt_function_bytes(m, lay.p)
    y7 = kkt_shard_matvec_cuda(lay, x)
    buf = torch.zeros_like(x)
    out = []

    def timed(variant, fn, **extra):
        out.append(_record("pipeline", variant, nbytes, timer.warm(fn),
                           timer.cold(fn), **extra))

    def ring(store, tile=PIPE_TILE, stages=PIPE_STAGES):
        per_sm, smem = pipeline_blocks("full", tile, stages, store)
        return {"tile": tile, "stages": stages, "store": store,
                "blocks_per_sm": per_sm, "smem_bytes": smem}

    errs = {}
    for mode, param in PIPELINE_MODES:
        name = _variant(mode, param)
        twin = stages_cuda(lay, x, mode, param)
        ref = stages_plain(lay, x, mode, param)
        for store in PIPE_STORES:
            y = pipeline_cuda(lay, x, mode=mode, param=param, store=store)
            _require(torch.equal(y, twin), f"pipeline {name} {store} is not "
                     "bitwise its K14c twin")
            _require(torch.equal(y[:m], ref[:m]), f"pipeline {name} {store} "
                     "arc part is not bitwise its plain version")
            _require(mode != "full" or torch.equal(y, y7),
                     f"pipeline full {store} is not bitwise K7")
            errs[name, store] = float((y - ref).abs().max())
            timed(f"{name}/{store}",
                  lambda mo=mode, pa=param, st=store: pipeline_cuda(
                      lay, x, out=buf, mode=mo, param=pa, store=st),
                  max_abs_err=errs[name, store], **ring(store))
            if mode == "alu":
                y = pipeline_cuda(lay, x, mode=mode, param=param,
                                  store=store, nodes=False)
                _require(torch.equal(y[:m], twin[:m]),
                         f"pipeline {name} {store} arc kernel alone")
                timed(f"{name}/arcs/{store}",
                      lambda mo=mode, pa=param, st=store: pipeline_cuda(
                          lay, x, out=buf, mode=mo, param=pa, store=st,
                          nodes=False), **ring(store))
        timed(f"k14c/{name}", lambda mo=mode, pa=param: stages_cuda(
            lay, x, mo, pa, out=buf))
    for tile in PIPE_TILES:
        for stages in PIPE_STAGE_COUNTS:
            for store in PIPE_STORES:
                for mode in ("full", "arc_only"):
                    y = pipeline_cuda(lay, x, mode=mode, tile=tile,
                                      stages=stages, store=store)
                    _require(torch.equal(y, y7) if mode == "full" else
                             torch.equal(y[:m], y7[:m]),
                             f"pipeline {mode} T{tile}xS{stages} {store} is "
                             "not bitwise K7")
                    timed(f"sweep/{mode}/T{tile}xS{stages}/{store}",
                          lambda mo=mode, t=tile, s=stages, st=store:
                          pipeline_cuda(lay, x, out=buf, mode=mo, tile=t,
                                        stages=s, store=st),
                          **ring(store, tile, stages))
    y = pipeline_cuda(lay, x, concurrent=False)
    _require(torch.equal(y, y7), "pipeline serialised is not bitwise K7")
    timed("pipeline", lambda: pipeline_cuda(lay, x, out=buf),
          max_abs_err=errs["full", PIPE_STORE], **ring(PIPE_STORE))
    timed("pipeline_serial",
          lambda: pipeline_cuda(lay, x, out=buf, concurrent=False),
          **ring(PIPE_STORE))
    timed("k7", lambda: kkt_shard_matvec_cuda(lay, x))
    timed("k7_arc_only", lambda: stages_cuda(lay, x, "arc_only", out=buf))
    timed("k7_node_only", lambda: stages_cuda(lay, x, "node_only", out=buf))
    return out


def pipeline_split(records: List[dict], m: int, p: int) -> str:
    """What :func:`run_pipeline`'s records say, cold L2: K14d against K7;
    the two kernels concurrent against serialised and each alone; the
    ring's arc stream against its bound (the arcs' 20 bytes and x_n once)
    and K7's arc blocks; and, for each ALU chain N, whether the ring's arc
    kernel with the chain is nearer max(stream, ALU) or stream + ALU, the
    ALU taken at the card's f32 issue rate (2·N operations an arc; a
    multiply and an add, not contracted) and the stream the arc kernel
    alone without the chain (``arc_only``); beside it the K14c twin's (a
    grid of one arc a thread) time over its ``full``."""
    by = {r["variant"]: r for r in records if r["probe"] == "pipeline"}
    store = by["pipeline"]["store"]
    full, k7 = by["pipeline"], by["k7"]
    arc, node = by[f"arc_only/{store}"], by["k7_node_only"]
    bound_us = (20 * m + 4 * p) / HBM_BPS * 1e6
    lines = [
        f"ring T{full['tile']}xS{full['stages']}/{store}, "
        f"{full['blocks_per_sm']} blocks/SM: full {full['us_cold']:.3f} us "
        f"cold ({full['us']:.3f} warm) against K7 {k7['us_cold']:.3f} "
        f"({k7['us']:.3f}), {full['us_cold'] / k7['us_cold']:.3f}x",
        f"concurrent {full['us_cold']:.3f} us against serialised "
        f"{by['pipeline_serial']['us_cold']:.3f}; arc kernel alone "
        f"{arc['us_cold']:.3f}, node kernel alone {node['us_cold']:.3f}",
        f"arc stream {arc['us_cold']:.3f} us cold ({arc['us']:.3f} warm), "
        f"{bound_us / arc['us_cold']:.1%} of its {bound_us:.3f} us bound, "
        f"against K7's arc blocks {by['k7_arc_only']['us_cold']:.3f} "
        f"({by['k7_arc_only']['us']:.3f} warm)"]
    stream = arc["us_cold"]
    for mode, param in PIPELINE_MODES:
        if mode != "alu":
            continue
        t = by[f"alu{param}/arcs/{store}"]["us_cold"]
        alu = 2 * param * m / F32_ISSUE * 1e6
        top, both = max(stream, alu), stream + alu
        near = "max" if abs(t - top) <= abs(t - both) else "sum"
        grid = (by[f"k14c/alu{param}"]["us_cold"]
                - by["k14c/full"]["us_cold"])
        lines.append(
            f"alu {param}: ring arcs {t:.3f} us against max(stream, ALU) "
            f"{top:.3f} and sum {both:.3f} (stream {stream:.3f}, ALU "
            f"{alu:.3f}): nearer the {near}; K14c alu {param} over its full "
            f"{grid:+.3f} us")
    return "\n".join(lines)


RUNS: Dict[str, Callable] = {"gather": run_gather, "stream": run_stream,
                             "stages": run_stages, "pipeline": run_pipeline}


def run(name: str, lay: KKTLayout, x: torch.Tensor, *, reps: int = REPS,
        **kw) -> List[dict]:
    """The records of probe ``name`` on a CUDA layout and its (m + p,) f32
    x; raises on a CPU layout and when a variant fails its check."""
    if name not in RUNS:
        raise ValueError(f"probe must be one of {sorted(RUNS)}, not {name!r}")
    if lay.d.device.type != "cuda" or not x.is_cuda:
        raise ValueError("the probes run on the card: pass a CUDA layout "
                         "and x")
    return RUNS[name](lay, x, Timer(x.device, reps), **kw)


def stage_split(records: List[dict]) -> str:
    """K7's stage split from :func:`run_stages`' records: each stage's µs
    and share of K7's bound, warm and cold, which part bounds K7 and,
    where the records have ``node_sorted``, what the node walk's x_a gather
    costs beyond a contiguous read (the most an arc relabelling could give
    the node walk: it makes one endpoint's entries contiguous, not both)."""
    by = {r["variant"]: r for r in records if r["probe"] == "stages"}
    lines = [f"{name:>15}: {r['us']:9.3f} us ({100 * r['share']:5.1f} % of "
             f"bound), cold {r['us_cold']:9.3f} us "
             f"({100 * r['share_cold']:5.1f} %)"
             for name, r in by.items()]
    arc, node = by["arc_only"], by["node_only"]
    gather = node["us"] - by["node_no_gather"]["us"]
    lines.append(
        f"bound by the {'node part' if node['us'] > arc['us'] else 'arc part'}"
        f": node blocks {node['us']:.3f} us (their x_a gather "
        f"{gather:.3f} us of it) against the arc stream {arc['us']:.3f} us "
        f"of K7's {by['full']['us']:.3f} us")
    if "node_sorted" in by:
        srt = by["node_sorted"]
        lines.append(
            f"node walk on the node-sorted copy: {srt['us']:.3f} us against "
            f"node_only's {node['us']:.3f} us, the gather's sector waste "
            f"{node['us'] - srt['us']:.3f} us ({srt['us'] / node['us']:.1%} "
            f"of node_only; cold {srt['us_cold']:.3f} against "
            f"{node['us_cold']:.3f} us): the most an arc relabelling could "
            "give the node walk")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m two_pass_lanczos_tpu_torch.probes",
        description="Run a K14 probe on the card and print one JSON record "
                    "per variant.")
    ap.add_argument("probe", choices=sorted(RUNS))
    ap.add_argument("--arcs", type=int, default=500_000)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")  # raises without a card
    from two_pass_lanczos_tpu_torch.models.generator import (
        generate_mcf_instance,
    )
    inst = generate_mcf_instance(args.arcs, rho=3, instance_id=1)
    m, p = inst.num_arcs, inst.num_nodes
    lay = KKTLayout.build(inst.quad_costs, inst.arc_u, inst.arc_v, p, dev)
    x = torch.from_numpy(np.random.default_rng(args.seed).standard_normal(
        m + p).astype(np.float32)).to(dev)
    kw = {"seed": args.seed}
    if args.probe == "stages":
        from two_pass_lanczos_tpu_torch.models.kkt import kkt_sorted_coo
        from two_pass_lanczos_tpu_torch.utils.data_loader import KKTArrays
        coo = kkt_sorted_coo(KKTArrays(
            quad_costs=inst.quad_costs, arc_u=inst.arc_u, arc_v=inst.arc_v,
            num_nodes=p, num_arcs=m), dtype=np.float32, device=dev)
        kw["a_csr"] = torch.sparse_csr_tensor(coo.indptr, coo.cols, coo.vals,
                                              size=(m + p, m + p))
    card = card_name()
    records = run(args.probe, lay, x, reps=args.reps, **kw)
    for r in records:
        print(json.dumps({**r, "arcs": m, "nodes": p, "card": card}))
    if args.probe == "stages":
        print(stage_split(records), file=sys.stderr)
    if args.probe == "pipeline":
        print(pipeline_split(records, m, p), file=sys.stderr)
    return 0
