#!/usr/bin/env python3
"""Where a solve's time goes on the card: a ``torch.profiler`` trace of the
port's paths on the headline instance, per kernel, with the device's idle
share.

Usage, from the root of a checkout, on a machine with one NVIDIA GPU::

    python3 profile_port.py [--k 500] [--reps 3] [--out chiprun_out/profile_port.json]
                            [--paths df_two_pass,two_pass]

Paths, each on ``generate_mcf_instance(500_000, rho=3, instance_id=1)``
(n = 501,155) with ``b`` from ``default_rng(0)`` already on the card:
``two_pass``, ``one_pass``, ``callback`` (never stopping, chunk 64) and
``compensated`` solves of ``FusedKKTSolver`` at ``f="inv"``, pass one alone,
monolithic (``pass_one``) and in chunks of 64 (``chunked_pass_one``),
the generic tier's ``solve_fAb`` on ``make_kkt_operator`` (K8),
``generic_two_pass`` and ``generic_one_pass``, the df tier's
``DFFusedKKTSolver.solve`` (``df_two_pass``), and the sharded solvers on a
one-rank NCCL group, ``ShardedFusedKKTSolver.solve`` (``sharded_two_pass``,
K7) and ``DFShardedFusedKKTSolver.solve`` (``df_sharded_two_pass``, K12;
one traced call, ~600 launches a step), and the row-sharded
``ShardedSparseOperator.solve_fAb`` on the f32 KKT triplets
(``sparse_sharded_two_pass``), whose record also says how many of the
trace's NCCL ranges, and how much of their device time, overlap a compute
kernel (not a copy) and the owned-column SpMV's row sums, which are queued
between each gather's start and its wait.
The fused solver's capability methods: ``slq_trace`` (``slq_trace("inv",
k=50, num_probes=16, key=0)``, 16 K2 launches and one batched ``eigh``)
and ``chebyshev_fAb`` (degree 100 on the cached interval, 100 K1 launches
and the eager recurrence around them). The generic tier's
reorthogonalised one-pass solve ``reorth`` (``solve_fAb(..., k,
method="one_pass", reorth=True)`` on ``make_kkt_operator``: k K8 launches
and the CGS2 GEMVs over the stored rows) and the block solve
``solve_fAb_block`` (``solve_fAb_block(op, B, 100, "inv")``, B of 4
columns from ``default_rng(4)``: 4 K8 launches a block step, the QR, the
triangular solve and the block products).

``--paths`` traces the named paths only (all by default). Each path runs
twice to warm up, then ``--reps`` times under the profiler,
each call ending in ``torch.cuda.synchronize()``. Per call:

- ``wall_ms``: host clock around the profiled calls, divided by ``reps``;
- ``busy_ms``: the union of the device intervals (kernels and copies) of
  the trace, divided by ``reps``;
- ``idle_share``: ``1 - busy_ms / wall_ms``;
- ``events``: device events (kernels and copies) per call;
- ``host_top``: ``[name, host self ms per call, calls per call]`` of the
  operators that take the host longest (``key_averages``' self CPU time);
- ``top``: ``[name, device ms per call, launches per call]`` by device time;
- ``spans``, where the path opens the program's ``tpl.*`` spans
  (``observability.trace``): :func:`span_breakdown` over the profiled
  calls, the device's idle and the host's waits for the device by the
  span the host was in, and each span's launches.

Prints a table per path and the card's ``nvidia-smi`` name and power limit;
writes the numbers as JSON to ``--out``. Raises when the trace holds no
device event.
"""

from __future__ import annotations

import argparse
import bisect
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HEADLINE = {"arcs": 500_000, "rho": 3, "instance_id": 1}
CHUNK = 64
TOP = 12
#: the prefix of the program's spans (``observability.trace``), and the
#: span of one call of a solve
SPAN, SOLVE = "tpl.", "tpl.solve"
#: this script's span around each profiled call
CALL = "profile_port.call"


def trace_events(prof):
    """``(device, host)`` of a finished trace: ``(name, start µs, end µs,
    id)`` of each device operation (kernels, copies, sets; not the device's
    copies of host annotations) and of each host event; a runtime call and
    the operation it launched share the ``id``, their correlation."""
    from torch.autograd import DeviceType
    device, host = [], []
    for e in prof.events():
        row = (e.name, e.time_range.start, e.time_range.end, int(e.id or 0))
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                device.append(row)
        elif e.device_type == DeviceType.CPU:
            host.append(row)
    return device, host


def busy_us(events) -> float:
    """Length of the union of the events' intervals."""
    total, end = 0.0, float("-inf")
    for _, s, e in sorted(events, key=lambda t: t[1]):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def merged(intervals):
    """The union of ``(start, end)`` intervals as sorted, disjoint
    ``[start, end]`` lists."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap_us(events, pick, against):
    """``(total, overlapped, hit)``: µs of the events whose name ``pick``s,
    how many of those µs an event that ``against`` picks ran at the same
    time, and how many picked events overlapped one at all."""
    mine = [(s, e) for name, s, e in events if pick(name)]
    theirs = merged((s, e) for name, s, e in events if against(name))
    starts = [s for s, _ in theirs]
    total = over = 0.0
    hit = 0
    for s, e in mine:
        total += e - s
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        here = 0.0
        while i < len(theirs) and theirs[i][0] < e:
            here += max(0.0, min(e, theirs[i][1]) - max(s, theirs[i][0]))
            i += 1
        over += here
        hit += here > 0
    return total, over, hit


def is_host_sync(name: str) -> bool:
    """A runtime call that waits for the device: ``cu*Synchronize`` or a
    blocking ``cudaMemcpy``."""
    return name.endswith("Synchronize") or name == "cudaMemcpy"


def innermost(spans, times):
    """For each of ``times``, the name of the innermost of the nested
    ``spans`` (``(name, start, end)``, one thread's) that holds it, None
    where none does: one sweep over both in time order."""
    spans = sorted(spans, key=lambda sp: (sp[1], -sp[2]))
    out = [None] * len(times)
    stack, i = [], 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while i < len(spans) and spans[i][1] <= t:
            while stack and stack[-1][2] < spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out[q] = stack[-1][0] if stack else None
    return out


def span_breakdown(device, host, window: str, top: int = 4) -> dict:
    """Where the device idles and the host waits, by the program's
    ``tpl.*`` spans, per call; ``device`` and ``host`` as
    :func:`trace_events` gives them, each call inside a host span named
    ``window``.

    - ``idle_ms``: the gaps of the union of the device intervals inside
      the calls, each instant given to the innermost ``tpl.*`` span its
      host was in (``none``: in no span); the values sum to the calls'
      wall time less their busy time;
    - ``host_syncs``: runtime calls inside ``tpl.solve`` that wait for the
      device (:func:`is_host_sync`), by innermost span;
    - ``launches``: each span's ``top`` device operations launched in the
      calls, by count, each placed by its launch (the runtime call of its
      correlation id, else its own start);
    - ``misaligned_ms``: device time of those operations that lies outside
      the call that launched them. It is 0 where the host's clock (the
      spans) and the device's (the runtime calls and operations) agree;
      where it is not, the trace's clocks were not aligned and the
      assignment above is not to be read.
    """
    calls = sorted((s, e) for name, s, e, _ in host if name == window)
    spans = [(name, s, e) for name, s, e, _ in host
             if name.startswith(SPAN)]
    if not calls or not spans:
        return {}
    busy = merged((s, e) for _, s, e, _ in device)
    # the idle pieces: each call's gaps, cut at every span's edges
    edges = sorted({t for _, s, e in spans for t in (s, e)})
    pieces, j = [], 0
    for w0, w1 in calls:
        while j < len(busy) and busy[j][1] <= w0:
            j += 1
        gaps, t, i = [], w0, j
        while i < len(busy) and busy[i][0] < w1:
            if busy[i][0] > t:
                gaps.append((t, busy[i][0]))
            t = max(t, busy[i][1])
            i += 1
        if t < w1:
            gaps.append((t, w1))
        for g0, g1 in gaps:
            lo, hi = bisect.bisect_right(edges, g0), bisect.bisect_left(
                edges, g1)
            cuts = [g0, *edges[lo:hi], g1]
            pieces.extend(zip(cuts, cuts[1:]))
    idle = defaultdict(float)
    for (a, b), name in zip(pieces, innermost(
            spans, [(a + b) / 2 for a, b in pieces])):
        idle[name or "none"] += b - a
    solves = sorted((s, e) for name, s, e in spans if name == SOLVE)
    waits = [s for name, s, _, _ in host if is_host_sync(name)
             and _holds(solves, s)]
    syncs = defaultdict(int)
    for name in innermost(spans, waits):
        syncs[name] += 1
    runtime = {i: s for name, s, _, i in host if name.startswith("cu")}
    launched, outside = [], 0.0
    for name, s, e, i in device:
        t = runtime.get(i, s)
        c = bisect.bisect_right(calls, (t, float("inf"))) - 1
        if c >= 0 and t <= calls[c][1]:
            launched.append((name, t))
            outside += min(e - s, max(0.0, calls[c][0] - s)
                           + max(0.0, e - calls[c][1]))
    launches = defaultdict(lambda: defaultdict(int))
    for (name, _), span in zip(launched, innermost(
            spans, [t for _, t in launched])):
        launches[span or "none"][name[:60]] += 1
    n = len(calls)
    return {
        "idle_ms": {k: v / 1e3 / n for k, v in sorted(idle.items())},
        "host_syncs": {k: v / n for k, v in sorted(syncs.items())},
        "launches": {k: [[kn, c / n] for kn, c in sorted(
            v.items(), key=lambda kv: -kv[1])[:top]]
            for k, v in sorted(launches.items())},
        "misaligned_ms": outside / 1e3 / n}


def _holds(intervals, t) -> bool:
    """Whether t lies in one of the sorted, disjoint ``intervals``."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]


def is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


def is_compute(name: str) -> bool:
    """A kernel, not a copy, a memset or a NCCL range."""
    low = name.lower()
    return not (is_nccl(name) or low.startswith(("memcpy", "memset")))


def is_segment_reduce(name: str) -> bool:
    """The row sums of ``coo_spmv``: K15 (``csr_spmv_kernel``, one launch a
    product on the card) or ``torch.segment_reduce``'s (CUB's segmented
    reduce, the plain version's last kernel and by far its longest)."""
    low = name.lower().replace("_", "")
    return "segmentedreduce" in low or "csrspmv" in low


def profile(fn, reps: int, overlap: bool = False) -> dict:
    import torch
    from torch.profiler import ProfilerActivity
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            with torch.profiler.record_function(CALL):
                fn()
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device, host = trace_events(prof)
    events = [(name, s, e) for name, s, e, _ in device]
    if not events:
        raise RuntimeError("the profiler recorded no device event")
    per_name = defaultdict(lambda: [0.0, 0])
    for name, s, e in events:
        per_name[name][0] += e - s
        per_name[name][1] += 1
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    by_self = sorted(prof.key_averages(),
                     key=lambda a: -a.self_cpu_time_total)
    wall_ms = wall * 1e3 / reps
    busy_ms = busy_us(events) / 1e3 / reps
    extra = {}
    if overlap:
        extra = {"nccl_events": sum(is_nccl(n) for n, _, _ in events) / reps}
        for label, against in (("compute", is_compute),
                               ("row_sums", is_segment_reduce)):
            nccl_us, over_us, hit = overlap_us(events, is_nccl, against)
            extra["nccl_ms"] = nccl_us / 1e3 / reps
            extra[f"nccl_overlap_{label}_ms"] = over_us / 1e3 / reps
            extra[f"nccl_events_overlapping_{label}"] = hit / reps
    spans = span_breakdown(device, host, CALL)
    if spans:
        extra["spans"] = spans
    return {**extra, "wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "events": len(events) / reps,
            "top": [[name[:60], t / 1e3 / reps, round(c / reps)]
                    for name, (t, c) in top],
            "host_top": [[a.key[:60], a.self_cpu_time_total / 1e3 / reps,
                          round(a.count / reps)] for a in by_self[:6]]}


def chebyshev(s, b):
    """The fused Chebyshev expansion of phase 21 of ``chip_smoke.py``:
    degree 100, f = exp(t/ρ) on the solver's cached interval, ρ its
    radius (the first call estimates the interval)."""
    import numpy as np
    iv = s.estimate_interval()
    rho = 0.5 * (iv[1] - iv[0])
    return s.chebyshev_fAb(b, lambda t: np.exp(t / rho), degree=100,
                           interval=iv, raw=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=500)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "profile_port.json"))
    ap.add_argument("--paths", default="",
                    help="comma-separated paths to trace (default: all)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_port: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from two_pass_lanczos_tpu_torch import (
        DFFusedKKTSolver,
        FusedKKTSolver,
        generate_mcf_instance,
        make_kkt_operator,
        solve_fAb,
        solve_fAb_block,
    )
    from two_pass_lanczos_tpu_torch.parallel import (
        DFShardedFusedKKTSolver,
        ShardedFusedKKTSolver,
        ShardedSparseOperator,
        make_mesh,
    )
    from two_pass_lanczos_tpu_torch.utils.data_loader import KKTArrays

    dev = torch.device("cuda", 0)
    inst = generate_mcf_instance(**HEADLINE)
    solvers = {comp: FusedKKTSolver(inst.quad_costs, inst.arc_u, inst.arc_v,
                                    inst.num_nodes, device=dev,
                                    compensated=comp)
               for comp in (False, True)}
    s, sc = solvers[False], solvers[True]
    op = make_kkt_operator(inst.quad_costs, inst.arc_u, inst.arc_v,
                           inst.num_nodes, dtype=torch.float32, device=dev)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(s.n)
                         .astype(np.float32)).to(dev)
    arrays = (inst.quad_costs, inst.arc_u, inst.arc_v, inst.num_nodes)
    sdf = DFFusedKKTSolver(*arrays, device=dev)
    mesh = make_mesh(1, device=dev)  # a one-rank NCCL group
    sh = ShardedFusedKKTSolver(*arrays, mesh)
    shdf = DFShardedFusedKKTSolver(*arrays, mesh)
    sop = ShardedSparseOperator.from_kkt_arrays(
        KKTArrays(quad_costs=inst.quad_costs, arc_u=inst.arc_u,
                  arc_v=inst.arc_v, num_nodes=inst.num_nodes,
                  num_arcs=inst.num_arcs), mesh, dtype=np.float32)
    b64 = b.double()
    b_block = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (s.n, 4)).astype(np.float32)).to(dev)
    k = args.k
    paths = {
        "two_pass": lambda: s.solve(b, k=k, raw=True),
        "one_pass": lambda: s.solve(b, k=k, method="one_pass", raw=True),
        "callback": lambda: s.solve(b, k=k, raw=True,
                                    callback=lambda *_: True,
                                    callback_chunk=CHUNK),
        "compensated": lambda: sc.solve(b, k=k, raw=True),
        "chunked_pass_one": lambda: s.pass_one_chunked(b, k, chunk=CHUNK),
        "pass_one": lambda: s.pass_one(b, k),
        "generic_two_pass": lambda: solve_fAb(op, b, k=k, f="inv"),
        "generic_one_pass": lambda: solve_fAb(op, b, k=k, f="inv",
                                              method="one_pass"),
        "df_two_pass": lambda: sdf.solve(b64, k=k),
        "sharded_two_pass": lambda: sh.solve(b, k=k, raw=True),
        "df_sharded_two_pass": lambda: shdf.solve(b64, k=k, raw=True),
        "sparse_sharded_two_pass": lambda: sop.solve_fAb(b, k=k, f="inv",
                                                         raw=True),
        "slq_trace": lambda: s.slq_trace("inv", k=50, num_probes=16, key=0),
        "chebyshev_fAb": lambda: chebyshev(s, b),
        "reorth": lambda: solve_fAb(op, b, k=k, f="inv", method="one_pass",
                                    reorth=True),
        "solve_fAb_block": lambda: solve_fAb_block(op, b_block, 100, "inv"),
    }
    chosen = args.paths.split(",") if args.paths else list(paths)
    unknown = sorted(set(chosen) - set(paths))
    if unknown:
        raise SystemExit(f"profile_port: unknown paths {unknown}; known: "
                         f"{sorted(paths)}")
    out = {}
    for name in chosen:
        fn = paths[name]
        reps = 1 if name == "df_sharded_two_pass" else args.reps
        r = out[name] = profile(fn, reps,
                                overlap=name == "sparse_sharded_two_pass")
        print(f"== {name}: wall {r['wall_ms']:.3f} ms/solve, device busy "
              f"{r['busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}, "
              f"{r['events']:.0f} device events")
        if "nccl_ms" in r:
            print(f"    NCCL ranges {r['nccl_events']:.0f} a solve, "
                  f"{r['nccl_ms']:.4f} ms of device time; "
                  f"{r['nccl_events_overlapping_compute']:.0f} overlap a "
                  f"compute kernel for {r['nccl_overlap_compute_ms']:.4f} ms"
                  f", {r['nccl_events_overlapping_row_sums']:.0f} the owned "
                  f"SpMV's row sums for {r['nccl_overlap_row_sums_ms']:.4f} "
                  "ms")
        for kname, ms, count in r["top"]:
            print(f"    {ms:9.4f} ms  x {count:4d}  {kname}")
        if "spans" in r:
            print("    device idle (ms) and host waits by span: " + ", ".join(
                f"{span} {ms:.4f}" for span, ms in r["spans"]["idle_ms"]
                .items()) + "; " + ", ".join(
                f"{span} {c:g}" for span, c in r["spans"]["host_syncs"]
                .items()))
        print("    host self time:")
        for kname, ms, count in r["host_top"]:
            print(f"    {ms:9.4f} ms  x {count:6d}  {kname}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    out["card"] = card
    out["k"] = k
    sh.release_graphs()
    torch.distributed.destroy_process_group()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
