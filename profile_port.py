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
- ``top``: ``[name, device ms per call, launches per call]`` by device time.

Prints a table per path and the card's ``nvidia-smi`` name and power limit;
writes the numbers as JSON to ``--out``. Raises when the trace holds no
device event.
"""

from __future__ import annotations

import argparse
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


def device_events(prof):
    """(name, start µs, end µs) of every device-side event of the trace."""
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def busy_us(events) -> float:
    """Length of the union of the events' intervals."""
    total, end = 0.0, float("-inf")
    for _, s, e in sorted(events, key=lambda t: t[1]):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def overlap_us(events, pick, against):
    """``(total, overlapped, hit)``: µs of the events whose name ``pick``s,
    how many of those µs an event that ``against`` picks ran at the same
    time, and how many picked events overlapped one at all."""
    import bisect
    mine = [(s, e) for name, s, e in events if pick(name)]
    merged = []
    for s, e in sorted((s, e) for name, s, e in events if against(name)):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts = [s for s, _ in merged]
    total = over = 0.0
    hit = 0
    for s, e in mine:
        total += e - s
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        here = 0.0
        while i < len(merged) and merged[i][0] < e:
            here += max(0.0, min(e, merged[i][1]) - max(s, merged[i][0]))
            i += 1
        over += here
        hit += here > 0
    return total, over, hit


def is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


def is_compute(name: str) -> bool:
    """A kernel, not a copy, a memset or a NCCL range."""
    low = name.lower()
    return not (is_nccl(name) or low.startswith(("memcpy", "memset")))


def is_segment_reduce(name: str) -> bool:
    """The row sums of ``coo_spmv`` (``torch.segment_reduce``), the owned
    SpMV's last kernel and by far its longest."""
    return "segmentedreduce" in name.lower().replace("_", "")


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
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(prof)
    if not events:
        raise RuntimeError("the profiler recorded no device event")
    per_name = defaultdict(lambda: [0.0, 0])
    for name, s, e in events:
        per_name[name][0] += e - s
        per_name[name][1] += 1
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
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
    return {**extra, "wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "events": len(events) / reps,
            "top": [[name[:60], t / 1e3 / reps, round(c / reps)]
                    for name, (t, c) in top],
            "host_top": [[a.key[:60], a.self_cpu_time_total / 1e3 / reps,
                          round(a.count / reps)] for a in host[:6]]}


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
        print("    host self time:")
        for kname, ms, count in r["host_top"]:
            print(f"    {ms:9.4f} ms  x {count:6d}  {kname}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    out["card"] = card
    out["k"] = k
    torch.distributed.destroy_process_group()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
