#!/usr/bin/env python3
"""Time the port's matvec kernels, its persistent passes and the solves
around them in several checkouts, in turns, on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with one card::

    python3 compare_port.py --tree parent=PATH --tree tree=. \\
        [--derive NAME=BASE:CONST=VALUE[,CONST=VALUE]] \\
        [--order parent,tree,tree,parent] [--quick | --probes] \\
        [--out chiprun_out/compare_port.json]

``--tree NAME=PATH`` names a checkout (a ``git archive`` of another commit
unpacked into an ignored directory, or ``.``). ``--derive`` makes a copy of
checkout BASE's package under ``build/compare_port/NAME`` with each named
``constexpr`` of its CUDA sources set to VALUE (a measurement of a design
choice that the sources name as a constant, such as pass one's grid,
``kPassOneBlocksPerSM``); the copy is built like any checkout. Each turn
of ``--order`` (default: the first tree, every other tree twice, the first
tree again) is one process that imports ``two_pass_lanczos_tpu_torch`` from
that checkout, which builds its kernels into the checkout's own ``build/``
at first use, and prints one JSON record; so the kernels of two trees never
share a process or a build.

What a turn measures, on ``generate_mcf_instance(500_000, rho=3,
instance_id=1)`` (the headline, m = 500,000, p = 1,155) and on the 5M-arc
instance (m = 5,000,000, p = 3,651), b and x from ``default_rng(0)``:

- ``ms``: K1 (``kkt_matvec_cuda``), K8 in f32 and f64
  (``kkt_operator_matvec_cuda``) and K7 (``kkt_shard_matvec_cuda``, e = 1)
  as device time, 200 launches in one CUDA graph, and their block-row
  references where the checkout has them; K2, K3, K4, K5 (the chunk loop of
  ``pass_one_chunked``, chunks of 64) and K6 (compensated K2) at k = 500 by
  CUDA events around the pass, the mean of 3 (K1, K7, K2 and K3 also at
  5M);
- ``split``: the phase timer's split of a K2, K3, K4 and K5 step
  (``phase_split``: max, median and mean over the blocks), where the
  checkout's pass takes a ``phase_clock``;
- ``solve_s``: host-clock medians of the fused solves (k = 500 of 5, k =
  1000 of 3, one-pass, callback never stopping at chunk 64, compensated;
  5M of 3); without ``--quick`` also the arc-sharded solve
  (``ShardedFusedKKTSolver`` on a one-rank NCCL group, 5) and the generic
  ``solve_fAb(make_kkt_operator(...))`` (5), and ``sol_bench``'s K7 per
  matvec and ``sol_fraction_ideal`` at both sizes.

With ``--probes`` a turn measures only the K14 probes that a probe
redesign changes, at both sizes, x from ``default_rng(19)``: the gather
K14a (``gather_cuda``) of x_n[u] and of x_a[arc of ent] through ``ldg``,
the stage probe K14c (``stages_cuda``) ``full``, ``arc_only`` and
``node_only``, and the pipeline probe K14d (``pipeline_cuda`` with the
checkout's defaults) ``full`` and its arc part alone (``arcs_only``),
beside K7, each by the checkout's own ``probes.Timer`` cold-L2 and warm,
in ms.

Prints the card's ``nvidia-smi`` name and power limit, a table of every
number by turn and the mean of each checkout's turns, and writes the
records to ``--out``. Exits non-zero when a turn fails or no card is
visible.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HEADLINE = {"arcs": 500_000, "rho": 3, "instance_id": 1}
BIG = {"arcs": 5_000_000, "rho": 3, "instance_id": 1}
K, K_LONG, CHUNK = 500, 1000, 64


def _graph_ms(fn, reps: int = 200) -> float:
    """Device ms of one call: ``reps`` calls in one CUDA graph, replayed."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(3):
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def _event_ms(fn, reps: int = 3) -> float:
    """Mean ms of ``fn`` between CUDA events, after one warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _wall_s(fn, reps: int) -> float:
    """Median host seconds of ``fn`` ending in a synchronize, after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _takes(fn, name: str) -> bool:
    import inspect
    return name in inspect.signature(fn).parameters


def worker(root: Path, quick: bool) -> dict:
    """One turn: every measurement of the module docstring on the checkout
    at ``root``."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    import two_pass_lanczos_tpu_torch as tpl
    from two_pass_lanczos_tpu_torch.ops import kkt_fused as kf
    from two_pass_lanczos_tpu_torch.ops.spmv_kernel import (
        kkt_operator_matvec_cuda,
    )
    if not Path(tpl.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {tpl.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    out = {"ms": {}, "split": {}, "solve_s": {}}
    ms, split, solve_s = out["ms"], out["split"], out["solve_s"]

    def passes(tag, solver, b, full):
        lay = solver.layout
        dec = kf.pass_one_cuda(lay, b, K, solver.tol, solver.ztol)
        y = kf.scaled_y(dec, "inv", K)
        ms[f"K2{tag}"] = _event_ms(lambda: kf.pass_one_cuda(
            lay, b, K, solver.tol, solver.ztol))
        ms[f"K3{tag}"] = _event_ms(lambda: kf.pass_two_cuda(
            lay, b, dec, y, solver.ztol))
        runs = {"K2": ("lanczos_pass_one", lambda c: kf.pass_one_cuda(
                    lay, b, K, solver.tol, solver.ztol, phase_clock=c)),
                "K3": ("lanczos_pass_two", lambda c: kf.pass_two_cuda(
                    lay, b, dec, y, solver.ztol, phase_clock=c))}
        if full:
            bufs = kf.PassOneBuffers.alloc(lay, K, persistent=True)

            def chunks(c=None):
                for j0 in range(0, K, CHUNK):
                    kw = {} if c is None else {"phase_clock": c}
                    kf.pass_one_chunk_cuda(lay, bufs, b, j0,
                                           min(CHUNK, K - j0), solver.tol,
                                           solver.ztol, **kw)
            ms[f"K4{tag}"] = _event_ms(lambda: kf.pass_one_basis_cuda(
                lay, b, K, solver.tol, solver.ztol))
            ms[f"K5{tag}"] = _event_ms(
                lambda: solver.pass_one_chunked(b, K, chunk=CHUNK))
            ms[f"K6{tag}"] = _event_ms(lambda: kf.pass_one_cuda(
                lay, b, K, solver.tol, solver.ztol, compensated=True))
            if _takes(kf.pass_one_basis_cuda, "phase_clock"):
                runs["K4"] = ("lanczos_pass_one_basis",
                              lambda c: kf.pass_one_basis_cuda(
                                  lay, b, K, solver.tol, solver.ztol,
                                  phase_clock=c))
                runs["K5"] = ("lanczos_pass_one_chunk", chunks)
        for kernel, (name, run) in runs.items():
            clock = kf.phase_clock(name, dev)
            run(clock)
            torch.cuda.synchronize()
            got = kf.phase_split(clock, name)
            split[f"{kernel}{tag}"] = {ph: got[ph] for ph in (
                "node rows", "matvec phase", "step")}

    def matvecs(tag, lay, x):
        ms[f"K1{tag}"] = _graph_ms(lambda: kf.kkt_matvec_cuda(lay, x))
        ms[f"K7{tag}"] = _graph_ms(lambda: kf.kkt_shard_matvec_cuda(lay, x))
        if hasattr(kf, "kkt_matvec_blockrows_cuda"):
            ms[f"K1 block rows{tag}"] = _graph_ms(
                lambda: kf.kkt_matvec_blockrows_cuda(lay, x))
            ms[f"K7 block rows{tag}"] = _graph_ms(
                lambda: kf.kkt_shard_matvec_blockrows_cuda(lay, x))

    inst = tpl.generate_mcf_instance(**HEADLINE)
    solver = tpl.FusedKKTSolver(inst.quad_costs, inst.arc_u, inst.arc_v,
                                inst.num_nodes, device=dev)
    solver_c = tpl.FusedKKTSolver(inst.quad_costs, inst.arc_u, inst.arc_v,
                                  inst.num_nodes, device=dev,
                                  compensated=True)
    lay = solver.layout
    rng = np.random.default_rng(0)
    b = torch.from_numpy(rng.standard_normal(lay.n).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal(lay.n).astype(np.float32)).to(dev)
    matvecs("", lay, x)
    lay64 = kf.KKTLayout.build(inst.quad_costs, inst.arc_u, inst.arc_v,
                               inst.num_nodes, dev, dtype=np.float64)
    x64 = x.double()
    ms["K8 f32"] = _graph_ms(lambda: kkt_operator_matvec_cuda(lay, x))
    ms["K8 f64"] = _graph_ms(lambda: kkt_operator_matvec_cuda(lay64, x64))
    passes("", solver, b, True)

    def never_stop(s_, v_, t_):
        return True

    solve_s["two-pass k=500"] = _wall_s(
        lambda: solver.solve(b, k=K, f="inv", raw=True), 5)
    solve_s["two-pass k=1000"] = _wall_s(
        lambda: solver.solve(b, k=K_LONG, f="inv", raw=True), 3)
    solve_s["one-pass"] = _wall_s(lambda: solver.solve(
        b, k=K, f="inv", method="one_pass", raw=True), 5)
    solve_s["callback"] = _wall_s(lambda: solver.solve(
        b, k=K, f="inv", raw=True, callback=never_stop,
        callback_chunk=CHUNK), 5)
    solve_s["compensated"] = _wall_s(
        lambda: solver_c.solve(b, k=K, f="inv", raw=True), 5)
    if not quick:
        from two_pass_lanczos_tpu_torch.parallel import (
            ShardedFusedKKTSolver,
            make_mesh,
        )
        from two_pass_lanczos_tpu_torch.utils.sol_bench import (
            measure_streaming_matvec,
        )
        mesh = make_mesh(1, device=dev)
        sharded = ShardedFusedKKTSolver(inst.quad_costs, inst.arc_u,
                                        inst.arc_v, inst.num_nodes, mesh)
        solve_s["arc-sharded"] = _wall_s(
            lambda: sharded.solve(b, k=K, f="inv", raw=True), 5)
        op = tpl.make_kkt_operator(inst.quad_costs, inst.arc_u, inst.arc_v,
                                   inst.num_nodes, dtype=torch.float32,
                                   device=dev)
        solve_s["generic"] = _wall_s(
            lambda: tpl.solve_fAb(op, b, k=K, f="inv"), 5)
        for tag, arcs in (("", HEADLINE["arcs"]), (" 5M", BIG["arcs"])):
            per, _, ideal, _ = measure_streaming_matvec(arcs, device=dev)
            ms[f"sol_bench K7{tag}"] = per * 1e3
            out.setdefault("sol_fraction_ideal", {})[tag.strip() or
                                                      "headline"] = (
                ideal.sol_fraction)
        sharded.release_graphs()
        torch.distributed.destroy_process_group()
    del solver, solver_c, lay64, x64
    torch.cuda.empty_cache()

    big = tpl.generate_mcf_instance(**BIG)
    solver = tpl.FusedKKTSolver(big.quad_costs, big.arc_u, big.arc_v,
                                big.num_nodes, device=dev)
    rng = np.random.default_rng(0)
    n = solver.layout.n
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    matvecs(" 5M", solver.layout, x)
    passes(" 5M", solver, b, False)
    solve_s["two-pass 5M"] = _wall_s(
        lambda: solver.solve(b, k=K, f="inv", raw=True), 3)
    out["grid"] = {name: per_sm for name, (per_sm, _) in
                   kf.persistent_grid().items()}
    return out


def probe_worker(root: Path) -> dict:
    """One ``--probes`` turn on the checkout at ``root``."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    import two_pass_lanczos_tpu_torch as tpl
    from two_pass_lanczos_tpu_torch.ops import kkt_fused as kf
    from two_pass_lanczos_tpu_torch.probes.bench import Timer
    from two_pass_lanczos_tpu_torch.probes.gather import gather_cuda
    from two_pass_lanczos_tpu_torch.probes.pipeline import pipeline_cuda
    from two_pass_lanczos_tpu_torch.probes.stages import stages_cuda
    if not Path(tpl.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {tpl.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    ms = {}
    for tag, spec in (("", HEADLINE), (" 5M", BIG)):
        inst = tpl.generate_mcf_instance(**spec)
        lay = kf.KKTLayout.build(inst.quad_costs, inst.arc_u, inst.arc_v,
                                 inst.num_nodes, dev)
        m = lay.m
        x = torch.from_numpy(np.random.default_rng(19).standard_normal(
            lay.n).astype(np.float32)).to(dev)
        arcs = torch.where(lay.ent >= 0, lay.ent, ~lay.ent)
        buf, buf7 = torch.zeros_like(x), torch.zeros_like(x)
        timer = Timer(dev)
        runs = {
            "K14a arc_u ldg": lambda: gather_cuda(x[m:], lay.u, None, "ldg"),
            "K14a node ldg": lambda: gather_cuda(x[:m], arcs, None, "ldg"),
            "K14c full": lambda: stages_cuda(lay, x, "full", out=buf),
            "K14c arc_only": lambda: stages_cuda(lay, x, "arc_only",
                                                 out=buf),
            "K14c node_only": lambda: stages_cuda(lay, x, "node_only",
                                                  out=buf),
            "K14d full": lambda: pipeline_cuda(lay, x, out=buf),
            "K14d arc_only": lambda: pipeline_cuda(lay, x, arcs_only=True,
                                                   out=buf),
            "K7": lambda: kf.kkt_shard_matvec_cuda(lay, x, out=buf7)}
        for name, fn in runs.items():
            ms[f"{name} cold{tag}"] = timer.cold(fn) / 1e3
            ms[f"{name} warm{tag}"] = timer.warm(fn) / 1e3
        del lay, x, arcs, buf, buf7, timer
        torch.cuda.empty_cache()
    return {"ms": ms, "split": {}, "solve_s": {}, "grid": {}}


def _derive(name: str, spec: str, trees: dict) -> Path:
    """A copy of checkout BASE's package with constants set (see --derive)."""
    base, _, sets = spec.partition(":")
    dst = ROOT / "build" / "compare_port" / name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(trees[base] / "two_pass_lanczos_tpu_torch",
                    dst / "two_pass_lanczos_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for item in sets.split(","):
        const, _, value = item.partition("=")
        pattern = re.compile(rf"(constexpr \w+ {re.escape(const)} = )[^;]+;")
        hits = 0
        for src in (dst / "two_pass_lanczos_tpu_torch" / "csrc").glob("*.cu*"):
            text, count = pattern.subn(rf"\g<1>{value};", src.read_text())
            if count:
                src.write_text(text)
                hits += count
        if hits != 1:
            raise SystemExit(f"--derive {name}: {const} defined {hits} times")
    return dst


def _table(records: list) -> None:
    """Print every number by turn, then each checkout's mean."""
    names = list(dict.fromkeys(r["tree"] for r in records))
    for group in ("ms", "solve_s"):
        keys = list(dict.fromkeys(k for r in records for k in r[group]))
        print(f"{group}: " + " | ".join(
            f"{i + 1}:{r['tree']}" for i, r in enumerate(records))
            + " || means " + " | ".join(names))
        for key in keys:
            got = [r[group].get(key) for r in records]
            means = [statistics.mean(v for r, v in zip(records, got)
                                     if r["tree"] == t and v is not None)
                     if any(r["tree"] == t and v is not None
                            for r, v in zip(records, got)) else None
                     for t in names]
            print(f"  {key:>22}: " + " ".join(
                "-" if v is None else f"{v:.5g}" for v in got) + " || "
                + " ".join("-" if v is None else f"{v:.5g}" for v in means))
    keys = list(dict.fromkeys(k for r in records for k in r["split"]))
    print("phase split, us a step (node rows max / median; matvec phase "
          "max; step max):")
    for key in keys:
        for i, r in enumerate(records):
            got = r["split"].get(key)
            if got:
                print(f"  {key:>8} {i + 1}:{r['tree']:<10} "
                      f"{got['node rows']['max_us']:8.3f} "
                      f"{got['node rows']['median_us']:8.3f} "
                      f"{got['matvec phase']['max_us']:8.3f} "
                      f"{got['step']['max_us']:8.3f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=PATH of a checkout")
    ap.add_argument("--derive", action="append", default=[],
                    help="NAME=BASE:CONST=VALUE[,CONST=VALUE]")
    ap.add_argument("--order", default=None)
    ap.add_argument("--quick", action="store_true",
                    help="skip the sharded and generic solves and sol_bench")
    ap.add_argument("--probes", action="store_true",
                    help="time only the K14a, K14c and K14d probes (see "
                         "above)")
    ap.add_argument("--out", default="chiprun_out/compare_port.json")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        rec = (probe_worker(Path(args.worker)) if args.probes
               else worker(Path(args.worker), args.quick))
        print(json.dumps(rec))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("compare_port: no CUDA device", file=sys.stderr)
        return 2
    trees = {}
    for item in args.tree:
        name, _, path = item.partition("=")
        trees[name] = Path(path).resolve()
        if not (trees[name] / "two_pass_lanczos_tpu_torch" / "csrc").is_dir():
            raise SystemExit(f"--tree {item}: no port package there")
    for item in args.derive:
        name, _, spec = item.partition("=")
        trees[name] = _derive(name, spec, trees)
    if not trees:
        raise SystemExit("name at least one --tree")
    names = list(trees)
    order = (args.order.split(",") if args.order else
             [names[0], *[t for t in names[1:] for _ in (0, 1)], names[0]])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    records = []
    for i, name in enumerate(order):
        t0 = time.perf_counter()
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
               str(trees[name])] + (["--quick"] if args.quick else []) + (
                   ["--probes"] if args.probes else [])
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              cwd=trees[name], env={**os.environ})
        if proc.returncode != 0:
            print(proc.stdout[-2000:] + proc.stderr[-6000:], file=sys.stderr)
            raise SystemExit(f"turn {i + 1} ({name}) failed: "
                             f"{proc.returncode}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec.update(tree=name, turn=i + 1,
                   seconds=time.perf_counter() - t0)
        records.append(rec)
        print(f"turn {i + 1} {name}: {rec['seconds']:.1f} s, blocks/SM "
              + ", ".join(f"{k_.replace('lanczos_', '')} {v}"
                          for k_, v in rec["grid"].items()), flush=True)
    _table(records)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "turns": records},
                                         indent=1))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
