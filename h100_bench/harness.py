"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the plain reference, and the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; each
is a data file found by its name (``configs/<name>.json``,
``traffic/<name>.json``), and the cell's limits are ``limits/<cell>.json``.
A configuration names its generator (``generators/<name>.py``) and its
plain reference (``references/<name>.py``); a traffic mix names its entry
into the program (``entries/<name>.py``); a per-layer metric is read by
``metrics/<name>.py``. Nothing here names a cell, a configuration, a mix or
a metric.

The traffic is a closed loop with one caller: draw b ~ N(0, 1) on the
device from the seed and the call's index, call the entry, wait for the
device. ``solve_ms`` is the window's wall time over the calls completed in
it, ``solve_p95_ms`` the 95th percentile of the calls' times (call to
synchronise), ``peak_mem_mb`` the allocator's peak over the window, in
units of 10^6 bytes. The window's clock stops while the check copies a
sampled call's answer to the host: that copy is the benchmark's work, not
the system's. A traced run hands the per-layer readers the host clock's
times of its calls before the traced stretch, which no profiler slows.

A cell whose ``chips`` is D > 1 runs as D processes, one a card, in one
process group (``ranks.py``); a cell of one card forms no group and starts
no process. Every rank generates the same instance, builds the system on
its card (``cuda:<rank>``), draws b there from the same seed (the same
bits, which one checksum after the warm-up confirms) and makes the same
calls in the same order. Rank 0 keeps the clock: before each call it tells
the other ranks whether the window goes on, by one write to the group's
store that counts as the benchmark's work (the clock stops for it, as for
the check's copies; its cost is reported under ``ranks``). Rank 0 does
not wait for the other ranks there: one that ends a call later holds up
rank 0's next call, and that wait stays on the clock. ``solve_ms`` and
``solve_p95_ms`` are rank 0's; ``setup_s`` runs from rank 0's start to a
barrier after every rank's warm-up and holds a ``ranks`` phase (the other
processes' start, their imports and the group's set-up);
``peak_mem_mb`` is the largest window peak of the ranks and
``memory_peak_bytes`` the largest peak, set-up or window, of any card. With
``--trace 1`` every rank calls through ``entry.traced``, but only rank 0's
profiler records: the per-layer metrics and the breakdown are rank 0's
stretch and rank 0's counters. After the window every rank frees its
state and the other ranks leave; rank 0 alone checks its outputs against
the reference and prints the result.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from h100_bench import compare, peaks
from h100_bench import trace as tracing
from h100_bench.ranks import (
    ENV_PARENT,
    WINDOW_SLACK_S,
    Ranks,
    checksum,
    fault_of,
    fold,
)

#: when this module's imports (torch's among them) were done
IMPORTED = time.perf_counter()

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "two_pass_lanczos_tpu")
#: the device type the ranks drive: unset, CUDA; the CPU tests set "cpu"
ENV_DEVICE = "H100_BENCH_DEVICE"
#: draws of b: the window's calls, and the warm-up calls apart from them
WINDOW, WARMUP = 0, 1


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def find_cell(spec: dict, workload: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def module(kind: str, name: str, bench: Path = BENCH):
    """``<bench>/<kind>/<name>.py``: a generator, reference, entry or
    metric, found by its name (``bench`` another tree of the same layout,
    as the tests make; a name with a dot, such as a metric split by the
    end-to-end metric it moves, is loaded from its file)."""
    if bench == BENCH and "." not in name:
        return importlib.import_module(f"h100_bench.{kind}.{name}")
    path = Path(bench) / kind / f"{name}.py"
    key = f"h100_bench_tree_{abs(hash(str(path)))}.{kind}.{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        sys.modules[key] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[key])
    return sys.modules[key]


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run may not load."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def forbidden_mask() -> int:
    """:func:`forbidden_modules` as bits over :data:`FORBIDDEN`."""
    found = forbidden_modules()
    return sum(1 << bit for bit, name in enumerate(FORBIDDEN)
               if name in found)


class Rhs:
    """b for call ``i`` of a stream: N(0, 1) float32 on the device from a
    seed of (run seed, stream, i), so the check can draw it again."""

    def __init__(self, seed: int, n: int, device: torch.device):
        self.words = [int(w) for w in divmod(int(seed) % 2 ** 64, 2 ** 32)]
        self.n, self.device = n, device
        self.gen = torch.Generator(device=device)

    def __call__(self, i: int, stream: int = WINDOW) -> torch.Tensor:
        hi, lo = np.random.SeedSequence(
            [*self.words, stream, i]).generate_state(2)
        self.gen.manual_seed((int(hi) << 31) ^ int(lo))
        return torch.randn(self.n, generator=self.gen, device=self.device,
                           dtype=torch.float32)


class Reservoir:
    """A sample, drawn from the seed, of ``size`` of the calls seen."""

    def __init__(self, seed: int, size: int):
        self.rng = np.random.default_rng([int(seed) % 2 ** 64, 7])
        self.size = size
        self.kept: dict = {}  # slot -> (call index, host outputs)
        self.seen = 0

    def slot(self) -> Optional[int]:
        """The slot the next call takes, None where it is not kept."""
        i, self.seen = self.seen, self.seen + 1
        if i < self.size:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.size else None

    def items(self):
        return sorted(self.kept.values(), key=lambda t: t[0])


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device) + ", power limit not read"


def read_per_layer(spec: dict, workload: str, ctx, bench: Path = BENCH
                   ) -> dict:
    """Every per-layer metric of the cell that its reader finds."""
    out = {}
    for metric in spec["per_layer"]:
        if not applies(metric, workload):
            continue
        value = module("metrics", metric["name"], bench).read(ctx)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


class Context:
    """What a per-layer metric's reader reads: the traced stretch, the
    program's counters over it, the instance's sizes, the traffic, the
    steps each traced call took, the card's peaks, the ranks the cell
    runs on (``world``) and the host clock's times of the window's calls
    before the traced stretch (``call_ms``). In a D-rank cell the
    stretch, the counters, the steps and the times are rank 0's."""

    def __init__(self, stretch, counters, instance, traffic, steps, peak,
                 world=1, call_ms=()):
        self.world = world
        self.call_ms = list(call_ms)
        self.stretch = stretch
        self.solves = stretch.solves
        self.counters = counters
        self.m, self.p = instance.num_arcs, instance.num_nodes
        self.n = self.m + self.p
        self.traffic = traffic
        self.steps = steps
        self.peak = peak


def load_cell(spec: dict, workload: str, bench: Path = BENCH):
    """``(cell, config, traffic, limits)`` of a workload, each from the
    file its name gives."""
    cell = find_cell(spec, workload)
    return (cell, load_json(bench / "configs" / f"{cell['config']}.json"),
            load_json(bench / "traffic" / f"{cell['traffic']}.json"),
            load_json(bench / "limits" / f"{workload}.json"))


def instance(config: dict, bench: Path = BENCH):
    """The configuration's instance, d rounded to the f32 both sides get."""
    inst = module("generators", config["generator"], bench).generate(
        **config["instance"])
    return inst._replace(quad_costs=inst.quad_costs.astype(np.float32))


def run_cell(spec: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", entry=None,
             started: Optional[float] = None, bench: Path = BENCH,
             log=sys.stderr, ranks: Optional[Ranks] = None
             ) -> Optional[dict]:
    """One run; returns the result line's object. ``entry`` replaces the
    traffic's entry module (the tests break the program through it).
    ``ranks`` is the group of a D-rank cell, whose ranks each drive their
    own card (``device`` is then ``ranks.device``); a rank other than 0
    returns None once it has left the group."""
    t0 = time.perf_counter() if started is None else started
    # set-up's phases, each ended by a mark: they show what makes it swing
    marks = [("imports", IMPORTED)] if t0 < IMPORTED else []
    if ranks is not None:
        marks.append(("ranks", ranks.joined))
    lead = ranks is None or ranks.rank == 0
    cell, config, traffic, limits = load_cell(spec, workload, bench)
    dev = torch.device(device) if ranks is None else ranks.device
    torch.empty(0, device=dev)
    marks.append(("context", time.perf_counter()))
    entry = entry or module("entries", traffic["entry"], bench)
    inst = instance(config, bench)
    n = inst.num_arcs + inst.num_nodes
    marks.append(("instance", time.perf_counter()))
    system = entry.build(inst, traffic, dev)
    sync(dev)
    marks.append(("build", time.perf_counter()))
    rhs = Rhs(seed, n, dev)
    for i in range(traffic["warmup_solves"]):
        entry.solve(system, rhs(i, WARMUP), traffic)
        sync(dev)
    if ranks is not None:
        ranks.barrier()
    marks.append(("warmup", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    print("setup_s " + " ".join(
        f"{name} {end - begin:.3f}" for (name, end), begin in
        zip(marks, [t0] + [t for _, t in marks[:-1]])), file=log)

    cuda = dev.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if ranks is not None:
        # the same b on every rank, or the ranks solve different systems
        sums = [s[0] for s in ranks.gather([checksum(rhs(0, WARMUP))])]
        if lead and len(set(sums)) > 1:
            ranks.abort(f"b's checksums differ across the ranks: {sums}")
        ranks.deadline = time.monotonic() + seconds + WINDOW_SLACK_S
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    first = traffic["trace_after_solves"]
    last = first + traffic["trace_solves"]
    spanned = entry.traced(system) if trace else system
    prof, counters0, steps = None, None, []
    sample = Reservoir(seed, traffic["check_solves"])
    times, exchanges, before = [], [], []
    sync(dev)
    w0 = t_end = time.perf_counter()
    # the check's copies of sampled answers and the ranks' exchange: the
    # benchmark's work, not the system's
    paused = 0.0
    i = 0
    while True:
        go = t_end - w0 - paused < seconds or (trace and i < last)
        if ranks is not None:
            tx = time.perf_counter()
            go = ranks.flag(i, go)
            if go:
                exchanges.append(time.perf_counter() - tx)
                paused += exchanges[-1]
        if not go:
            break
        traced = trace and first <= i < last
        if traced and prof is None and lead:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            counters0 = entry.counters()
        if traced:
            with torch.profiler.record_function("bench.draw"):
                b = rhs(i)
                sync(dev)
            with torch.profiler.record_function(tracing.SOLVE):
                ts = time.perf_counter()
                out = entry.solve(spanned, b, traffic)
                sync(dev)
                t_end = time.perf_counter()
            if out.steps is not None:
                steps.append(int(out.steps))
        else:
            b = rhs(i)
            ts = time.perf_counter()
            out = entry.solve(system, b, traffic)
            sync(dev)
            t_end = time.perf_counter()
        times.append(t_end - ts)
        if i < first:
            before.append(times[-1])
        slot = sample.slot() if lead else None
        if slot is not None:
            sample.kept[slot] = (i, compare.host_output(out))
            paused += time.perf_counter() - t_end
        i += 1
        if prof is not None and i == last:
            counters1 = entry.counters()
            prof.__exit__(None, None, None)
    wall = t_end - w0 - paused
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    folded = None
    if ranks is not None:
        folded = fold(ranks.gather([setup_peak, window_peak, len(times),
                                    forbidden_mask()]), FORBIDDEN)
        if lead and fault_of(folded):
            ranks.abort(fault_of(folded))
    del system, spanned, out, b
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if ranks is not None:
        ranks.leave()
        if not lead:
            return None
        ranks.close()

    mem_peak = max(setup_peak, window_peak)
    if folded is not None:  # the fullest card's
        mem_peak, window_peak = folded["memory_peak"], folded["window_peak"]
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    result = {"correct": False, "attempted": len(times), "failed": 0,
              "metrics": {},
              "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                         "count": int(cell["chips"]),
                         "memory_peak_bytes": int(mem_peak)}}
    if trace:
        stretch = tracing.reduce_profile(prof)
        counters = {k: counters1[k] - counters0.get(k, 0) for k in counters1}
        ctx = Context(stretch, counters, inst, traffic, steps,
                      peaks.peak_of(kind),
                      1 if ranks is None else ranks.world,
                      [1e3 * t for t in before])
        result["metrics"] = read_per_layer(spec, workload, ctx, bench)
        result["device"]["busy_s"] = stretch.busy_us / 1e6
        result["device"]["window_s"] = stretch.window_us / 1e6
        result["breakdown"] = stretch.breakdown
    else:
        e2e = {"setup_s": setup_s,
               "solve_ms": 1e3 * wall / len(times),
               "solve_p95_ms": 1e3 * float(np.percentile(times, 95)),
               "peak_mem_mb": window_peak / 1e6}
        for metric in spec["end_to_end"]:
            if applies(metric, workload):
                result["metrics"][metric["name"]] = {
                    "value": e2e[metric["name"]], "unit": metric["unit"]}
    if folded is not None:
        us = sorted(1e6 * x for x in exchanges)
        result["ranks"] = {
            "world": ranks.world, "calls": folded["calls"],
            "setup_peak_bytes": folded["setup_peaks"],
            "window_peak_bytes": folded["window_peaks"],
            "exchange_us_median": float(np.median(us)) if us else None,
            "exchange_us_max": us[-1] if us else None}
        print("ranks " + " ".join(f"{k} {v}" for k, v in
                                  result["ranks"].items()), file=log)
    result["card"] = card(dev)

    # the check, once the window has closed and the program's state is freed
    reference = module("references", config["reference"], bench)
    matrix = reference.KKTMatrix(inst.quad_costs, inst.arc_u, inst.arc_v,
                                 inst.num_nodes, dev)
    per_solve = []
    for index, got in sample.items():
        ref = reference.solve(matrix, rhs(index).double(), traffic["k"],
                              traffic["f"], config["breakdown_tol"])
        per_solve.append(compare.numbers(got, ref))
    correct, failed, checks = compare.judge(per_solve, limits)
    result["correct"] = correct
    result["failed"] = failed
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=log)
    return result


def _other_rank(spec: dict, args, device_type: str, bench: Path,
                started: Optional[float]) -> int:
    """Ranks 1 … D − 1 of a D-rank cell: join rank 0's group, make the
    run's calls, leave. Any fault ends the process with 1 at once (rank
    0's watchdog sees it); nothing here writes the result."""
    try:
        ranks = Ranks.from_env(device_type)
        run_cell(spec, args.workload, args.seed, args.seconds,
                 bool(args.trace), started=started, bench=bench,
                 ranks=ranks)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    return 0


def main(argv=None, started: Optional[float] = None,
         bench: Path = BENCH) -> int:
    """Run one cell from the command line (``argv`` after the program's
    name) in the tree ``bench``, whose ``BENCHMARK.json`` lies beside it;
    print the result line; return the exit code."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_json(Path(bench).parent / "BENCHMARK.json")
    chips = int(find_cell(spec, args.workload)["chips"])
    device_type = os.environ.get(ENV_DEVICE, "cuda")
    if ENV_PARENT in os.environ:
        return _other_rank(spec, args, device_type, bench, started)
    if device_type == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < chips):
        print(f"needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ranks = None
    try:
        if chips > 1:
            ranks = Ranks.launch(chips, Path(bench) / "run.py", argv,
                                 device_type)
        result = run_cell(spec, args.workload, args.seed, args.seconds,
                          bool(args.trace), device=device_type,
                          started=started, bench=bench, ranks=ranks)
    except BaseException:
        if ranks is None:
            raise
        traceback.print_exc()
        ranks.abort("rank 0 raised")
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: no result", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0
