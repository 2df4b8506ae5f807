"""Shared plumbing of the experiment CLIs.

Counterpart of ``two_pass_lanczos_tpu/experiments/common.py``: logging (on
stderr, so that a worker's stdout carries its ``ROW,`` lines only), the
device a CLI runs on, timed solves, the memory columns, the
orchestrator/worker re-exec of ``--isolate`` (``src/bin/tradeoff.rs:44,
160-201``) and CSV writing.

The memory columns: on the card ``rss_kb`` and ``device_peak_kb`` are the
caching allocator's peak of allocated bytes over one row, reset before the
row (:func:`reset_peak_memory`), so a row's device peak needs no process
isolation; on the CPU ``rss_kb`` is the process's VmPeak, which never
resets (``--isolate`` gives each row its own process), and
``device_peak_kb`` is 0.
"""

from __future__ import annotations

import argparse
import csv
import logging
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.devices import resolve_device
from two_pass_lanczos_tpu_torch.utils.perf import (
    card_description,
    device_memory_stats,
    get_peak_rss_kb,
    reset_peak_memory,
    synchronize,
)

__all__ = ["log", "VARIANT_ENV", "K_ENV", "VARIANTS", "WorkerError",
           "setup_logging", "add_torch_device", "run_device", "log_device",
           "SolveSeconds", "timed_solve", "reset_peak_memory",
           "peak_memory_kb", "device_peak_kb", "resolve_backend",
           "KKT_BACKENDS", "kkt_solve", "write_csv",
           "known_solution_problem", "run_orchestrated", "emit_row",
           "worker_variant", "worker_k"]

log = logging.getLogger("two_pass_lanczos_tpu_torch")

VARIANT_ENV = "LANCZOS_EXPERIMENT_VARIANT"  # reference: tradeoff.rs:44
K_ENV = "LANCZOS_EXPERIMENT_K"  # one worker per (variant, k)
VARIANTS = ("standard", "two-pass")
#: the directory that holds the package, for the workers' ``-m``
_ROOT = Path(__file__).resolve().parents[2]


class WorkerError(RuntimeError):
    """An ``--isolate`` worker failed or emitted no row."""


def setup_logging():
    logging.basicConfig(
        level=os.environ.get("LOG_LEVEL", "INFO"), stream=sys.stderr,
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s")


def add_torch_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--torch-device", choices=["cuda", "cpu"], default="cuda",
                   help="run on the card (default; raises without one) or "
                        "on the CPU's plain versions")


def run_device(args) -> torch.device:
    """The device of a run: the CPU under ``--cpu-f64``, else
    ``--torch-device``; a CUDA device without a card raises."""
    cpu = getattr(args, "cpu_f64", None) is True
    return resolve_device("cpu" if cpu else args.torch_device)


def log_device(device: torch.device) -> None:
    """Log the device of the run: the card's name and power limit."""
    log.info("running on %s: %s", device, card_description(device))


class SolveSeconds(float):
    """A float (the MEDIAN solve time) carrying the full sample set:
    ``min_s`` feeds the ``time_min_s`` column, ``samples`` holds every
    draw."""

    def __new__(cls, samples):
        obj = super().__new__(cls, float(np.median(samples)))
        obj.samples = list(samples)
        obj.min_s = float(min(samples))
        return obj


def timed_solve(fn, *args, repeats: int = 1, **kwargs):
    """Run a solve ``repeats`` times, returning ``(result, SolveSeconds)``.
    Each sample ends when the card that holds the result has finished
    (``torch.cuda.synchronize()``; nothing to wait for on the CPU)."""
    samples = []
    out = None
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        synchronize(out)
        samples.append(time.perf_counter() - t0)
    return out, SolveSeconds(samples)


def peak_memory_kb(device: torch.device) -> int:
    """The ``rss_kb`` column: the device peak since the row's
    :func:`reset_peak_memory` on the card, the process's VmPeak on the
    CPU."""
    if device.type == "cuda":
        return int(device_memory_stats(device)["peak_bytes_in_use"]) // 1024
    return get_peak_rss_kb()


def device_peak_kb(device: torch.device) -> int:
    """The ``device_peak_kb`` column: the allocator's peak of allocated
    bytes since the row's :func:`reset_peak_memory`; 0 on the CPU."""
    if device.type != "cuda":
        return 0
    return int(device_memory_stats(device)["peak_bytes_in_use"]) // 1024


def resolve_backend(requested: str, device: torch.device) -> str:
    """'auto' is the fused solver on the card and the plain generic
    operator ('xla') on the CPU; any other choice stands."""
    if requested != "auto":
        return requested
    return "fused" if device.type == "cuda" else "xla"


#: the ``backend=`` of ``make_kkt_operator`` for each generic ``--backend``:
#: 'pallas' is K8 (``CudaKKTOperator``), 'xla' K8 on a card and the plain
#: matvec on the CPU
KKT_BACKENDS = {"pallas": "cuda", "xla": "auto"}


def kkt_solve(quad_costs, arc_u, arc_v, num_nodes, backend: str,
              device: torch.device, f64: bool = False):
    """``solve(k, method)`` of f = inv on b = A·(1/√n)·1 for one KKT
    instance (reference ``tradeoff.rs:235-236``), returning x on the
    device. ``backend`` ('auto' resolved): 'fused' is ``FusedKKTSolver``
    in f32 at any size (the port keeps no VMEM budget and no fallback),
    'pallas' and 'xla' the generic tier (``KKT_BACKENDS``) in f32, or f64
    under ``f64``."""
    import two_pass_lanczos_tpu_torch as tpl

    n = len(quad_costs) + int(num_nodes)
    backend = resolve_backend(backend, device)
    if backend == "fused":
        solver = tpl.FusedKKTSolver(np.asarray(quad_costs, np.float32),
                                    arc_u, arc_v, num_nodes, device=device)
        b = solver.matvec(np.full(n, 1.0 / np.sqrt(n), np.float32))

        def solve(k, method):
            return solver.solve(b, k=k, f="inv", method=method, raw=True)[0]

        return solve
    op = tpl.make_kkt_operator(
        quad_costs, arc_u, arc_v, num_nodes,
        dtype=torch.float64 if f64 else torch.float32,
        backend=KKT_BACKENDS[backend], device=device)
    _, b = known_solution_problem(op, n)

    def solve(k, method):
        return tpl.solve_fAb(op, b, k=k, f="inv", method=method)

    return solve


def write_csv(path, header: Sequence[str], rows: Iterable[Sequence]):
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(header)
        for r in rows:
            w.writerow(r)
    log.info("wrote %s", path)


def known_solution_problem(operator, n: int):
    """x_true = 1/√n·1, b = A·x_true (reference ``tradeoff.rs:235-236``)."""
    x_true = torch.full((n,), 1.0 / np.sqrt(n), dtype=operator.dtype,
                        device=operator.device)
    return x_true, operator.matvec(x_true)


def run_orchestrated(argv: List[str], parse_row,
                     k_values: Optional[Sequence[int]] = None) -> List[tuple]:
    """Re-exec ``python -m argv[0] argv[1:]`` once per variant (and, with
    ``k_values``, once per (variant, k)) with VARIANT_ENV/K_ENV set,
    collecting the headerless ``ROW,`` lines of each worker's stdout.

    A worker that exits non-zero or emits no row raises
    :class:`WorkerError`: a CSV with rows missing is never written.
    """
    rows: List[tuple] = []
    jobs = [(v, k) for v in VARIANTS
            for k in (k_values if k_values is not None else [None])]
    path = os.environ.get("PYTHONPATH")
    for variant, k in jobs:
        env = dict(os.environ, **{VARIANT_ENV: variant},
                   PYTHONPATH=str(_ROOT) + (os.pathsep + path if path else ""))
        if k is not None:
            env[K_ENV] = str(k)
        what = f"variant={variant}" + ("" if k is None else f" k={k}")
        log.info("spawning worker for %s", what)
        proc = subprocess.run([sys.executable, "-m", argv[0], *argv[1:]],
                              env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            raise WorkerError(f"worker {what} exited {proc.returncode}:\n"
                              + proc.stderr[-3000:])
        got = [parse_row(line.strip()[4:].split(","))
               for line in proc.stdout.splitlines()
               if line.strip().startswith("ROW,")]
        if not got:
            raise WorkerError(f"worker {what} emitted no row:\n"
                              + proc.stderr[-3000:])
        rows.extend(got)
    return rows


def emit_row(*fields):
    """Worker-side row emission over the stdout pipe."""
    print("ROW," + ",".join(str(f) for f in fields), flush=True)


def worker_variant() -> Optional[str]:
    return os.environ.get(VARIANT_ENV)


def worker_k() -> Optional[int]:
    """The single k this worker is isolated to (per-(variant, k) mode)."""
    v = os.environ.get(K_ENV)
    return None if v is None else int(v)
