"""Memory/time vs n at fixed k (reference ``src/bin/scalability.rs``).

Counterpart of ``two_pass_lanczos_tpu/experiments/scalability.py``, with
its flags and CSV. Sweeps the arc count, generating each instance (with
validation and up to ``--max-retries`` seed-rotating retries, reference
``scalability.rs:223-299``; the CSV's n depends on the instance id that
passes), then times both variants at every n, so that the CSV always
carries both (a reader such as ``python/calculate_growth_rate.py`` indexes
each variant at every n). Rows are flushed per record, so a partial run
keeps its data (``scalability.rs:198-200``). Schema: the reference's
``variant,n,k,time_s,rss_kb`` plus ``time_min_s`` and ``device_peak_kb``.
``--backend`` as in ``tradeoff``. On the card the two-pass device peak is
linear in n and the one-pass peak lies k·n·4 bytes above it.

``--isolate`` runs one worker process per (variant, size), the reference's
process model (``scalability.rs:33,155-207``); without it, rss_kb on the
CPU is the process-cumulative VmPeak.
"""

from __future__ import annotations

import argparse
import csv
import functools

MODULE = "two_pass_lanczos_tpu_torch.experiments.scalability"
HEADER = ["variant", "n", "k", "time_s", "time_min_s", "rss_kb",
          "device_peak_kb"]


def build_parser():
    from two_pass_lanczos_tpu_torch.experiments.common import add_torch_device

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arcs-start", type=int, default=50_000)
    p.add_argument("--arcs-end", type=int, default=500_000)
    p.add_argument("--arcs-step", type=int, default=50_000)
    p.add_argument("--k", type=int, default=500)
    p.add_argument("--rho", type=int, default=3)
    p.add_argument("--output", required=True)
    p.add_argument("--backend", choices=["auto", "xla", "pallas", "fused"],
                   default="auto")
    p.add_argument("--cpu-f64", action="store_true")
    p.add_argument("--repeats", type=int, default=1,
                   help="timed repetitions per cell; median + min recorded")
    p.add_argument("--max-retries", type=int, default=5)
    p.add_argument("--isolate", action="store_true",
                   help="one worker process per (variant, size) — per-row "
                        "peak-memory fidelity")
    add_torch_device(p)
    return p


def _generate_validated(arcs, rho, max_retries):
    """Generate and validate an instance, rotating the instance id on
    failure (the reference retries on downloaded-data quality issues; the
    generator is deterministic, but the validation contract is kept)."""
    from two_pass_lanczos_tpu_torch.experiments.common import log
    from two_pass_lanczos_tpu_torch.models.generator import (
        generate_mcf_instance,
    )

    for attempt in range(1, max_retries + 1):
        inst = generate_mcf_instance(arcs, rho=rho, instance_id=attempt)
        ok = (
            inst.arc_u.min() >= 0
            and inst.arc_v.min() >= 0
            and inst.arc_u.max() < inst.num_nodes
            and inst.arc_v.max() < inst.num_nodes
            and (inst.quad_costs > 0).all()
        )
        if ok:
            return inst
        log.warning("instance validation failed (attempt %d), rotating seed",
                    attempt)
    raise RuntimeError(f"could not generate a valid {arcs}-arc instance")


def _build_solve(args, arcs, device):
    """Generate and validate one instance; return ``(n, solve(method))``."""
    from two_pass_lanczos_tpu_torch.experiments.common import kkt_solve

    inst = _generate_validated(arcs, args.rho, args.max_retries)
    solve = kkt_solve(inst.quad_costs, inst.arc_u, inst.arc_v,
                      inst.num_nodes, args.backend, device, args.cpu_f64)
    return inst.num_arcs + inst.num_nodes, functools.partial(solve, args.k)


def _measure(args, variant, solve, n, emit, device):
    from two_pass_lanczos_tpu_torch.experiments.common import (
        device_peak_kb,
        log,
        peak_memory_kb,
        reset_peak_memory,
        timed_solve,
    )

    method = "one_pass" if variant == "standard" else "two_pass"
    reset_peak_memory(device)
    timed_solve(solve, method)  # warm
    _, dt = timed_solve(solve, method, repeats=args.repeats)
    rss = peak_memory_kb(device)
    dev_kb = device_peak_kb(device)
    log.info("%s n=%d k=%d time=%.4fs (min %.4fs) mem=%dKB dev=%dKB",
             variant, n, args.k, dt, dt.min_s, rss, dev_kb)
    emit(variant, n, args.k, float(dt), dt.min_s, rss, dev_kb)


def main(argv=None) -> int:
    from two_pass_lanczos_tpu_torch.experiments.common import (
        VARIANTS,
        emit_row,
        log,
        log_device,
        run_device,
        run_orchestrated,
        setup_logging,
        worker_variant,
    )

    args = build_parser().parse_args(argv)
    setup_logging()
    device = run_device(args)
    log_device(device)
    sizes = range(args.arcs_start, args.arcs_end + 1, args.arcs_step)

    wv = worker_variant()
    if wv is not None:  # worker: one variant over the sizes, rows on stdout
        for arcs in sizes:
            n, solve = _build_solve(args, arcs, device)
            _measure(args, wv, solve, n, emit_row, device)
        return 0

    with open(args.output, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(HEADER)

        def emit(*fields):
            writer.writerow(fields)
            fh.flush()  # incremental flush per record

        if args.isolate:
            for arcs in sizes:  # one worker per (variant, size)
                rows = run_orchestrated(
                    [MODULE, "--arcs-start", str(arcs), "--arcs-end",
                     str(arcs), "--arcs-step", str(args.arcs_step),
                     "--k", str(args.k), "--rho", str(args.rho),
                     "--backend", args.backend, "--output", "/dev/null",
                     "--repeats", str(args.repeats),
                     "--max-retries", str(args.max_retries),
                     "--torch-device", args.torch_device,
                     *(["--cpu-f64"] if args.cpu_f64 else [])],
                    lambda f: (f[0], int(f[1]), int(f[2]), float(f[3]),
                               float(f[4]), int(f[5]), int(f[6])),
                )
                for r in rows:
                    emit(*r)
        else:
            if device.type == "cpu":
                log.warning(
                    "running WITHOUT --isolate on the CPU: rss_kb is the "
                    "PROCESS-CUMULATIVE VmPeak; use --isolate")
            for arcs in sizes:
                n, solve = _build_solve(args, arcs, device)
                for variant in VARIANTS:
                    _measure(args, variant, solve, n, emit, device)
    log.info("wrote %s", args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
