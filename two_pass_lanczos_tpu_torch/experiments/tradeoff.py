"""Memory/time vs k trade-off on a fixed KKT instance
(reference ``src/bin/tradeoff.rs``).

Counterpart of ``two_pass_lanczos_tpu/experiments/tradeoff.py``, with its
flags and CSV. Known-solution setup: ``x_true = 1/√n``, ``b = A·x_true``;
f = inv; sweep k; the ``standard`` variant is one-pass (it stores the (k, n)
basis), ``two-pass`` regenerates it. Schema: the reference's
``variant,k,time_s,rss_kb`` plus ``time_min_s`` (``time_s`` is the median
of ``--repeats`` samples) and ``device_peak_kb``.

``--backend``: ``fused`` is ``FusedKKTSolver`` (its passes are the kernels
K2 and K3, and K4 for one-pass); ``pallas`` the generic tier on
``make_kkt_operator(..., backend="cuda")``, whose matvec is K8; ``xla`` the
generic tier on ``backend="auto"`` (K8 on the card, the plain matvec on the
CPU); ``auto`` is ``fused`` on the card and ``xla`` on the CPU.

Memory: on the card each row's device peak is reset before it, so the
in-process sweep already gives one configuration per row (the one-pass
peak grows by 4·n bytes per step of k, the two-pass peak stays flat). On
the CPU ``rss_kb`` is the process-cumulative VmPeak unless ``--isolate``
spawns one worker per (variant, k), the reference's per-variant re-exec
(``tradeoff.rs:4-7,142-213``) at per-row granularity.
"""

from __future__ import annotations

import argparse
import sys

MODULE = "two_pass_lanczos_tpu_torch.experiments.tradeoff"
HEADER = ["variant", "k", "time_s", "time_min_s", "rss_kb", "device_peak_kb"]


def build_parser():
    from two_pass_lanczos_tpu_torch.experiments.common import add_torch_device

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dmx", help="path to the .dmx file")
    p.add_argument("--qfc", help="path to the .qfc file")
    p.add_argument("--arcs", type=int,
                   help="generate an instance instead of loading")
    p.add_argument("--rho", type=int, default=3)
    p.add_argument("--instance-id", type=int, default=1)
    p.add_argument("--k-start", type=int, default=50)
    p.add_argument("--k-end", type=int, default=1000)
    p.add_argument("--k-step", type=int, default=50)
    p.add_argument("--output", required=True)
    p.add_argument("--repeats", type=int, default=1,
                   help="timed repetitions per (variant,k) cell; time_s is "
                        "the median, time_min_s the minimum")
    p.add_argument("--isolate", action="store_true",
                   help="one worker process per (variant,k): rss_kb becomes "
                        "the reference's single-configuration VmPeak")
    p.add_argument("--backend", choices=["auto", "xla", "pallas", "fused"],
                   default="auto")
    p.add_argument("--cpu-f64", action="store_true",
                   help="run on the CPU in f64 (the generic tier; the fused "
                        "solver is f32)")
    add_torch_device(p)
    return p


def _load_arrays(args):
    from two_pass_lanczos_tpu_torch.utils.data_loader import (
        KKTArrays,
        load_kkt_arrays,
    )

    if args.dmx and args.qfc:
        return load_kkt_arrays(args.dmx, args.qfc)
    if args.arcs:
        from two_pass_lanczos_tpu_torch.models.generator import (
            generate_mcf_instance,
        )

        inst = generate_mcf_instance(args.arcs, rho=args.rho,
                                     instance_id=args.instance_id)
        return KKTArrays(inst.quad_costs, inst.arc_u, inst.arc_v,
                         inst.num_nodes, inst.num_arcs)
    raise SystemExit("provide --dmx/--qfc or --arcs")


def _build_context(args, device):
    """Load the instance once; return a ``solve(k, method)`` closure."""
    from two_pass_lanczos_tpu_torch.experiments.common import kkt_solve

    arrays = _load_arrays(args)
    return kkt_solve(arrays.quad_costs, arrays.arc_u, arrays.arc_v,
                     arrays.num_nodes, args.backend, device, args.cpu_f64)


def _run_variant(args, variant, emit, device, solve, only_k=None):
    from two_pass_lanczos_tpu_torch.experiments.common import (
        device_peak_kb,
        log,
        peak_memory_kb,
        reset_peak_memory,
        timed_solve,
    )

    method = "one_pass" if variant == "standard" else "two_pass"
    ks = (range(args.k_start, args.k_end + 1, args.k_step)
          if only_k is None else [only_k])
    for k in ks:
        reset_peak_memory(device)
        timed_solve(solve, k, method)  # warm
        _, dt = timed_solve(solve, k, method, repeats=args.repeats)
        rss = peak_memory_kb(device)
        dev_kb = device_peak_kb(device)
        log.info("%s k=%d time=%.4fs (min %.4fs, n=%d) mem=%dKB dev=%dKB",
                 variant, k, dt, dt.min_s, len(dt.samples), rss, dev_kb)
        emit(variant, k, float(dt), dt.min_s, rss, dev_kb)


def main(argv=None) -> int:
    from two_pass_lanczos_tpu_torch.experiments.common import (
        VARIANTS,
        emit_row,
        log,
        log_device,
        run_device,
        run_orchestrated,
        setup_logging,
        worker_k,
        worker_variant,
        write_csv,
    )

    args = build_parser().parse_args(argv)
    setup_logging()
    device = run_device(args)
    log_device(device)

    wv = worker_variant()
    if wv is not None:  # worker process: stream headerless rows on stdout
        _run_variant(args, wv, emit_row, device, _build_context(args, device),
                     only_k=worker_k())
        return 0

    rows = []
    if args.isolate:
        rows = run_orchestrated(
            [MODULE, *(sys.argv[1:] if argv is None else argv)],
            lambda f: (f[0], int(f[1]), float(f[2]), float(f[3]),
                       int(f[4]), int(f[5])),
            k_values=list(range(args.k_start, args.k_end + 1, args.k_step)),
        )
    else:
        if device.type == "cpu":
            log.warning(
                "running WITHOUT --isolate on the CPU: rss_kb is the "
                "PROCESS-CUMULATIVE VmPeak (later rows inherit earlier "
                "peaks); use --isolate for per-(variant,k) fidelity")
        solve = _build_context(args, device)  # one instance/solver build
        for variant in VARIANTS:
            _run_variant(args, variant, lambda *f: rows.append(f), device,
                         solve)
    write_csv(args.output, HEADER, rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
