"""Dense compute-bound trade-off (reference ``src/bin/dense_tradeoff.rs``).

Counterpart of ``two_pass_lanczos_tpu/experiments/dense_tradeoff.py``, with
its flags and CSV. A = B + Bᵀ with random B (seed 42); in this
O(n²)-matvec regime two-pass costs ≈ 2× one-pass time, the validation of
the compute/memory trade-off (reference ``tex/report.tex:419``). The matvec
is one ``torch.mv`` (a GEMV, which cuBLAS never runs in TF32); f32 on the
card, f64 under ``--cpu-f64``. Schema: the reference's
``variant,k,time_s,rss_kb`` plus ``time_min_s`` and ``device_peak_kb``
(the one-pass basis adds k·n values to the device peak).
"""

from __future__ import annotations

import argparse
import sys

MODULE = "two_pass_lanczos_tpu_torch.experiments.dense_tradeoff"
HEADER = ["variant", "k", "time_s", "time_min_s", "rss_kb", "device_peak_kb"]


def build_parser():
    from two_pass_lanczos_tpu_torch.experiments.common import add_torch_device

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", type=int, default=10_000,
                   help="matrix dimension n")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--k-start", type=int, default=100)
    p.add_argument("--k-end", type=int, default=1000)
    p.add_argument("--k-step", type=int, default=100)
    p.add_argument("--output", required=True)
    p.add_argument("--repeats", type=int, default=1,
                   help="timed repetitions per cell; median + min recorded")
    p.add_argument("--isolate", action="store_true")
    p.add_argument("--cpu-f64", action="store_true")
    add_torch_device(p)
    return p


def _run_variant(args, variant, emit, device, only_k=None):
    import numpy as np
    import torch

    import two_pass_lanczos_tpu_torch as tpl
    from two_pass_lanczos_tpu_torch.experiments.common import (
        device_peak_kb,
        log,
        peak_memory_kb,
        reset_peak_memory,
        timed_solve,
    )
    from two_pass_lanczos_tpu_torch.models.synthetic import (
        dense_random_symmetric,
    )

    dtype = torch.float64 if args.cpu_f64 else torch.float32
    op = dense_random_symmetric(args.size, seed=args.seed, dtype=dtype,
                                device=device)
    rng = np.random.default_rng(args.seed)
    b = torch.as_tensor(rng.standard_normal(args.size), dtype=dtype,
                        device=device)
    method = "one_pass" if variant == "standard" else "two_pass"
    ks = (range(args.k_start, args.k_end + 1, args.k_step)
          if only_k is None else [only_k])
    for k in ks:
        reset_peak_memory(device)
        timed_solve(tpl.solve_fAb, op, b, k=k, f="inv", method=method)
        _, dt = timed_solve(tpl.solve_fAb, op, b, k=k, f="inv",
                            method=method, repeats=args.repeats)
        rss = peak_memory_kb(device)
        dev_kb = device_peak_kb(device)
        log.info("%s k=%d time=%.4fs (min %.4fs) mem=%dKB dev=%dKB",
                 variant, k, dt, dt.min_s, rss, dev_kb)
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
    if wv is not None:
        _run_variant(args, wv, emit_row, device, only_k=worker_k())
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
                "PROCESS-CUMULATIVE VmPeak; use --isolate")
        for variant in VARIANTS:
            _run_variant(args, variant, lambda *f: rows.append(f), device)
    write_csv(args.output, HEADER, rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
