"""Measure K7, the streaming KKT matvec, against its HBM speed-of-light
bound.

Counterpart of ``scripts/sol_bench.py``, with its flags and record keys
(``utils/sol_bench.py`` says how the time is taken). Per instance size one
JSON record:

* ``seconds_per_matvec``, ``gnnz_per_s`` (5·m stored entries a matvec),
  ``effective_gb_per_s`` (the layout's bytes over the time);
* ``ideal_bytes_per_matvec``: the bytes of the function, 20·m + 8·p;
  ``layout_bytes_per_matvec``: the bytes K7 reads
  (``observability.kkt_matvec_bytes``: its node-sorted incidence CSR too);
  ``pad_ratio`` their ratio;
* ``sol_fraction_ideal`` and ``sol_fraction_layout``: each byte count over
  the H100 SXM's 3.35 TB/s, over the time; null unless the run was on a
  card;
* ``windowed``: always false (the TPU's windowed gather is not ported, and
  ``--windowed`` is not accepted); ``timing``: lo, hi and their times;
* ``device`` and ``card``: where it ran, the card's name and power limit.

Usage::

    python -m two_pass_lanczos_tpu_torch.tools.sol_bench --arcs 500000 5000000
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser():
    from two_pass_lanczos_tpu_torch.experiments.common import add_torch_device

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arcs", type=int, nargs="+",
                    default=[500_000, 5_000_000])
    ap.add_argument("--rho", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--lo", type=int, default=64)
    ap.add_argument("--hi", type=int, default=None)
    add_torch_device(ap)
    return ap


def record(arcs: int, rho: int, reps: int, lo: int, hi, device) -> dict:
    """The JSON record of one instance size."""
    from two_pass_lanczos_tpu_torch.utils.perf import card_description
    from two_pass_lanczos_tpu_torch.utils.sol_bench import (
        measure_streaming_matvec,
    )

    per, sol_layout, sol_ideal, meta = measure_streaming_matvec(
        arcs, rho=rho, reps=reps, lo=lo, hi=hi, device=device)
    on_card = device.type == "cuda"
    return {
        "metric": f"streaming_kkt_matvec_arcs{arcs}_rho{rho}",
        "seconds_per_matvec": per,
        "gnnz_per_s": sol_layout.achieved_nnz_per_s / 1e9,
        "layout_bytes_per_matvec": sol_layout.bytes_per_matvec,
        "ideal_bytes_per_matvec": sol_ideal.bytes_per_matvec,
        "sol_fraction_layout": sol_layout.sol_fraction if on_card else None,
        "sol_fraction_ideal": sol_ideal.sol_fraction if on_card else None,
        "effective_gb_per_s": sol_layout.bytes_per_matvec / per / 1e9,
        "pad_ratio": meta["pad_ratio"],
        "windowed": False,
        "timing": {k: v for k, v in meta.items() if k != "pad_ratio"},
        "device": device.type,
        "card": card_description(device),
    }


def main(argv=None) -> int:
    from two_pass_lanczos_tpu_torch.experiments.common import (
        log_device,
        run_device,
        setup_logging,
    )

    args = build_parser().parse_args(argv)
    setup_logging()
    device = run_device(args)
    log_device(device)
    results = []
    for arcs in args.arcs:
        rec = record(arcs, args.rho, args.reps, args.lo, args.hi, device)
        results.append(rec)
        print(json.dumps(rec), flush=True)
    fractions = [r["sol_fraction_ideal"] for r in results
                 if r["sol_fraction_ideal"] is not None]
    print(json.dumps({
        "summary": "K7 against the H100 SXM's HBM bound of the function's "
                   "bytes",
        "best_sol_fraction_ideal": max(fractions) if fractions else None,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
