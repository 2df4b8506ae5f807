"""Accuracy vs analytic ground truth (reference ``src/bin/stability.rs``).

Counterpart of ``two_pass_lanczos_tpu/experiments/stability.py``, with its
flags and CSV. A synthetic diagonal A with a controlled spectrum per
(function, scenario); b is seeded random; the ground truth is
``x_true_i = f(λ_i)·b_i``; both variants run per k. Schema, as
``results/accuracy_*.csv``:
``k,relative_error_standard,relative_error_two_pass,relative_solution_deviation``.

Precision and device: f64 on the card by default (the JAX CLI's default is
the CPU in f64); ``--cpu-f64`` the CPU in f64; ``--device`` f32, the JAX
CLI's accelerator dtype, on ``--torch-device``; ``--precision df`` both
variants in double-float (``DFDiagonalOperator``, ``solve_fAb_df``).

Example (the published ``accuracy_exp_well-conditioned.csv`` grid)::

    python -m two_pass_lanczos_tpu_torch.experiments.stability \
        --function exp --scenario well-conditioned --size 10000 \
        --k-min 10 --k-max 200 --k-step 10 --output accuracy.csv
"""

from __future__ import annotations

import argparse

import numpy as np

HEADER = ["k", "relative_error_standard", "relative_error_two_pass",
          "relative_solution_deviation"]


def add_precision_args(p: argparse.ArgumentParser) -> None:
    """``--cpu-f64`` / ``--device`` with the JAX CLI's dest: the last one
    given wins; neither means f64 on ``--torch-device``."""
    from two_pass_lanczos_tpu_torch.experiments.common import add_torch_device

    p.add_argument("--cpu-f64", dest="cpu_f64", action="store_const",
                   const=True, default=None,
                   help="run on the CPU in f64 (the JAX CLI's default)")
    p.add_argument("--device", dest="cpu_f64", action="store_const",
                   const=False,
                   help="run in f32 (the JAX CLI's accelerator dtype) on "
                        "--torch-device")
    add_torch_device(p)


def run_dtype(args):
    """f32 under ``--device``, else f64."""
    import torch

    return torch.float32 if args.cpu_f64 is False else torch.float64


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--function", choices=["exp", "inv"], required=True)
    p.add_argument("--scenario",
                   choices=["well-conditioned", "ill-conditioned"],
                   required=True)
    p.add_argument("--size", type=int, default=10_000,
                   help="problem dimension n")
    p.add_argument("--k-min", type=int, default=10)
    p.add_argument("--k-max", type=int, default=200)
    p.add_argument("--k-step", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", required=True)
    add_precision_args(p)
    p.add_argument("--precision", choices=["native", "df"], default="native",
                   help="'df' runs both variants through the double-float "
                        "path (algorithms/df.py) on --torch-device")
    return p


def main(argv=None) -> int:
    import torch

    import two_pass_lanczos_tpu_torch as tpl
    from two_pass_lanczos_tpu_torch.experiments.common import (
        log,
        log_device,
        run_device,
        setup_logging,
        write_csv,
    )
    from two_pass_lanczos_tpu_torch.models.synthetic import (
        create_diagonal_problem,
    )

    args = build_parser().parse_args(argv)
    setup_logging()
    if args.precision == "df" and args.cpu_f64:
        args.cpu_f64 = None  # df runs on --torch-device, as JAX's on-chip
    device = run_device(args)
    log_device(device)
    dtype = run_dtype(args)

    op, eigs = create_diagonal_problem(args.size, args.scenario,
                                       args.function, dtype=dtype,
                                       device=device)
    rng = np.random.default_rng(args.seed)
    b = rng.standard_normal(args.size)
    f_scalar = np.exp if args.function == "exp" else (lambda lam: 1.0 / lam)
    x_true = f_scalar(eigs) * b
    x_true_norm = np.linalg.norm(x_true)

    if args.precision == "df":
        from two_pass_lanczos_tpu_torch.algorithms.df import (
            DFDiagonalOperator,
            solve_fAb_df,
        )

        op_df = DFDiagonalOperator.from_f64(eigs, device=device)

        def run(k, method):
            x = solve_fAb_df(op_df, b, k=k, f=args.function, method=method)
            return x.cpu().numpy()
    else:
        solver = (tpl.make_exp_solver() if args.function == "exp"
                  else tpl.make_inv_solver())
        b_dev = torch.as_tensor(b, dtype=dtype, device=device)

        def run(k, method):
            fn = tpl.lanczos if method == "one_pass" else tpl.lanczos_two_pass
            return fn(op, b_dev, k, solver).cpu().numpy().astype(np.float64)

    rows = []
    for k in range(args.k_min, args.k_max + 1, args.k_step):
        x_std = run(k, "one_pass")
        x_2p = run(k, "two_pass")
        err_std = np.linalg.norm(x_std - x_true) / x_true_norm
        err_2p = np.linalg.norm(x_2p - x_true) / x_true_norm
        dev = (np.linalg.norm(x_std - x_2p)
               / max(np.linalg.norm(x_std), 1e-300))
        log.info("k=%d err_std=%.3e err_2p=%.3e dev=%.3e", k, err_std, err_2p,
                 dev)
        rows.append((k, err_std, err_2p, dev))

    write_csv(args.output, HEADER, rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
