"""Error-certificate study: the Gauss–Radau bracket vs the true error.

Counterpart of ``two_pass_lanczos_tpu/experiments/certificate_study.py``,
with its flags and CSV. Per step j of ONE f = inv run on the SPD
controlled spectrum (the ``inv / well-conditioned`` stability scenario,
λ ∈ [0.1, 100]): the rigorous Golub–Meurant bracket from the coefficients
alone

    ‖b‖·√(G_s − G_j)  ≤  ‖x − x_j‖_A  ≤  ‖b‖·√(U_j − G_j)

(:func:`spectrum.a_norm_error_history`) next to the TRUE A-norm error (from
the analytic diagonal ground truth) and the lagged-update estimate
(:func:`convergence.update_norm`) scaled by ‖x_j‖. The run is f64, on the
card by default (the JAX CLI always runs on the CPU) or on
``--torch-device cpu``; the bracket and the iterates are formed on the
host in f64.

CSV schema::

    j,lower_bound,upper_bound,true_error_a_norm,lagged_update_estimate
"""

from __future__ import annotations

import argparse

import numpy as np

HEADER = ["j", "lower_bound", "upper_bound", "true_error_a_norm",
          "lagged_update_estimate"]


def build_parser():
    from two_pass_lanczos_tpu_torch.experiments.common import add_torch_device

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", type=int, default=2000)
    p.add_argument("--k", type=int, default=200)
    p.add_argument("--stride", type=int, default=2)
    p.add_argument("--lag", type=int, default=4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", required=True)
    add_torch_device(p)
    return p


def main(argv=None) -> int:
    import torch

    from two_pass_lanczos_tpu_torch.algorithms.core import pass_one_scan
    from two_pass_lanczos_tpu_torch.convergence import update_norm
    from two_pass_lanczos_tpu_torch.experiments.common import (
        log,
        log_device,
        run_device,
        setup_logging,
        write_csv,
    )
    from two_pass_lanczos_tpu_torch.functions import host_f_tk_solve
    from two_pass_lanczos_tpu_torch.models.synthetic import (
        create_diagonal_problem,
    )
    from two_pass_lanczos_tpu_torch.spectrum import a_norm_error_history

    args = build_parser().parse_args(argv)
    setup_logging()
    device = run_device(args)
    log_device(device)

    op, eigs = create_diagonal_problem(args.size, "well-conditioned", "inv",
                                       dtype=torch.float64, device=device)
    lambda_min = float(np.min(eigs))
    rng = np.random.default_rng(args.seed)
    b_np = rng.standard_normal(args.size)
    b = torch.as_tensor(b_np, dtype=torch.float64, device=device)
    x_true = b_np / eigs

    decomp, basis = pass_one_scan(op.matvec, b, args.k, emit_basis=True)
    v = basis.cpu().numpy()
    alphas = decomp.alphas_valid()
    betas = decomp.betas_valid()
    b_norm = float(decomp.b_norm)
    s = decomp.steps()

    js, lows, ups = a_norm_error_history(
        decomp, lambda_min=lambda_min, stride=args.stride)

    rows = []
    for j, lo, up in zip(js, lows, ups):
        j = int(j)
        # the step-j iterate from the shared basis: x_j = ‖b‖·V_jᵀ·y_j
        y_j = host_f_tk_solve(alphas[:j], betas[: j - 1], "inv") * b_norm
        x_j = v[:j].T @ y_j
        err = x_true - x_j
        true_a = float(np.sqrt(np.sum(eigs * err * err)))
        est = update_norm(alphas[:j], betas[: j - 1], "inv", lag=args.lag)
        est_abs = (est * float(np.linalg.norm(x_j))
                   if np.isfinite(est) else float("inf"))
        rows.append((j, float(lo), float(up), true_a, est_abs))
        log.info("j=%3d  lower=%.3e  true=%.3e  upper=%.3e  lagged=%.3e",
                 j, lo, true_a, up, est_abs)

    # the history covers every step of the stride grid up to s-1
    if list(js) != list(range(1, s, args.stride)):
        raise RuntimeError(f"bracket history {list(js)} misses steps of "
                           f"1..{s - 1} by {args.stride}")
    write_csv(args.output, HEADER, rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
