"""Basis-stability study (reference ``src/bin/orthogonality.rs``).

Counterpart of ``two_pass_lanczos_tpu/experiments/orthogonality.py``, with
its flags and CSV. ``lanczos_standard`` gives the stored basis V_k and the
basis-returning second pass the regenerated V′_k (a dummy y_k of ones,
reference ``orthogonality.rs:190-197``). Schema, as
``results/orthogonality_*.csv``:
``k,ortho_loss_standard,ortho_loss_regenerated,basis_drift_fro,solution_deviation_l2``.
``basis_drift_fro`` is exactly 0 at every k: pass two replays pass one
bit for bit. Precision and device as in ``stability``: f64 on the card by
default, ``--cpu-f64`` the CPU, ``--device`` f32.
"""

from __future__ import annotations

import argparse

import numpy as np

HEADER = ["k", "ortho_loss_standard", "ortho_loss_regenerated",
          "basis_drift_fro", "solution_deviation_l2"]


def build_parser():
    from two_pass_lanczos_tpu_torch.experiments.stability import (
        add_precision_args,
    )

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--function", choices=["exp", "inv"], required=True)
    p.add_argument("--scenario",
                   choices=["well-conditioned", "ill-conditioned"],
                   required=True)
    p.add_argument("--size", type=int, default=10_000)
    p.add_argument("--k-min", type=int, default=20)
    p.add_argument("--k-max", type=int, default=1000)
    p.add_argument("--k-step", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", required=True)
    add_precision_args(p)
    return p


def main(argv=None) -> int:
    import torch

    import two_pass_lanczos_tpu_torch as tpl
    from two_pass_lanczos_tpu_torch.algorithms.core import basis_product
    from two_pass_lanczos_tpu_torch.algorithms.two_pass import (
        lanczos_pass_two_with_basis,
    )
    from two_pass_lanczos_tpu_torch.experiments.common import (
        log,
        log_device,
        run_device,
        setup_logging,
        write_csv,
    )
    from two_pass_lanczos_tpu_torch.experiments.stability import run_dtype
    from two_pass_lanczos_tpu_torch.models.synthetic import (
        create_diagonal_problem,
    )

    args = build_parser().parse_args(argv)
    setup_logging()
    device = run_device(args)
    log_device(device)
    dtype = run_dtype(args)

    op, _ = create_diagonal_problem(args.size, args.scenario, args.function,
                                    dtype=dtype, device=device)
    rng = np.random.default_rng(args.seed)
    b = torch.as_tensor(rng.standard_normal(args.size), dtype=dtype,
                        device=device)

    rows = []
    for k in range(args.k_min, args.k_max + 1, args.k_step):
        decomp, v_std = tpl.lanczos_standard(op, b, k)
        s = decomp.steps()
        y_dummy = torch.ones(k, dtype=dtype, device=device)
        # x = V_kᵀ·y as GEMVs: full precision whatever the TF32 setting
        x_std = basis_product(y_dummy, v_std)
        x_regen, v_regen = lanczos_pass_two_with_basis(op, b, decomp, y_dummy)

        vs = v_std[:s].cpu().numpy().astype(np.float64)
        vr = v_regen[:s].cpu().numpy().astype(np.float64)
        eye = np.eye(s)
        ortho_std = np.linalg.norm(eye - vs @ vs.T)
        ortho_regen = np.linalg.norm(eye - vr @ vr.T)
        drift = np.linalg.norm(vs - vr)
        sol_dev = np.linalg.norm(x_std.cpu().numpy().astype(np.float64)
                                 - x_regen.cpu().numpy().astype(np.float64))
        log.info("k=%d ortho=%.3e drift=%.3e", k, ortho_std, drift)
        rows.append((k, ortho_std, ortho_regen, drift, sol_dev))

    write_csv(args.output, HEADER, rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
