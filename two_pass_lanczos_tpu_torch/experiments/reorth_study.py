"""Forward-instability study: plain vs reorthogonalised one-pass.

Counterpart of ``two_pass_lanczos_tpu/experiments/reorth_study.py``, with
its flags and CSV. Per k, the one-pass pass one runs three times from the
same seeded b: the plain recurrence, the CGS2-reorthogonalised one and the
selective (ω-recurrence) one of ``algorithms/reorth.py``, in the dtype
where the instability lives (f32 by default; ``--dtype f64`` is the
control where the variants coincide). x = V_kᵀ·y is formed by GEMVs
(``core.basis_product``), never in TF32. The run is on the card by
default (the JAX CLI's default is the CPU; its ``--device`` names the
card here, where it is the default) or on ``--torch-device cpu``.

CSV schema::

    k,relative_error_plain,relative_error_reorth,relative_error_selective,
    ortho_defect_plain,ortho_defect_reorth,ortho_defect_selective,
    reorth_steps_selective

``relative_error_*`` is against the analytic diagonal ground truth (f64
host arithmetic), ``ortho_defect_*`` is ``max|V·Vᵀ − I|`` over the
executed steps, and ``reorth_steps_selective`` counts the steps on which
the selective variant swept.
"""

from __future__ import annotations

import argparse

import numpy as np

HEADER = ["k", "relative_error_plain", "relative_error_reorth",
          "relative_error_selective", "ortho_defect_plain",
          "ortho_defect_reorth", "ortho_defect_selective",
          "reorth_steps_selective"]


def build_parser():
    from two_pass_lanczos_tpu_torch.experiments.common import add_torch_device

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--function", choices=["exp", "inv"], required=True)
    p.add_argument("--scenario",
                   choices=["well-conditioned", "ill-conditioned"],
                   required=True)
    p.add_argument("--size", type=int, default=2000)
    p.add_argument("--k-min", type=int, default=20)
    p.add_argument("--k-max", type=int, default=400)
    p.add_argument("--k-step", type=int, default=20)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--sweeps", type=int, default=2)
    p.add_argument("--dtype", choices=["f32", "f64"], default="f32",
                   help="f32 (default) exhibits the instability; f64 is the "
                        "control where the variants coincide")
    p.add_argument("--device", action="store_true",
                   help="run on the card (the port's default; kept for the "
                        "JAX CLI's argv)")
    p.add_argument("--output", required=True)
    add_torch_device(p)
    return p


def main(argv=None) -> int:
    import torch

    from two_pass_lanczos_tpu_torch.algorithms.core import (
        basis_product,
        pass_one_scan,
    )
    from two_pass_lanczos_tpu_torch.algorithms.reorth import (
        pass_one_scan_reorth,
        pass_one_scan_selective,
    )
    from two_pass_lanczos_tpu_torch.experiments.common import (
        log,
        log_device,
        run_device,
        setup_logging,
        write_csv,
    )
    from two_pass_lanczos_tpu_torch.functions import padded_f_e1
    from two_pass_lanczos_tpu_torch.models.synthetic import (
        create_diagonal_problem,
    )

    args = build_parser().parse_args(argv)
    setup_logging()
    device = run_device(args)
    log_device(device)

    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    op, eigs = create_diagonal_problem(args.size, args.scenario,
                                       args.function, dtype=dtype,
                                       device=device)
    rng = np.random.default_rng(args.seed)
    b_np = rng.standard_normal(args.size)
    b = torch.as_tensor(b_np, dtype=dtype, device=device)

    f_scalar = np.exp if args.function == "exp" else (lambda e: 1.0 / e)
    x_true = f_scalar(eigs) * b_np
    true_norm = np.linalg.norm(x_true)

    def run(k: int, variant: str):
        sweeps_fired = 0
        if variant == "reorth":
            decomp, basis = pass_one_scan_reorth(
                op.matvec, b, k, sweeps=args.sweeps)
        elif variant == "selective":
            decomp, basis, nre = pass_one_scan_selective(
                op.matvec, b, k, sweeps=args.sweeps)
            sweeps_fired = int(nre)
        else:
            decomp, basis = pass_one_scan(op.matvec, b, k, emit_basis=True)
        y = padded_f_e1(decomp, args.function) * decomp.b_norm
        x = basis_product(y.to(basis.dtype), basis)
        s = decomp.steps()
        v = basis[:s].cpu().numpy().astype(np.float64)
        defect = float(np.max(np.abs(v @ v.T - np.eye(s)))) if s else 0.0
        err = float(np.linalg.norm(x.cpu().numpy().astype(np.float64)
                                   - x_true) / true_norm)
        return err, defect, sweeps_fired

    rows = []
    for k in range(args.k_min, args.k_max + 1, args.k_step):
        err_p, def_p, _ = run(k, "plain")
        err_r, def_r, _ = run(k, "reorth")
        err_s, def_s, nre = run(k, "selective")
        log.info("k=%d plain err=%.3e defect=%.3e | reorth err=%.3e "
                 "defect=%.3e | selective err=%.3e defect=%.3e sweeps=%d/%d",
                 k, err_p, def_p, err_r, def_r, err_s, def_s, nre, k)
        rows.append((k, err_p, err_r, err_s, def_p, def_r, def_s, nre))

    write_csv(args.output, HEADER, rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
