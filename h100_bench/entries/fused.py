"""``FusedKKTSolver.solve``: the fused tier, two-pass (K2, f(T_k)·e₁, K3)
or one-pass (K4, f(T_k)·e₁, the basis product), as ``method`` says."""

from __future__ import annotations

import numpy as np

from h100_bench.entries import Output


def build(instance, traffic, device):
    from two_pass_lanczos_tpu_torch import FusedKKTSolver
    return FusedKKTSolver(np.asarray(instance.quad_costs, np.float32),
                          instance.arc_u, instance.arc_v, instance.num_nodes,
                          device=device)


def solve(system, b, traffic) -> Output:
    x, dec = system.solve(b, k=traffic["k"], f=traffic["f"],
                          method=traffic["method"], raw=True)
    return Output(x=x, alphas=dec.alphas, betas=dec.betas,
                  steps=dec.steps_taken, b_norm=dec.b_norm)


def traced(system):
    """The fused passes are read from their kernels' names: no span."""
    return system


def counters() -> dict:
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import LAUNCHES
    return dict(LAUNCHES)
