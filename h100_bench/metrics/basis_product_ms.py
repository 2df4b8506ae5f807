"""Device ms a solve spends in the basis product x = V_k·y
(``algorithms/core.basis_product``: cuBLAS GEMV), read by name."""

from __future__ import annotations

from h100_bench.metrics._pass_kernels import GEMV, kernel_ms


def read(ctx):
    return kernel_ms(ctx, GEMV)
