"""Device ms a solve spends in pass two's kernel (K3), read by name."""

from __future__ import annotations

from h100_bench.metrics._pass_kernels import PASS_TWO, kernel_ms


def read(ctx):
    return kernel_ms(ctx, PASS_TWO)
