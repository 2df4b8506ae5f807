"""Device ms a solve spends in pass one's kernel (K2; K4 in a one-pass
solve), read by name from the trace."""

from __future__ import annotations

from h100_bench.metrics._pass_kernels import PASS_ONE, kernel_ms


def read(ctx):
    return kernel_ms(ctx, PASS_ONE)
