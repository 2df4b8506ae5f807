"""Device ms a solve spends in K7, the shard matvec of the arc-sharded
solve, read by name from rank 0's trace."""

from __future__ import annotations

from h100_bench.metrics._pass_kernels import kernel_ms
from h100_bench.metrics._shard_kernels import SHARD_MATVEC


def read(ctx):
    return kernel_ms(ctx, SHARD_MATVEC)
