"""Device ms a solve spends in NCCL's kernels on rank 0: the all-gathers of
the node and dot folds, and the one of x's gather."""

from __future__ import annotations

from h100_bench.metrics._pass_kernels import kernel_ms
from h100_bench.metrics._shard_kernels import NCCL


def read(ctx):
    return kernel_ms(ctx, NCCL)
