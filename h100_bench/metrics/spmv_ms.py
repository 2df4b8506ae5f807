"""Device ms a solve spends in the generic tier's product
(``ops/spmv.coo_spmv``: the gather x[cols], the multiply and
``torch.segment_reduce``): the device events launched inside the
harness's ``bench.spmv`` spans."""

from __future__ import annotations

from h100_bench.metrics._pass_kernels import kernel_ms

SPMV = "bench.spmv"


def read(ctx):
    return kernel_ms(ctx, lambda ev: SPMV in ev.spans)
