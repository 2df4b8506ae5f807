"""The generic tier's product against its roofline: ``counts.coo_spmv``
over the assembled KKT matrix (5·m nonzeros), once per ``bench.spmv``
span, over the device time of the events launched inside the spans."""

from __future__ import annotations

from h100_bench import counts, trace

SPMV = "bench.spmv"


def read(ctx):
    spans = ctx.stretch.spans.get(SPMV, [])
    pick = lambda ev: SPMV in ev.spans  # noqa: E731
    times = trace.per_solve_us(ctx.solves, pick)
    if not spans or times is None or ctx.peak is None:
        return None
    least = len(spans) * counts.least_seconds(
        *counts.coo_spmv(ctx.n, counts.kkt_nnz(ctx.m)), ctx.peak)
    return 100.0 * least / (sum(times) / 1e6)
