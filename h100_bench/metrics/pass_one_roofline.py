"""Pass one's kernel (K2; K4, which also writes the basis, in a one-pass
solve) against its roofline: ``counts.pass_one`` at the steps taken."""

from __future__ import annotations

from h100_bench import counts
from h100_bench.metrics._pass_kernels import PASS_ONE, roofline_pct


def read(ctx):
    basis = ctx.traffic.get("method") == "one_pass"
    return roofline_pct(
        ctx, PASS_ONE, lambda s: counts.pass_one(ctx.m, ctx.p, s, basis))
