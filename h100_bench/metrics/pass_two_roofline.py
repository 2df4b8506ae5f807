"""Pass two's kernel (K3) against its roofline: ``counts.pass_two`` at
the steps taken."""

from __future__ import annotations

from h100_bench import counts
from h100_bench.metrics._pass_kernels import PASS_TWO, roofline_pct


def read(ctx):
    return roofline_pct(ctx, PASS_TWO,
                        lambda s: counts.pass_two(ctx.m, ctx.p, s))
