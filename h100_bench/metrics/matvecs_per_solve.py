"""KKT products per solve run as phases inside the fused passes: the
program's counter ``LAUNCHES["kkt_matvec_in_pass"]`` over the traced
solves."""

from __future__ import annotations


def read(ctx):
    count = ctx.counters.get("kkt_matvec_in_pass", 0)
    if not count or not ctx.solves:
        return None
    return count / len(ctx.solves)
