"""Device operations (kernels, copies, sets) per solve: the entry layer's
launch count, ``FusedKKTSolver.solve`` or ``solve_fAb``."""

from __future__ import annotations


def read(ctx):
    if not ctx.solves:
        return None
    return sum(len(s) for s in ctx.solves) / len(ctx.solves)
