"""Host-clock ms of a call, from the call to the device's synchronise, over
the calls of a traced run before its traced stretch (after it, the
profiler's leavings slow the host): ``solve_ms`` read as a per-layer
metric, for a cell whose solve the host paces and whose runs spread too
widely for ``solve_ms`` to hold an end-to-end bound."""

from __future__ import annotations


def read(ctx):
    if not ctx.call_ms:
        return None
    return sum(ctx.call_ms) / len(ctx.call_ms)
