"""Collectives a solve runs on rank 0: the program's counter
``collectives`` (``parallel/comm.COLLECTIVES``) over the traced solves."""

from __future__ import annotations


def read(ctx):
    count = ctx.counters.get("collectives", 0)
    if not count or not ctx.solves:
        return None
    return count / len(ctx.solves)
