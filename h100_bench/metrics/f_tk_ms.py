"""Device ms a solve spends between its passes: f(T_k)·e₁
(``functions.padded_f_e1`` through ``scaled_y``). In a fused solve, the
operations after pass one's kernel and before pass two's kernel or the
basis product; in a generic solve, those after pass one's last product
(``bench.spmv`` span) and before pass two's first, which also holds the
last step's vector operations."""

from __future__ import annotations

from h100_bench.metrics._pass_kernels import GEMV, PASS_ONE, PASS_TWO

SPMV = "bench.spmv"


def _fused(events):
    ends = [i for i, ev in enumerate(events) if PASS_ONE(ev)]
    starts = [i for i, ev in enumerate(events) if PASS_TWO(ev) or GEMV(ev)]
    if not ends or not starts or starts[0] <= ends[0]:
        return None
    return sum(ev.dur for ev in events[ends[0] + 1:starts[0]])


def _generic(events):
    # the products as runs of consecutive events in bench.spmv spans:
    # pass one's steps, then pass two's steps - 1
    runs = []
    for i, ev in enumerate(events):
        if SPMV in ev.spans:
            if runs and runs[-1][1] == i - 1:
                runs[-1][1] = i
            else:
                runs.append([i, i])
    if len(runs) < 3 or len(runs) % 2 == 0:
        return None
    mid = (len(runs) - 1) // 2
    return sum(ev.dur for ev in events[runs[mid][1] + 1:runs[mid + 1][0]])


def read(ctx):
    times = []
    for events in ctx.solves:
        t = _fused(events)
        if t is None:
            t = _generic(events)
        if t is None:
            return None
        times.append(t)
    if not times:
        return None
    return sum(times) / len(times) / 1e3
