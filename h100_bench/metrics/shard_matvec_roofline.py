"""K7 against its roofline: ``counts.kkt_matvec`` of rank 0's shard (m_d =
⌈m / ranks⌉ arcs, ``np.array_split``'s first share, over all p nodes) for
each K7 launch in rank 0's trace, over K7's device time."""

from __future__ import annotations

from h100_bench import counts, trace
from h100_bench.metrics._shard_kernels import SHARD_MATVEC


def read(ctx):
    times = trace.per_solve_us(ctx.solves, SHARD_MATVEC)
    if times is None or ctx.peak is None:
        return None
    m_d = -(-ctx.m // ctx.world)
    products = sum(1 for s in ctx.solves for ev in s if SHARD_MATVEC(ev))
    least = products * counts.least_seconds(*counts.kkt_matvec(m_d, ctx.p),
                                            ctx.peak)
    return 100.0 * least / (sum(times) / 1e6)
