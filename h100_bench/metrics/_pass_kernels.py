"""Kernel names of the fused passes (``csrc/lanczos_pass_one.cu``: K2 and
its instances K4, K5, K6; ``csrc/lanczos_pass_two.cu``: K3) and the
basis product's cuBLAS GEMV, shared by the metrics that read them."""

from __future__ import annotations

from h100_bench import trace

PASS_ONE = trace.name_has("pass_one_persistent_kernel")
PASS_TWO = trace.name_has("pass_two_persistent_kernel")
GEMV = trace.name_has("gemv")


def kernel_ms(ctx, pick):
    """Mean device ms a solve spends in the events ``pick`` takes."""
    times = trace.per_solve_us(ctx.solves, pick)
    if times is None:
        return None
    return sum(times) / len(times) / 1e3


def roofline_pct(ctx, pick, count):
    """The kernel's share of its roofline: the least time the chip could
    take over the traced solves (``count(steps)`` gives the operations and
    bytes of one solve), over the kernel's device time, in %."""
    from h100_bench import counts
    times = trace.per_solve_us(ctx.solves, pick)
    if times is None or ctx.peak is None or len(ctx.steps) != len(times):
        return None
    least = sum(counts.least_seconds(*count(s), ctx.peak) for s in ctx.steps)
    return 100.0 * least / (sum(times) / 1e6)
