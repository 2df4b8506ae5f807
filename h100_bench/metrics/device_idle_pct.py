"""The device's idle share over the traced stretch: 1 − the union of the
device intervals over the stretch's wall time, in %."""

from __future__ import annotations


def read(ctx):
    if ctx.stretch.window_us <= 0:
        return None
    return 100.0 * (1.0 - ctx.stretch.busy_us / ctx.stretch.window_us)
