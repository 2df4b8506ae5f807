"""``device_idle_pct`` in the arc-sharded cell: rank 0's card's idle share
over the traced solves' spans."""

from __future__ import annotations

from h100_bench.metrics.device_idle_pct import read  # noqa: F401
