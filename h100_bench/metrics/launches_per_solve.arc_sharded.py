"""``launches_per_solve`` in the arc-sharded cell: rank 0's device
operations a solve, the nodes of its two CUDA graphs among them."""

from __future__ import annotations

from h100_bench.metrics.launches_per_solve import read  # noqa: F401
