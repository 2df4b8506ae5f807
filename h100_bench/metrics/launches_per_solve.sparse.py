"""``launches_per_solve`` in a cell whose end-to-end metrics are ``setup_s`` and
``peak_mem_mb`` alone (its ``solve_ms`` is read per layer, as
``generic_solve_ms``): the same count, under a name of its own, since a
per-layer metric moves one end-to-end metric in every cell it lists."""

from __future__ import annotations

from h100_bench.metrics.launches_per_solve import read  # noqa: F401
