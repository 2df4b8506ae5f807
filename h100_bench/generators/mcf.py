"""Frozen copy of the min-cost-flow KKT instance generator.

A copy of ``generate_mcf_instance`` in
``two_pass_lanczos_tpu_torch/models/generator.py``, kept here so that a
change to the program cannot move the benchmark's inputs. It draws from
NumPy's generator in the same order, so the arrays are bitwise the
program's (``tests/test_h100_bench_yardstick.py`` holds it to that at a
small size). Files are never written: the benchmark takes the arrays.

Parameters follow the reference toolchain (pargen, netgen, qfcgen): the
node count ``floor((1 + sqrt(1 + 8m/prho)) / 2)`` with ``prho`` 0.25, 0.5,
0.75 for ``rho`` 1, 2, 3; linear costs in ``[1, maxcost]``; fixed costs
``Cc = b·U[Ccm1, Ccm2] + 1`` and quadratic costs ``Ca = Cc·U[Cam1, Cam2] +
1``. The instance is a deterministic function of ``(arcs, rho,
instance_id)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

_PRHO = {1: 0.25, 2: 0.5, 3: 0.75}
_CF = {"a": (3.0, 10.0), "b": (0.5, 1.0)}
_CQ = {"a": (100.0, 1000.0), "b": (1.0, 3.0)}


class Instance(NamedTuple):
    """The arrays of one KKT instance that a solve reads."""

    num_nodes: int
    num_arcs: int
    arc_u: np.ndarray  # 0-based int32
    arc_v: np.ndarray  # 0-based int32
    quad_costs: np.ndarray  # f64, the diagonal of D


def nodes_for(arcs: int, rho: int) -> int:
    """Node count from the arc count and density parameter (pargen)."""
    prho = _PRHO[rho]
    return int(np.floor((1.0 + np.sqrt(1.0 + (8.0 * arcs) / prho)) / 2.0))


def generate(arcs: int, rho: int = 3, instance_id: int = 1, cf: str = "a",
             cq: str = "a", scaling: str = "ns") -> Instance:
    """One instance, bitwise the program's ``generate_mcf_instance``."""
    if rho not in _PRHO:
        raise ValueError("rho must be in {1, 2, 3}")
    if cf not in _CF or cq not in _CQ:
        raise ValueError("cf and cq must be 'a' or 'b'")
    if scaling not in ("s", "ns"):
        raise ValueError("scaling must be 's' or 'ns'")
    n = nodes_for(arcs, rho)
    if arcs < n - 1:
        raise ValueError(f"need at least n-1={n - 1} arcs, got {arcs}")
    rng = np.random.default_rng((arcs, rho, instance_id))

    perm = rng.permutation(n)
    extra = arcs - (n - 1)
    eu = rng.integers(0, n, size=extra)
    ev = (eu + 1 + rng.integers(0, n - 1, size=extra)) % n
    arc_u = np.concatenate([perm[:-1], eu]).astype(np.int32)
    arc_v = np.concatenate([perm[1:], ev]).astype(np.int32)

    # every draw below is kept, used or not, so that the quadratic costs
    # come from the same place in the stream as the program's
    max_cost = int(rng.integers(10, 110))
    supply = int(rng.integers(100, 1000))
    cap_lo = max(int(0.05 * supply), 1)
    cap_hi = max(int(0.4 * supply), cap_lo + 1)
    lin_costs = rng.integers(1, max_cost + 1, size=arcs).astype(np.int64)
    rng.integers(cap_lo, cap_hi + 1, size=arcs)  # capacities
    n_src = max(int(rng.integers(1, max(int(0.1 * n), 1) + 1)), 1)
    n_snk = max(int(rng.integers(1, max(int(0.1 * n), 1) + 1)), 1)
    src_nodes = rng.choice(n, size=n_src, replace=False)
    snk_pool = np.setdiff1d(np.arange(n), src_nodes)
    snk_nodes = rng.choice(snk_pool, size=min(n_snk, snk_pool.size),
                           replace=False)
    rng.multinomial(supply, np.full(n_src, 1.0 / n_src))
    rng.multinomial(supply, np.full(len(snk_nodes), 1.0 / len(snk_nodes)))

    ccm1, ccm2 = _CF[cf]
    cam1, cam2 = _CQ[cq]
    fixed = lin_costs * rng.uniform(ccm1, ccm2, size=arcs) + 1.0
    quad = fixed * rng.uniform(cam1, cam2, size=arcs) + 1.0
    return Instance(num_nodes=n, num_arcs=arcs, arc_u=arc_u, arc_v=arc_v,
                    quad_costs=quad)
