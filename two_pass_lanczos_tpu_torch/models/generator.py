"""Min-cost-flow KKT instance generator (pure-Python reference path).

Capability parity with the reference's three-stage C toolchain
(``data/qcnd/pargen.c`` → ``data/netgen/src/netgen.c`` → ``data/qcnd/qfcgen.c``,
orchestrated by ``src/bin/datagen.rs``): given ``(arcs, rho, instance-id,
cf, cq, scaling)``, produce a DIMACS ``.dmx`` network plus a ``.qfc``
quadratic-cost file, with the same parameter semantics:

* node count ``n = floor((1 + sqrt(1 + 8m/prho)) / 2)`` with
  ``prho ∈ {0.25, 0.5, 0.75}`` for ``rho ∈ {1, 2, 3}``
  (``data/qcnd/readme.txt:14-28``);
* linear arc costs in ``[1, maxcost]``; capacities derived from total supply;
* fixed costs ``Cc = b·U[Ccm₁, Ccm₂] + 1`` with (Ccm₁, Ccm₂) = (3, 10) for
  ``cf='a'`` and (0.5, 1) for ``cf='b'``; quadratic costs
  ``Ca = Cc·U[Cam₁, Cam₂] + 1`` with (100, 1000) for ``cq='a'`` and (1, 3)
  for ``cq='b'`` (``data/qcnd/readme.txt:80-105``);
* the ``netgen-{arcs}-{rho}-{id}-{cf}-{cq}-{s}`` file-naming convention
  (reference ``src/bin/datagen.rs:109-117``).

Unlike the reference toolchain (which seeds from wall-clock time,
``pargen.c:54-56``), instances here are **deterministic in the instance id**,
making the generated property-test corpus reproducible. The graph is a
random connected multigraph: a spanning chain over a seeded node permutation
guarantees connectivity (NETGEN's skeleton idea), and the remaining arcs are
uniform random pairs. A faster C++ implementation with identical output lives
in ``cpp/`` (see ``cpp/mcfgen.cpp``); this module is the oracle for it.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

__all__ = ["generate_mcf_instance", "MCFInstance", "instance_basename", "nodes_for"]

_PRHO = {1: 0.25, 2: 0.5, 3: 0.75}
_CF = {"a": (3.0, 10.0), "b": (0.5, 1.0)}
_CQ = {"a": (100.0, 1000.0), "b": (1.0, 3.0)}


class MCFInstance(NamedTuple):
    num_nodes: int
    num_arcs: int
    arc_u: np.ndarray  # 0-based int32
    arc_v: np.ndarray  # 0-based int32
    lin_costs: np.ndarray  # int64 — netgen's linear costs b_ij
    capacities: np.ndarray  # int64
    fixed_costs: np.ndarray  # f64 — qfcgen's Cc
    quad_costs: np.ndarray  # f64 — qfcgen's Ca (diagonal of D)
    supplies: np.ndarray  # int64 per node (sources +, sinks −)


def nodes_for(arcs: int, rho: int) -> int:
    """Node count from the arc count and density parameter (pargen formula)."""
    prho = _PRHO[rho]
    return int(np.floor((1.0 + np.sqrt(1.0 + (8.0 * arcs) / prho)) / 2.0))


def instance_basename(arcs: int, rho: int, instance_id: int, cf: str, cq: str, scaling: str) -> str:
    """``netgen-{arcs}-{rho}-{id}-{cf}-{cq}-{s}`` (reference ``datagen.rs:109-117``)."""
    return f"netgen-{arcs}-{rho}-{instance_id}-{cf}-{cq}-{scaling}"


def generate_mcf_instance(
    arcs: int,
    rho: int = 3,
    instance_id: int = 1,
    cf: str = "a",
    cq: str = "a",
    scaling: str = "ns",
    output_dir: Optional[os.PathLike] = None,
) -> MCFInstance:
    """Generate one instance; optionally write ``.dmx``/``.qfc`` to ``output_dir``.

    Returns the in-memory arrays either way (tests can skip the filesystem).
    """
    if rho not in _PRHO:
        raise ValueError("rho must be in {1, 2, 3}")
    if cf not in _CF or cq not in _CQ:
        raise ValueError("cf and cq must be 'a' or 'b'")
    if scaling not in ("s", "ns"):
        raise ValueError("scaling must be 's' or 'ns'")

    n = nodes_for(arcs, rho)
    if arcs < n - 1:
        raise ValueError(f"need at least n-1={n - 1} arcs for connectivity, got {arcs}")
    rng = np.random.default_rng((arcs, rho, instance_id))

    # --- topology: skeleton chain over a random permutation + random arcs ---
    perm = rng.permutation(n)
    skel_u = perm[:-1]
    skel_v = perm[1:]
    extra = arcs - (n - 1)
    eu = rng.integers(0, n, size=extra)
    ev = (eu + 1 + rng.integers(0, n - 1, size=extra)) % n  # u != v
    arc_u = np.concatenate([skel_u, eu]).astype(np.int32)
    arc_v = np.concatenate([skel_v, ev]).astype(np.int32)

    # --- netgen-style parameters (pargen.c:80-100 semantics) ---
    max_cost = int(rng.integers(10, 110))  # maxcost ∈ [10, 109]
    supply = int(rng.integers(100, 1000))  # total supply ∈ [100, 999]
    cap_lo = max(int(0.05 * supply), 1)
    cap_hi = max(int(0.4 * supply), cap_lo + 1)
    lin_costs = rng.integers(1, max_cost + 1, size=arcs).astype(np.int64)
    capacities = rng.integers(cap_lo, cap_hi + 1, size=arcs).astype(np.int64)
    if scaling == "s":
        capacities = np.maximum((capacities * 0.7).astype(np.int64), 1)

    # sources/sinks: up to 10% of nodes each (pargen.c:73-78)
    n_src = max(int(rng.integers(1, max(int(0.1 * n), 1) + 1)), 1)
    n_snk = max(int(rng.integers(1, max(int(0.1 * n), 1) + 1)), 1)
    supplies = np.zeros(n, dtype=np.int64)
    src_nodes = rng.choice(n, size=n_src, replace=False)
    snk_pool = np.setdiff1d(np.arange(n), src_nodes)
    snk_nodes = rng.choice(snk_pool, size=min(n_snk, snk_pool.size), replace=False)
    src_split = rng.multinomial(supply, np.full(n_src, 1.0 / n_src))
    snk_split = rng.multinomial(supply, np.full(len(snk_nodes), 1.0 / len(snk_nodes)))
    supplies[src_nodes] += src_split
    supplies[snk_nodes] -= snk_split

    # --- qfcgen-style costs (readme.txt:80-105 formulas) ---
    ccm1, ccm2 = _CF[cf]
    cam1, cam2 = _CQ[cq]
    fixed = lin_costs * rng.uniform(ccm1, ccm2, size=arcs) + 1.0
    quad = fixed * rng.uniform(cam1, cam2, size=arcs) + 1.0

    inst = MCFInstance(
        num_nodes=n,
        num_arcs=arcs,
        arc_u=arc_u,
        arc_v=arc_v,
        lin_costs=lin_costs,
        capacities=capacities,
        fixed_costs=fixed,
        quad_costs=quad,
        supplies=supplies,
    )
    if output_dir is not None:
        base = instance_basename(arcs, rho, instance_id, cf, cq, scaling)
        write_instance(inst, Path(output_dir), base)
    return inst


def write_instance(inst: MCFInstance, output_dir: Path, base: str) -> tuple:
    """Write ``{base}.dmx`` (DIMACS) and ``{base}.qfc`` (qfcgen layout).

    The ``.qfc`` uses the original C-tool layout — count line, then the fixed
    costs on one line and the quadratic costs on one line
    (``data/qcnd/qfcgen.c:203-218``) — which our tokenizing parser reads
    exactly (and the reference's line-based parser does not; see the
    data_loader docstring for the resolution).
    """
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    dmx = output_dir / f"{base}.dmx"
    qfc = output_dir / f"{base}.qfc"
    with open(dmx, "w") as fh:
        fh.write("c generated by two_pass_lanczos_tpu.models.generator\n")
        fh.write(f"p min {inst.num_nodes} {inst.num_arcs}\n")
        for node in np.nonzero(inst.supplies)[0]:
            fh.write(f"n {node + 1} {inst.supplies[node]}\n")
        for j in range(inst.num_arcs):
            fh.write(
                f"a {inst.arc_u[j] + 1} {inst.arc_v[j] + 1} 0 "
                f"{inst.capacities[j]} {inst.lin_costs[j]}\n"
            )
    with open(qfc, "w") as fh:
        fh.write(f"{inst.num_arcs}\n")
        fh.write(" ".join(f"{c:.6f}" for c in inst.fixed_costs) + " \n")
        fh.write(" ".join(f"{c:.6f}" for c in inst.quad_costs) + " \n")
    return dmx, qfc
