"""``ShardedFusedKKTSolver.solve``: the arc-sharded two-pass solve over the
harness's process group, one rank a card. Each rank runs K7 over its arcs;
the node partials and the dots' arc partials are all-gathered and summed
in rank order; on a card each pass is one CUDA graph. The call then
gathers the whole x onto each rank's card (``gather_x``), as the
one-card cells return theirs.

The module needs ``ShardedFusedKKTSolver.gather_x`` and says so when it
is loaded, before any rank builds the instance."""

from __future__ import annotations

import numpy as np

from h100_bench.entries import Output
from two_pass_lanczos_tpu_torch.parallel.fused_sharded import (
    ShardedFusedKKTSolver,
)

if not hasattr(ShardedFusedKKTSolver, "gather_x"):
    raise ImportError("ShardedFusedKKTSolver has no gather_x: this program "
                      "cannot return the whole x on the card")


def build(instance, traffic, device):
    from two_pass_lanczos_tpu_torch.parallel import make_mesh
    return ShardedFusedKKTSolver(np.asarray(instance.quad_costs, np.float32),
                                 instance.arc_u, instance.arc_v,
                                 instance.num_nodes, make_mesh(device=device))


def solve(system, b, traffic) -> Output:
    x, dec = system.solve(b, k=traffic["k"], f=traffic["f"],
                          method=traffic["method"], raw=True)
    return Output(x=system.gather_x(x), alphas=dec.alphas, betas=dec.betas,
                  steps=dec.steps_taken, b_norm=dec.b_norm)


def traced(system):
    """The layers are read from their kernels' names: no span."""
    return system


def counters() -> dict:
    """``LAUNCHES`` and ``collectives``, the collectives run on this
    rank."""
    from two_pass_lanczos_tpu_torch.ops.kkt_fused import LAUNCHES
    from two_pass_lanczos_tpu_torch.parallel.comm import COLLECTIVES
    return {**LAUNCHES, "collectives": sum(COLLECTIVES.values())}
