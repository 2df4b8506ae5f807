"""Distribution over processes and cards: the arc-sharded fused solvers.

Counterpart of ``two_pass_lanczos_tpu/parallel``: a 1-D partition of the
KKT arc block over the ranks of a ``torch.distributed`` process group (one
process per card), the node block replicated, and per step only the O(p)
node partials and the scalar dot partials all-gathered and folded in rank
order (``parallel/comm.py``). The generic row-partitioned
``ShardedSparseOperator`` and its ``partition.py`` are not ported yet
(ROADMAP).
"""

from two_pass_lanczos_tpu_torch.parallel.fused_sharded import (
    ShardedFusedKKTSolver,
)
from two_pass_lanczos_tpu_torch.parallel.fused_sharded_df import (
    DFShardedFusedKKTSolver,
)
from two_pass_lanczos_tpu_torch.parallel.mesh import (
    Mesh,
    initialize_distributed,
    make_mesh,
)

__all__ = [
    "make_mesh",
    "initialize_distributed",
    "Mesh",
    "ShardedFusedKKTSolver",
    "DFShardedFusedKKTSolver",
]
