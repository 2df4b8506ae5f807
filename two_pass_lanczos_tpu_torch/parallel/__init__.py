"""Distribution over processes and cards.

Counterpart of ``two_pass_lanczos_tpu/parallel`` on the ranks of a
``torch.distributed`` process group (one process per card):

* the generic row partition: ``ShardedSparseOperator`` splits any sparse
  operator's rows over the ranks (``partition.snake_partition``) and
  all-gathers the O(n) Krylov vector each step, asynchronously, while the
  owned-column product runs;
* the arc-sharded fused solvers: a 1-D partition of the KKT arc block, the
  node block replicated, and per step only the O(p) node partials and the
  dots' partials (a few floats a rank) all-gathered.

Every reduction is an all-gather folded in rank order
(``parallel/comm.py``), so every rank holds the same bits.
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
from two_pass_lanczos_tpu_torch.parallel.partition import (
    RowPartition,
    snake_partition,
)
from two_pass_lanczos_tpu_torch.parallel.sharded import ShardedSparseOperator

__all__ = [
    "make_mesh",
    "initialize_distributed",
    "Mesh",
    "snake_partition",
    "RowPartition",
    "ShardedSparseOperator",
    "ShardedFusedKKTSolver",
    "DFShardedFusedKKTSolver",
]
