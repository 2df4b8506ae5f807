"""``solve_fAb`` on a ``SparseOperator``: the generic "any operator" tier
over the assembled KKT matrix in float32 (``kkt_sorted_coo``), whose
product is ``coo_spmv`` (a gather, a multiply and ``torch.segment_reduce``)
and no fused kernel."""

from __future__ import annotations

import numpy as np
from torch.profiler import record_function

from h100_bench.entries import Output

SPMV = "bench.spmv"


def build(instance, traffic, device):
    from two_pass_lanczos_tpu_torch import SparseOperator
    from two_pass_lanczos_tpu_torch.models.kkt import kkt_sorted_coo
    from two_pass_lanczos_tpu_torch.utils.data_loader import KKTArrays
    arrays = KKTArrays(quad_costs=np.asarray(instance.quad_costs, np.float32),
                       arc_u=instance.arc_u, arc_v=instance.arc_v,
                       num_nodes=instance.num_nodes,
                       num_arcs=instance.num_arcs)
    return SparseOperator(kkt_sorted_coo(arrays, dtype=np.float32,
                                         device=device), device=device)


def solve(system, b, traffic) -> Output:
    from two_pass_lanczos_tpu_torch import solve_fAb
    return Output(x=solve_fAb(system, b, k=traffic["k"], f=traffic["f"],
                              method=traffic["method"]))


class _Spanned:
    """The operator with a ``bench.spmv`` span around each product."""

    def __init__(self, op):
        self._op = op
        self.shape, self.dtype, self.device = op.shape, op.dtype, op.device

    def matvec(self, x):
        with record_function(SPMV):
            return self._op.matvec(x)


def traced(system):
    return _Spanned(system)


def counters() -> dict:
    return {}
