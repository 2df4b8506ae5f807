"""two_pass_lanczos_tpu_torch — the PyTorch/CUDA port of two_pass_lanczos_tpu.

x = f(A)·b by two-pass Lanczos for the KKT matrix of a min-cost-flow
problem, with the hot loop in hand-written CUDA kernels for an NVIDIA H100
(``csrc/``, built with ``nvcc`` at first use). Module names follow the JAX
package, which stays the reference; this package imports ``torch`` and never
``jax``.

Example::

    import numpy as np
    from two_pass_lanczos_tpu_torch import FusedKKTSolver, generate_mcf_instance

    inst = generate_mcf_instance(500_000, rho=3, instance_id=1)
    s = FusedKKTSolver(inst.quad_costs, inst.arc_u, inst.arc_v,
                       inst.num_nodes, device="cuda")
    b = np.random.default_rng(0).standard_normal(s.n).astype(np.float32)
    x, decomp = s.solve(b, k=500, f="inv")
    x1, _ = s.solve(b, k=500, f="inv", method="one_pass")  # stores the basis
    cb = make_convergence_callback("inv", tol=1e-6)
    x2, dec2 = s.solve(b, k=500, f="inv", callback=cb)    # in-run early stop
"""

from two_pass_lanczos_tpu_torch.algorithms.core import LanczosDecomposition
from two_pass_lanczos_tpu_torch.checkpoint import (
    load_decomposition,
    save_decomposition,
)
from two_pass_lanczos_tpu_torch.convergence import (
    make_convergence_callback,
    make_radau_error_callback,
)
from two_pass_lanczos_tpu_torch.functions import padded_f_e1
from two_pass_lanczos_tpu_torch.models.generator import generate_mcf_instance
from two_pass_lanczos_tpu_torch.observability import (
    find_stopping_point,
    replay_iterations,
    truncate_decomposition,
)
from two_pass_lanczos_tpu_torch.ops.kkt_fused import FusedKKTSolver

__all__ = ["FusedKKTSolver", "LanczosDecomposition", "padded_f_e1",
           "generate_mcf_instance", "make_convergence_callback",
           "make_radau_error_callback", "replay_iterations",
           "find_stopping_point", "truncate_decomposition",
           "save_decomposition", "load_decomposition"]
