"""two_pass_lanczos_tpu_torch — the PyTorch/CUDA port of two_pass_lanczos_tpu.

x = f(A)·b by Lanczos for large sparse symmetric (or Hermitian) A, with the
hot loops in hand-written CUDA kernels for an NVIDIA H100 (``csrc/``, built
with ``nvcc`` at first use). Module names and the public names below follow
the JAX package, which stays the reference; this package imports ``torch``
and never ``jax``. Every entry point runs on the card unless the caller
passes ``device="cpu"`` (the plain PyTorch versions, as the tests do).

Two tiers:

* the generic tier over any operator — ``lanczos`` (one-pass),
  ``lanczos_two_pass`` and ``solve_fAb`` — where a KKT operator's matvec is
  the kernel K8;
* the fused KKT solver ``FusedKKTSolver``, whose passes are whole kernels;
* the double-float tier: ``DFDiagonalOperator``, ``DFKKTOperator`` (its df
  matvec is the kernel K11), ``lanczos_pass_one_df``, ``solve_fAb_df`` and
  the fused ``DFFusedKKTSolver`` (kernels K9 and K10), near-f64 results
  from (hi, lo) f32 pairs.

On these tiers stands the capability layer: Ritz values, quadratures and
error brackets from a decomposition (``spectrum``), tr f(A) and the
spectral density by stochastic Lanczos quadrature (``slq``), extreme
eigenpairs by thick-restart Lanczos (``eigen.eigsh``) and storage-free
Chebyshev f(A)·b (``algorithms.chebyshev``); the fused solver runs them on
its kernels (``FusedKKTSolver.slq_trace``, ``slq_spectral_density``,
``slq_trace_adaptive``, ``estimate_interval``, ``chebyshev_fAb``), and so do
the sharded tiers (``parallel``). Beside them: reorthogonalised one-pass
Lanczos (``solve_fAb(..., method="one_pass", reorth=True)`` or
``"selective"``, ``algorithms.reorth``) and block Lanczos for a block of
right-hand sides (``solve_fAb_block``, ``algorithms.block``).

Example::

    import numpy as np
    import torch
    import two_pass_lanczos_tpu_torch as tpl

    inst = tpl.generate_mcf_instance(500_000, rho=3, instance_id=1)
    op = tpl.make_kkt_operator(inst.quad_costs, inst.arc_u, inst.arc_v,
                               inst.num_nodes, dtype=torch.float32)  # card
    b = np.random.default_rng(0).standard_normal(op.shape[0]).astype(np.float32)
    x = tpl.solve_fAb(op, b, k=500, f="inv")              # generic, K8
    x2 = tpl.lanczos_two_pass(op, b, 500, tpl.make_inv_solver())
    s = tpl.FusedKKTSolver(inst.quad_costs, inst.arc_u, inst.arc_v,
                           inst.num_nodes)
    x3, decomp = s.solve(b, k=500, f="inv")               # fused kernels
    sdf = tpl.DFFusedKKTSolver(inst.quad_costs, inst.arc_u, inst.arc_v,
                               inst.num_nodes)                # f64 costs
    x4, (alphas, betas, steps) = sdf.solve(b.astype(np.float64), k=500)
"""

from two_pass_lanczos_tpu_torch.algorithms.block import (
    BlockDecomposition,
    block_padded_f_e1,
    block_pass_one,
    block_pass_two,
    solve_fAb_block,
    solve_fAb_block_jit,
)
from two_pass_lanczos_tpu_torch.algorithms.chebyshev import (
    chebyshev_coefficients,
    chebyshev_fAb,
    estimate_interval,
)
from two_pass_lanczos_tpu_torch.algorithms.chunked import (
    lanczos_pass_one_chunked,
    lanczos_standard_chunked,
)
from two_pass_lanczos_tpu_torch.algorithms.core import (
    LanczosDecomposition,
    breakdown_tolerance,
)
from two_pass_lanczos_tpu_torch.algorithms.df import (
    DFDiagonalOperator,
    DFKKTOperator,
    lanczos_pass_one_df,
    solve_fAb_df,
)
from two_pass_lanczos_tpu_torch.algorithms.one_pass import lanczos_standard
from two_pass_lanczos_tpu_torch.algorithms.two_pass import (
    lanczos_pass_one,
    lanczos_pass_two,
    lanczos_pass_two_with_basis,
)
from two_pass_lanczos_tpu_torch.checkpoint import (
    load_decomposition,
    save_decomposition,
)
from two_pass_lanczos_tpu_torch.convergence import (
    convergence_history,
    make_convergence_callback,
    make_radau_error_callback,
    radau_error_bound,
    update_norm,
)
from two_pass_lanczos_tpu_torch.eigen import EigshResult, eigsh
from two_pass_lanczos_tpu_torch.errors import (
    BreakdownError,
    DimensionMismatchError,
    EvdError,
    InputError,
    LanczosError,
    ParameterMismatchError,
    SolverError,
)
from two_pass_lanczos_tpu_torch.functions import (
    make_exp_solver,
    make_function_solver,
    make_inv_solver,
    make_poly_solver,
    padded_f_e1,
)
from two_pass_lanczos_tpu_torch.models.generator import generate_mcf_instance
from two_pass_lanczos_tpu_torch.observability import (
    find_stopping_point,
    replay_iterations,
    truncate_decomposition,
)
from two_pass_lanczos_tpu_torch.operators import (
    CallableOperator,
    CudaKKTOperator,
    DenseOperator,
    DiagonalOperator,
    KKTOperator,
    LinearOperator,
    SparseOperator,
    as_operator,
    make_kkt_operator,
)
from two_pass_lanczos_tpu_torch.ops.kkt_fused import FusedKKTSolver
from two_pass_lanczos_tpu_torch.ops.kkt_fused_df import DFFusedKKTSolver
from two_pass_lanczos_tpu_torch.slq import (
    SLQResult,
    batched_quadratic_form,
    batched_ritz_weights,
    lanczos_pass_one_batched,
    slq_logdet,
    slq_spectral_density,
    slq_trace,
    slq_trace_adaptive,
)
from two_pass_lanczos_tpu_torch.solvers import (
    lanczos,
    lanczos_two_pass,
    solve_fAb,
)
from two_pass_lanczos_tpu_torch.spectrum import (
    a_norm_error_history,
    gauss_radau_bracket,
    quadratic_form,
    quadrature_bracket,
    ritz_pairs,
    ritz_residual_bounds,
    ritz_values,
)

__all__ = [
    # solvers (the reference's crate-root re-exports)
    "lanczos",
    "lanczos_two_pass",
    "solve_fAb",
    # algorithms
    "lanczos_standard",
    "lanczos_standard_chunked",
    "lanczos_pass_one",
    "lanczos_pass_one_chunked",
    "lanczos_pass_two",
    "lanczos_pass_two_with_basis",
    "LanczosDecomposition",
    "breakdown_tolerance",
    # operators
    "LinearOperator",
    "DenseOperator",
    "DiagonalOperator",
    "SparseOperator",
    "KKTOperator",
    "CudaKKTOperator",
    "make_kkt_operator",
    "CallableOperator",
    "as_operator",
    "FusedKKTSolver",
    # double-float (compensated) precision
    "DFDiagonalOperator",
    "DFKKTOperator",
    "DFFusedKKTSolver",
    "lanczos_pass_one_df",
    "solve_fAb_df",
    # matrix functions
    "make_inv_solver",
    "make_exp_solver",
    "make_function_solver",
    "make_poly_solver",
    "padded_f_e1",
    # convergence estimation / ready-made stopping callbacks
    "update_norm",
    "convergence_history",
    "make_convergence_callback",
    "radau_error_bound",
    "make_radau_error_callback",
    # spectral analysis from the decomposition
    "ritz_values",
    "ritz_pairs",
    "ritz_residual_bounds",
    "quadratic_form",
    "gauss_radau_bracket",
    "quadrature_bracket",
    "a_norm_error_history",
    # thick-restart Lanczos eigensolver
    "eigsh",
    "EigshResult",
    # block Lanczos: f(A)B on one shared block Krylov space
    "BlockDecomposition",
    "block_pass_one",
    "block_pass_two",
    "block_padded_f_e1",
    "solve_fAb_block",
    "solve_fAb_block_jit",
    # Chebyshev-expansion f(A)b
    "chebyshev_fAb",
    "chebyshev_coefficients",
    "estimate_interval",
    # stochastic Lanczos quadrature: tr f(A) and the spectral density
    "SLQResult",
    "lanczos_pass_one_batched",
    "batched_quadratic_form",
    "batched_ritz_weights",
    "slq_trace",
    "slq_trace_adaptive",
    "slq_logdet",
    "slq_spectral_density",
    # observability and checkpoints
    "replay_iterations",
    "find_stopping_point",
    "truncate_decomposition",
    "save_decomposition",
    "load_decomposition",
    # instances
    "generate_mcf_instance",
    # errors
    "LanczosError",
    "BreakdownError",
    "DimensionMismatchError",
    "InputError",
    "ParameterMismatchError",
    "EvdError",
    "SolverError",
]
