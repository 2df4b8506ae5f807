"""Carry state across from the JAX package, as NumPy arrays.

The port never imports ``jax``; these functions take the JAX objects and read
them with ``np.asarray``, so the tests can feed one instance or one
decomposition to both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.algorithms.core import LanczosDecomposition
from two_pass_lanczos_tpu_torch.ops.kkt_fused import FusedKKTSolver

__all__ = ["solver_from_jax", "decomposition_from_jax"]


def solver_from_jax(jax_fused_solver, device="cpu") -> FusedKKTSolver:
    """The port's solver for the instance of a JAX ``FusedKKTSolver``
    (its ``_kkt_arrays``: quad costs, arc_u, arc_v, num_nodes), with the
    same ``compensated`` setting."""
    d, u, v, p = jax_fused_solver._kkt_arrays
    return FusedKKTSolver(np.asarray(d), np.asarray(u), np.asarray(v), int(p),
                          device=device,
                          compensated=jax_fused_solver.compensated)


def decomposition_from_jax(dec, device="cpu") -> LanczosDecomposition:
    """A JAX ``LanczosDecomposition`` as the port's, on ``device``."""

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    return LanczosDecomposition(
        alphas=t(dec.alphas), betas=t(dec.betas),
        steps_taken=t(np.int32(dec.steps_taken)).reshape(()),
        b_norm=t(dec.b_norm).reshape(()))
