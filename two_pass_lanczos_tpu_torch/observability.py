"""Observability: iteration callbacks, profiling, speed-of-light accounting.

Counterpart of ``two_pass_lanczos_tpu/observability.py``:

* **Per-iteration callback, after the run** — :func:`replay_iterations`
  feeds a callback the reference's ``(k, V_k view, T_k view)`` from a
  finished decomposition, :func:`find_stopping_point` returns the step where
  it would have stopped and :func:`truncate_decomposition` cuts the
  decomposition there. The in-run stop is
  ``FusedKKTSolver.pass_one_chunked``.
* **Profiling** — :func:`trace` names a region in a ``torch.profiler``
  trace.
* **Speed-of-light model** — :func:`kkt_matvec_bytes` and
  :func:`kkt_spmv_sol`: the bytes one K1 matvec (``csrc/kkt_matvec.cu``)
  must move, against the H100 SXM's HBM3 bandwidth;
  :func:`df_kkt_matvec_bytes` the same for K11, the double-float matvec
  (``csrc/df_kkt_matvec.cu``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import torch

from two_pass_lanczos_tpu_torch.algorithms.core import LanczosDecomposition

__all__ = [
    "replay_iterations",
    "find_stopping_point",
    "truncate_decomposition",
    "trace",
    "SoLReport",
    "kkt_matvec_bytes",
    "df_kkt_matvec_bytes",
    "kkt_spmv_sol",
    "H100_SXM_HBM3_BW",
]


def replay_iterations(
    decomposition: LanczosDecomposition,
    callback: Callable,
    basis=None,
) -> int:
    """Invoke ``callback(k, v_k, (alphas, betas))`` for k = 1..steps_taken.

    ``alphas`` and ``betas`` are NumPy views of the valid prefix (lengths
    ``k`` and ``k-1``); ``v_k`` is ``basis[:k]`` (a view, on the basis's own
    device) when the one-pass basis is given, else None. Returns the number
    of iterations visited: the callback returns False to stop early,
    mirroring the reference's contract.
    """
    steps = decomposition.steps()
    alphas = decomposition.alphas_valid()
    betas = decomposition.betas_valid()
    visited = 0
    for k in range(1, steps + 1):
        visited = k
        v_view = basis[:k] if basis is not None else None
        if not callback(k, v_view, (alphas[:k], betas[: max(k - 1, 0)])):
            break
    return visited


def find_stopping_point(decomposition: LanczosDecomposition,
                        callback: Callable) -> int:
    """Steps after which the callback would have stopped the iteration."""
    return replay_iterations(decomposition, callback)


def truncate_decomposition(
    decomposition: LanczosDecomposition, steps: int
) -> LanczosDecomposition:
    """Truncate to ``steps`` iterations (early-stop semantics): α zeroed
    from ``steps``, β from ``steps-1``, ``steps_taken`` clamped. Shapes and
    devices stay as they are."""
    steps = int(min(steps, decomposition.steps()))
    i = torch.arange(decomposition.k_max, device=decomposition.alphas.device)
    zero = torch.zeros((), dtype=decomposition.alphas.dtype,
                       device=decomposition.alphas.device)
    return LanczosDecomposition(
        alphas=torch.where(i < steps, decomposition.alphas, zero),
        betas=torch.where(i < steps - 1, decomposition.betas, zero),
        steps_taken=torch.tensor(steps, dtype=torch.int32,
                                 device=decomposition.steps_taken.device),
        b_norm=decomposition.b_norm,
    )


@contextlib.contextmanager
def trace(name: str, enabled: bool = True):
    """``torch.profiler.record_function`` context (no-op when disabled)."""
    if not enabled:
        yield
        return
    with torch.profiler.record_function(name):
        yield


# ---------------------------------------------------------------------------
# Speed-of-light accounting
# ---------------------------------------------------------------------------

#: HBM bandwidth of one H100 SXM (HBM3, NVIDIA's data sheet): 3.35 TB/s,
#: at the card's full 700 W power limit.
H100_SXM_HBM3_BW = 3.35e12


@dataclasses.dataclass
class SoLReport:
    nnz: int
    bytes_per_matvec: int
    sol_seconds: float
    achieved_seconds: float

    @property
    def sol_fraction(self) -> float:
        return self.sol_seconds / self.achieved_seconds

    @property
    def achieved_nnz_per_s(self) -> float:
        return self.nnz / self.achieved_seconds

    def __str__(self):
        return (
            f"SpMV: {self.nnz} nnz, {self.bytes_per_matvec / 1e6:.1f} MB/matvec, "
            f"SoL {self.sol_seconds * 1e6:.1f} us, achieved "
            f"{self.achieved_seconds * 1e6:.1f} us "
            f"({self.sol_fraction:.1%} of speed of light, "
            f"{self.achieved_nnz_per_s / 1e9:.2f} Gnnz/s)"
        )


def kkt_matvec_bytes(num_arcs: int, num_nodes: int) -> int:
    """Bytes one K1 matvec (``csrc/kkt_matvec.cu``) must move to or from
    device memory when nothing is cached, each array once.

    Derivation, from the kernel's two parts (m arcs, p nodes, f32 values,
    int32 indices):

    * arc part, one thread per arc ``j``: reads ``d[j]``, ``x_a[j]``,
      ``u[j]``, ``v[j]`` and writes ``y_a[j]``: 5·4 = 20 B per arc; its
      gathers ``x_n[u[j]]``, ``x_n[v[j]]`` hit the node table, which is read
      once: 4p B;
    * node part, one block per node: reads ``ptr`` (4(p+1) B) and the 2m
      signed incidence entries ``ent`` (8 B per arc), gathers ``x_a`` at
      each entry (already counted by the arc part: the array is 2 MB at the
      headline and stays in the 50 MB L2) and writes ``y_n``: 4p B.

    Total 28·m + 12·p + 4 bytes. The 2m gathered ``x_a`` reads are traffic
    from the L2, not from HBM, and are not counted.
    """
    return 28 * num_arcs + 12 * num_nodes + 4


def df_kkt_matvec_bytes(num_arcs: int, num_nodes: int) -> int:
    """Bytes one K11 df matvec (``csrc/df_kkt_matvec.cu``) must move to or
    from device memory on the port's layout (arcs in their original order,
    no padding, (hi, lo) f32 planes), each array once.

    d, x and y as (hi, lo) pairs and the int32 arc endpoints u, v: 8 B per
    arc for d, 8 for u and v, 8 + 8 per unknown for x and y, so
    32·m + 16·p (16.0 MB at the headline). What the kernel's design reads
    besides — the node-sorted incidence CSR it builds from u and v (``ptr``
    and ``ent``, 8·m + 4·p + 4 bytes, as for K1 in
    :func:`kkt_matvec_bytes`) and the L2-resident gathers of the x_a pairs
    — belongs to the design, not to the function.
    """
    return 32 * num_arcs + 16 * num_nodes


def kkt_spmv_sol(num_arcs: int, num_nodes: int, achieved_seconds: float,
                 bandwidth: float = H100_SXM_HBM3_BW) -> SoLReport:
    """Speed-of-light bound of one K1 matvec: :func:`kkt_matvec_bytes`
    over ``bandwidth`` (default the H100 SXM's HBM3), against the
    ``achieved_seconds`` measured on the card. ``nnz`` counts the KKT
    matrix's stored entries: m of D and 2m each of E and Eᵀ."""
    bytes_total = kkt_matvec_bytes(num_arcs, num_nodes)
    return SoLReport(
        nnz=5 * num_arcs,
        bytes_per_matvec=bytes_total,
        sol_seconds=bytes_total / bandwidth,
        achieved_seconds=achieved_seconds,
    )
