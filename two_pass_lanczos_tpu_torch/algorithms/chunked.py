"""In-run early stopping: chunked pass one with a live per-step callback.

Counterpart of ``two_pass_lanczos_tpu/algorithms/chunked.py``. The
reference calls a ``LanczosCallback`` inside the hot loop and breaks out of
it when the callback returns false, so an early stop skips the remaining
matvecs (``src/algorithms/lanczos.rs:93-113``). Here pass one runs as a
host-driven sequence of chunks of ``chunk`` steps:

* every chunk is :func:`~two_pass_lanczos_tpu_torch.algorithms.core.
  pass_one_chunk_scan`, the same step function as the monolithic
  ``pass_one_scan``, so α and β are bitwise the monolithic run's;
* after each chunk its α, β, step count and done flag come back to the host
  in ONE copy (never one per step), and the callback is replayed for every
  new step with the reference's view ``callback(steps_taken, V[:steps] or
  None, (alphas[:s], betas[:s-1]))``; with a stored basis and a callback,
  the chunk's basis rows come back in a second copy;
* a stop at step ``s`` runs at most ``ceil(s/chunk)·chunk`` matvecs.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.algorithms.core import (
    LanczosDecomposition,
    pass_one_chunk_scan,
    real_dtype,
)

__all__ = ["lanczos_pass_one_chunked", "lanczos_standard_chunked"]


def _chunked_pass_one(operator, b: torch.Tensor, k: int,
                      callback: Optional[Callable], chunk: int,
                      emit_basis: bool):
    if k < 1:
        raise ValueError("k must be >= 1")
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    rdt = real_dtype(b.dtype)
    a_all = torch.zeros(k, dtype=rdt).numpy()
    b_all = np.zeros_like(a_all)
    basis = (torch.zeros((k, b.shape[0]), dtype=b.dtype, device=b.device)
             if emit_basis else None)
    # host copy of the basis rows for the callback's view, filled once per
    # chunk
    v_all = (torch.zeros((k, b.shape[0]), dtype=b.dtype).numpy()
             if emit_basis and callback is not None else None)
    carry = None
    filled = steps_prev = 0
    stop_at = None  # the callback's stop (1-based step)
    while filled < k:
        c = min(chunk, k - filled)
        rows = basis[filled:filled + c] if emit_basis else None
        a, bt, carry = pass_one_chunk_scan(operator.matvec, b, c, carry, k,
                                           basis=rows)
        packed = torch.cat([a, bt, torch.stack([
            carry.steps.to(rdt), carry.done.to(rdt)])]).cpu().numpy()
        a_all[filled:filled + c] = packed[:c]
        b_all[filled:filled + c] = packed[c:2 * c]
        steps_now, done = int(packed[2 * c]), bool(packed[2 * c + 1])
        if v_all is not None:
            v_all[filled:filled + c] = rows.cpu().numpy()
        filled += c
        if callback is not None:
            for s in range(steps_prev + 1, steps_now + 1):
                v_view = v_all[:s] if v_all is not None else None
                if not callback(s, v_view, (a_all[:s], b_all[:s - 1])):
                    stop_at = s
                    break
            if stop_at is not None:
                break
        steps_prev = steps_now
        if done:
            break

    steps_final = stop_at if stop_at is not None else steps_prev
    alphas = np.zeros_like(a_all)
    betas = np.zeros_like(b_all)
    alphas[:steps_final] = a_all[:steps_final]
    # the residual β at [steps_final-1] stays (the full-run convention of
    # LanczosDecomposition: the Lanczos-relation property needs β_k)
    betas[:steps_final] = b_all[:steps_final]
    decomp = LanczosDecomposition(
        alphas=torch.from_numpy(alphas).to(b.device),
        betas=torch.from_numpy(betas).to(b.device),
        steps_taken=torch.tensor(steps_final, dtype=torch.int32,
                                 device=b.device),
        b_norm=carry.b_norm)
    if emit_basis:
        # rows the chunk ran past the stop are valid steps the stop excludes
        basis[steps_final:] = 0
    return decomp, basis


def lanczos_pass_one_chunked(operator, b: torch.Tensor, k: int,
                             callback: Optional[Callable] = None, *,
                             chunk: int = 16) -> LanczosDecomposition:
    """Pass one (scalars only, O(n) memory) with a live early-stop callback.

    ``callback(steps_taken, None, (alphas, betas)) -> bool`` is replayed
    after every step at the chunk boundaries; ``False`` stops the run: at
    most the current chunk finishes. α and β are bitwise those of
    :func:`~two_pass_lanczos_tpu_torch.algorithms.two_pass.lanczos_pass_one`.
    """
    decomp, _ = _chunked_pass_one(operator, b, k, callback, chunk, False)
    return decomp


def lanczos_standard_chunked(operator, b: torch.Tensor, k: int,
                             callback: Optional[Callable] = None, *,
                             chunk: int = 16
                             ) -> Tuple[LanczosDecomposition, torch.Tensor]:
    """One-pass Lanczos (basis stored) with a live early-stop callback,
    which receives ``callback(steps_taken, V[:steps_taken], (alphas,
    betas))``. Returns ``(decomposition, basis)``, the basis ``(k, n)`` with
    rows beyond ``steps_taken`` zero."""
    return _chunked_pass_one(operator, b, k, callback, chunk, True)
