"""The collectives of the sharded solvers: all-gathers folded in rank order.

Every collective of ``parallel/fused_sharded.py``,
``parallel/fused_sharded_df.py`` and ``parallel/sharded.py`` goes through
these helpers, which report each call to
``utils/collectives.record_collectives``. The row-sharded operator's
Krylov-vector gather is asynchronous (:func:`all_gather_start`), so its
owned-column product runs while the gather is in flight.

The JAX f32 solver reduced its node partials and dot partials with
``lax.psum``; these helpers all-gather the partials into a ``(D, ...)``
buffer and sum them in rank order on every rank instead. The result is
then bitwise the same on every rank whatever algorithm NCCL picks, which
the replicated node block and the bitwise pass-two replay need, and the
gather is tiny (D·p·4 bytes: 18 KB at p = 1,155 and 58 KB at p = 3,651 for
D = 4). The double-float fold is ``_df_fold_leading`` of
``two_pass_lanczos_tpu/parallel/fused_sharded_df.py``: an f32 sum of df
partials would re-round them to f32.

:data:`COLLECTIVES` counts the collectives run on this rank, by kind,
always, whether or not a log is open: one for each call of
:func:`all_gather` or :func:`all_gather_start`, so one for each
:func:`gather_fold`, :func:`df_gather_fold` and :func:`all_gather_arcs`.
A CUDA graph that holds collectives (``parallel/fused_sharded.py``) adds
at each replay what its capture counted, so a replayed solve counts what
the eager one does: the arc-sharded f32 two-pass solve of k steps with
its x gather counts 4k + 1 (‖b‖, three a step of pass one, one a step of
pass two's k − 1, the gather).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from two_pass_lanczos_tpu_torch.ops.df import DF, df_add
from two_pass_lanczos_tpu_torch.parallel.mesh import Mesh
from two_pass_lanczos_tpu_torch.utils.collectives import (
    record_call,
    record_event,
)

__all__ = ["all_gather", "all_gather_start", "PendingGather", "gather_fold",
           "df_gather_fold", "all_gather_arcs", "COLLECTIVES"]

# one flat all-gather into a preallocated buffer (gloo takes it flat):
# all_gather_single, or its older name where PyTorch predates it
_gather_flat = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor

#: collectives run on this rank, by kind (the module docstring)
COLLECTIVES = {"all-gather": 0, "all-gather-start": 0}


def _called(kind: str, out: torch.Tensor) -> None:
    """Count one collective and report it to the open logs."""
    COLLECTIVES[kind] += 1
    record_call(kind, out.dtype, out.shape)


def _flat(t: torch.Tensor) -> torch.Tensor:
    """``t`` flat, a complex tensor as its interleaved real view: NCCL has
    no complex type, and a gather moves the same bytes either way."""
    return (torch.view_as_real(t) if t.is_complex() else t).view(-1)


def all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``(D, *t.shape)``: row r is rank r's ``t`` (real or complex)."""
    t = t.contiguous()
    out = torch.empty((mesh.size,) + tuple(t.shape), dtype=t.dtype,
                      device=t.device)
    _gather_flat(_flat(out), _flat(t), group=mesh.group)
    _called("all-gather", out)
    return out


class PendingGather:
    """An all-gather in flight (:func:`all_gather_start`). :meth:`wait`
    returns its ``(D, *shape)`` buffer once the gather has landed; on a CUDA
    mesh the wait orders the current stream after NCCL's, without a host
    sync, so work queued before it may overlap the gather."""

    def __init__(self, out: torch.Tensor, work):
        self._out, self._work = out, work

    def wait(self) -> torch.Tensor:
        self._work.wait()
        record_event("all-gather-done")
        return self._out


def all_gather_start(t: torch.Tensor, mesh: Mesh) -> PendingGather:
    """Issue the all-gather of :func:`all_gather` with ``async_op=True``
    and return at once; recorded as ``"all-gather-start"``, its wait as
    ``"all-gather-done"``. The O(n) Krylov-vector gather of the row-sharded
    operator (``parallel/sharded.py``)."""
    t = t.contiguous()
    out = torch.empty((mesh.size,) + tuple(t.shape), dtype=t.dtype,
                      device=t.device)
    work = _gather_flat(_flat(out), _flat(t), group=mesh.group,
                        async_op=True)
    _called("all-gather-start", out)
    return PendingGather(out, work)


def gather_fold(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over ranks of ``t``, added in rank order: ((t_0 + t_1) + t_2)
    + ..., the same bits on every rank; ``t`` itself on one rank."""
    g = all_gather(t, mesh)
    acc = g[0]
    for r in range(1, mesh.size):
        acc = acc + g[r]
    return acc


def df_gather_fold(hi: torch.Tensor, lo: torch.Tensor, mesh: Mesh) -> DF:
    """The double-float sum over ranks of the pair ``(hi, lo)``: one gather
    of the stacked ``(2, ...)`` pair, folded with ``df_add`` in rank
    order."""
    g = all_gather(torch.stack([hi, lo]), mesh)
    acc = DF(g[0, 0], g[0, 1])
    for r in range(1, mesh.size):
        acc = df_add(acc, DF(g[r, 0], g[r, 1]))
    return acc


def all_gather_arcs(xa: torch.Tensor, sizes: Sequence[int],
                    mesh: Mesh) -> torch.Tensor:
    """The whole arc block from each rank's contiguous shard ``xa`` (its
    last axis; rank r holds ``sizes[r]`` arcs): every shard padded to the
    largest, gathered once, and the pads dropped, in arc order."""
    width = max(sizes)
    pad = torch.zeros(xa.shape[:-1] + (width - xa.shape[-1],),
                      dtype=xa.dtype, device=xa.device)
    g = all_gather(torch.cat([xa, pad], dim=-1), mesh)
    return torch.cat([g[r, ..., :sizes[r]] for r in range(mesh.size)],
                     dim=-1)
