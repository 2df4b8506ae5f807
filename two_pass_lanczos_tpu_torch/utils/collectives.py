"""Collective-traffic record: what a distributed solve moves per step.

Counterpart of ``two_pass_lanczos_tpu/utils/collectives.py``. The JAX
package read the collectives out of the program XLA compiled (HLO or
lowered StableHLO text), where an instruction inside the scan's ``while``
body stands for one per step. PyTorch runs eagerly and writes no program
text, so the port records the calls themselves: every collective of the
sharded solvers goes through ``parallel/comm.py``, which reports each call
here while :func:`record_collectives` is open. A k-step solve then shows
each per-step collective k times (pass one) or k − 1 times (pass two), and
the final gather of x once.

``CollectiveOp`` and :func:`collective_bytes` keep the JAX package's names
and units: ``kind`` is XLA's (``"all-gather"``, or ``"all-gather-start"``
for an asynchronous gather), ``dtype`` its short name (``"f32"``, and
``"c64"``/``"c128"`` for a complex gather, 8 and 16 bytes an element),
``shape`` the gathered output with the rank axis first.

Besides the calls, a log keeps ``events``, the order of everything reported
to it: each call's kind, and markers that carry no bytes
(:func:`record_event`): an asynchronous gather's ``"all-gather-done"`` (its
``wait()``) and the sharded matvec's ``"owned-spmv"`` and ``"remote-spmv"``.
That order shows what a step computes while its gather is in flight, the
counterpart of the JAX package's check on the traced program's data flow.

A CUDA graph's capture runs no collective, so its calls go to a log of
their own (:func:`set_aside`) and not to the open logs; each replay then
reports them to the open logs (:func:`report_again`), in their order.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List

import torch

__all__ = ["CollectiveOp", "CollectiveLog", "record_collectives",
           "record_call", "record_event", "collective_bytes", "set_aside",
           "report_again"]

_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "bf16": 2, "f16": 2, "s16": 2,
                "u16": 2, "f32": 4, "s32": 4, "u32": 4, "f64": 8, "s64": 8,
                "u64": 8, "c64": 8, "c128": 16}
_DTYPE_NAMES = {torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
                torch.bfloat16: "bf16", torch.float16: "f16",
                torch.int16: "s16", torch.float32: "f32", torch.int32: "s32",
                torch.float64: "f64", torch.int64: "s64",
                torch.complex64: "c64", torch.complex128: "c128"}


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    kind: str  # e.g. "all-gather"
    dtype: str
    shape: tuple
    count: int

    @property
    def bytes_out(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n * _DTYPE_BYTES.get(self.dtype, 4) * self.count


class CollectiveLog:
    """The calls recorded by one :func:`record_collectives` block."""

    def __init__(self):
        #: ``(kind, dtype, shape)`` of every call, in call order
        self.calls: List[tuple] = []
        #: the kind of every call and marker, in order
        self.events: List[str] = []

    def ops(self) -> List[CollectiveOp]:
        """The calls grouped by ``(kind, dtype, shape)``, with their counts,
        sorted as the JAX package's parsers sort them."""
        found = {}
        for key in self.calls:
            found[key] = found.get(key, 0) + 1
        return [CollectiveOp(kind=k, dtype=d, shape=s, count=c)
                for (k, d, s), c in sorted(found.items())]


_open: List[CollectiveLog] = []


@contextlib.contextmanager
def record_collectives() -> Iterator[CollectiveLog]:
    """Record every collective helper call of ``parallel/comm.py`` made in
    the block (on this rank)::

        with record_collectives() as log:
            solver.solve(b, k=8)
        log.ops()  # [CollectiveOp("all-gather", "f32", (D, p), 15), ...]
    """
    log = CollectiveLog()
    _open.append(log)
    try:
        yield log
    finally:
        _open.remove(log)


@contextlib.contextmanager
def set_aside() -> Iterator[CollectiveLog]:
    """Record the block's calls and markers in a new log alone: the open
    logs take none of them, and are open again after the block."""
    saved = _open[:]
    _open[:] = []
    log = CollectiveLog()
    _open.append(log)
    try:
        yield log
    finally:
        _open[:] = saved


def report_again(log: CollectiveLog) -> None:
    """Report the calls and markers of ``log`` to every open log."""
    for into in _open:
        into.calls.extend(log.calls)
        into.events.extend(log.events)


def record_call(kind: str, dtype: torch.dtype, shape) -> None:
    """Report one collective call to every open :func:`record_collectives`."""
    if _open:
        key = (kind, _DTYPE_NAMES.get(dtype, str(dtype)), tuple(shape))
        for log in _open:
            log.calls.append(key)
            log.events.append(kind)


def record_event(kind: str) -> None:
    """Report a marker that moves no bytes (a gather's wait, a local
    product) to every open :func:`record_collectives`, in order."""
    for log in _open:
        log.events.append(kind)


def collective_bytes(ops: List[CollectiveOp], kinds=None) -> int:
    """Total output bytes across (optionally a subset of) collective ops."""
    return sum(o.bytes_out for o in ops
               if kinds is None or o.kind in kinds)
