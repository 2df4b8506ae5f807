"""A test-only entry: the port's ``ShardedFusedKKTSolver``, two-pass, over
the harness's process group (gloo on the CPU), one rank a process.

``tiny.tiny_tree`` copies it into a tree's ``entries/`` as
``tiny_sharded.py``. It reads its environment:

* ``TINY_DIR``: where each rank writes the number of calls it has made
  (``calls.<rank>``), and a planted fault the time it struck (``fault``);
* ``TINY_FAULT``: a fault planted in rank ``TINY_FAULT_RANK`` (1 when
  unset): ``build`` raises in ``build``; ``window`` raises at the first
  call of the window and ``killed`` kills the process there; ``forbidden``
  loads a module named ``jax``; ``checksum`` changes b's first entry on
  that rank.
"""

from __future__ import annotations

import os
import signal
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from h100_bench.entries import Output

#: the first call of the window (after the traffic's 3 warm-up calls)
WINDOW_CALL = 4
_calls = 0


def _planted(fault: str) -> bool:
    """Whether ``fault`` strikes this rank now; if so, note its time."""
    if (os.environ.get("TINY_FAULT") != fault
            or dist.get_rank() != int(os.environ.get("TINY_FAULT_RANK", 1))):
        return False
    Path(os.environ["TINY_DIR"], "fault").write_text(repr(time.time()))
    return True


def _spoil_b() -> None:
    harness = sys.modules["h100_bench.harness"]
    draw = harness.Rhs.__call__

    def spoilt(self, i, stream=harness.WINDOW):
        b = draw(self, i, stream)
        b[0] += 1.0
        return b

    harness.Rhs.__call__ = spoilt


def build(instance, traffic, device):
    from two_pass_lanczos_tpu_torch.parallel import (
        ShardedFusedKKTSolver,
        make_mesh,
    )
    mesh = make_mesh(dist.get_world_size(), device=device)
    if _planted("build"):
        raise RuntimeError("a fault planted in build")
    if _planted("forbidden"):
        sys.modules["jax"] = types.ModuleType("jax")
    if _planted("checksum"):
        _spoil_b()
    return ShardedFusedKKTSolver(np.asarray(instance.quad_costs, np.float32),
                                 instance.arc_u, instance.arc_v,
                                 instance.num_nodes, mesh)


def solve(system, b, traffic) -> Output:
    global _calls
    _calls += 1
    if _calls == WINDOW_CALL and _planted("window"):
        raise RuntimeError("a fault planted in the window")
    if _calls == WINDOW_CALL and _planted("killed"):
        os.kill(os.getpid(), signal.SIGKILL)
    x, dec = system.solve(b, k=traffic["k"], f=traffic["f"],
                          method=traffic["method"])
    if "TINY_DIR" in os.environ:
        Path(os.environ["TINY_DIR"], f"calls.{dist.get_rank()}").write_text(
            str(_calls))
    return Output(x=torch.from_numpy(x), alphas=dec.alphas, betas=dec.betas,
                  steps=dec.steps_taken, b_norm=dec.b_norm)


def traced(system):
    return system


def counters() -> dict:
    return {}
