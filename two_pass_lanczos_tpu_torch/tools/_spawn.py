"""Start the ranks of a tool: one ``python -m <module>`` process per rank.

Each rank's stdout and stderr go to files (a full pipe would stall a rank
inside a collective), every process is waited for up to one shared
deadline, and any still running then is killed: the caller gets every
rank's exit code and output, and no process outlives the call.
"""

from __future__ import annotations

import contextlib
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, List, NamedTuple, Sequence

#: the directory that holds the package, for the ranks' ``-m``
ROOT = Path(__file__).resolve().parents[2]


class RankResult(NamedTuple):
    returncode: int  # negative: killed at the deadline
    stdout: str
    stderr: str


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(module: str, world: int,
                args_of: Callable[[int], Sequence[str]],
                timeout: float) -> List[RankResult]:
    """Run ``python -m module *args_of(rank)`` for each rank of ``world``
    at once and wait for all of them, at most ``timeout`` seconds."""
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=str(ROOT) + (
        os.pathsep + path if path else ""))
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as st:
        files, procs = [], []
        try:
            for r in range(world):
                out = st.enter_context(open(Path(tmp) / f"rank{r}.out", "w+"))
                err = st.enter_context(open(Path(tmp) / f"rank{r}.err", "w+"))
                files.append((out, err))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", module, *map(str, args_of(r))],
                    env=env, stdout=out, stderr=err))
            end = time.monotonic() + timeout
            for p in procs:
                try:
                    p.wait(timeout=max(end - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    break
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        results = []
        for p, (out, err) in zip(procs, files):
            out.seek(0)
            err.seek(0)
            results.append(RankResult(p.returncode, out.read(), err.read()))
        return results
