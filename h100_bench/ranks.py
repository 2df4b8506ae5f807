"""A cell on D > 1 cards, run as D processes, one a card.

The process started as ``run.py`` is rank 0. :meth:`Ranks.launch` picks a
free localhost port, starts D − 1 more ``run.py`` processes with the same
arguments (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` in their environment, and :data:`ENV_PARENT`, rank 0's pid,
which makes them ranks), serves a TCP store on that port and joins one
process group with them over it: NCCL on cards, gloo on the CPU. Rank r
drives ``cuda:r``. The pattern is the port's ``tools/_spawn.py``: each
rank's stdout and stderr go to files (a full pipe would stall a rank
inside a collective, and only rank 0 writes the result line), one
deadline, every rank killed at a fault.

No hang: a watchdog thread in rank 0 polls the other ranks every
:data:`POLL_S` seconds. When one has exited with a code other than 0, or
the deadline has passed, it kills every rank, names the fault and the end
of the failed rank's standard error on its own, and ends rank 0 with exit
code 3 and no result, within :data:`FAULT_S` seconds of the fault. A
fault that rank 0 reads from the ranks' readings (b's checksums differ,
the counts of calls differ, a forbidden module) ends the run the same way,
and so does an exception in rank 0. Each other rank dies with rank 0
(``PR_SET_PDEATHSIG``), and the group's timeout ends a collective that
waits on a rank that never comes.

This module imports torch and no module of the port.
"""

from __future__ import annotations

import ctypes
import datetime
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

#: rank 0's pid, in the environment of every other rank
ENV_PARENT = "H100_BENCH_PARENT"
ADDR = "127.0.0.1"
#: the process-group backend of each device type (as the port's mesh)
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
#: how often rank 0 looks at the other ranks
POLL_S = 0.2
#: the bound, in seconds, from a rank's fault to rank 0's exit
FAULT_S = 5.0
#: set-up's deadline and the group's timeout: a checkout's first run
#: builds the kernel library in every rank
SETUP_S = 1100.0
#: the deadline past the window's length, for the traced stretch, the
#: readings' exchange and freeing each rank's state
WINDOW_SLACK_S = 300.0
#: characters of a failed rank's standard error that rank 0 repeats
TAIL_CHARS = 1500


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind((ADDR, 0))
        return s.getsockname()[1]


def checksum(t: torch.Tensor) -> int:
    """A checksum of ``t``'s bits: each 32-bit word weighted by its index
    + 1, summed in int64 (wrapping): equal bits give equal sums."""
    bits = t.detach().contiguous().view(torch.int32).reshape(-1).long()
    weights = torch.arange(1, bits.numel() + 1, dtype=torch.int64,
                           device=bits.device)
    return int((bits * weights).sum())


def fold(readings: Sequence[Sequence[int]], names: Sequence[str]) -> dict:
    """Fold each rank's ``(setup peak, window peak, calls, forbidden
    mask)`` into the run's: the fullest card's window peak and its peak
    over set-up and window, the calls of each rank and whether they agree,
    and the forbidden modules (``names`` by bit) each rank loaded."""
    setup = [int(r[0]) for r in readings]
    window = [int(r[1]) for r in readings]
    calls = [int(r[2]) for r in readings]
    loaded = {rank: [n for bit, n in enumerate(names) if int(r[3]) >> bit & 1]
              for rank, r in enumerate(readings) if int(r[3])}
    return {"window_peak": max(window),
            "memory_peak": max(max(s, w) for s, w in zip(setup, window)),
            "setup_peaks": setup, "window_peaks": window, "calls": calls,
            "same_calls": len(set(calls)) == 1, "forbidden": loaded}


def fault_of(folded: dict) -> Optional[str]:
    """What the folded readings show to be wrong with the run, or None."""
    if folded["forbidden"]:
        return "; ".join(f"rank {r} loaded {', '.join(names)}"
                         for r, names in sorted(folded["forbidden"].items()))
    if not folded["same_calls"]:
        return f"the ranks made different numbers of calls: {folded['calls']}"
    return None


def _die_with_parent(parent: int) -> None:
    """Have the kernel kill this process when rank 0 ends (Linux), and
    leave at once where it already has."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, signal.SIGKILL, 0, 0, 0)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(4)


class Ranks:
    """The process group of a D-rank run, as one rank sees it. Rank 0 also
    holds the other ranks' processes and the watchdog."""

    def __init__(self, rank: int, world: int, device: torch.device):
        self.rank, self.world, self.device = rank, world, device
        self.procs: List[subprocess.Popen] = []
        self.logs: Optional[Path] = None
        self.deadline = time.monotonic() + SETUP_S
        self.joined = 0.0  # perf_counter when the group was up
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.store = None

    # -- forming the group ------------------------------------------------
    @classmethod
    def launch(cls, world: int, script: Path, argv: Sequence[str],
               device_type: str) -> "Ranks":
        """Rank 0: start ranks 1 … world − 1 as ``python script *argv``,
        watch them, and join the group."""
        port = free_port()
        self = cls(0, world, _device(device_type, 0))
        self.logs = Path(tempfile.mkdtemp(prefix="h100_bench_ranks_"))
        try:
            for r in range(1, world):
                env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                           LOCAL_RANK=str(r), MASTER_ADDR=ADDR,
                           MASTER_PORT=str(port),
                           **{ENV_PARENT: str(os.getpid())})
                with open(self.logs / f"rank{r}.out", "w") as out, \
                        open(self.logs / f"rank{r}.err", "w") as err:
                    self.procs.append(subprocess.Popen(
                        [sys.executable, str(script), *argv], env=env,
                        stdout=out, stderr=err, stdin=subprocess.DEVNULL))
            print("ranks spawned " + " ".join(str(p.pid) for p in self.procs),
                  file=sys.stderr, flush=True)
            threading.Thread(target=self._watch, name="h100_bench-watchdog",
                             daemon=True).start()
            self._join(port)
        except BaseException:
            self._stop.set()
            self.kill()
            shutil.rmtree(self.logs, ignore_errors=True)
            raise
        return self

    @classmethod
    def from_env(cls, device_type: str) -> "Ranks":
        """Ranks 1 … D − 1: join the group that the environment names."""
        _die_with_parent(int(os.environ[ENV_PARENT]))
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        self = cls(rank, world, _device(device_type, rank))
        self._join(int(os.environ["MASTER_PORT"]))
        return self

    def _join(self, port: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        timeout = datetime.timedelta(seconds=SETUP_S)
        # rank 0 serves the store: the group's rendezvous and the window's
        # go-ahead for each call
        self.store = dist.TCPStore(ADDR, port, self.world, self.rank == 0,
                                   timeout)
        dist.init_process_group(BACKENDS[self.device.type], store=self.store,
                                world_size=self.world, rank=self.rank,
                                timeout=timeout)
        self.barrier()  # NCCL forms its communicator here, inside set-up
        self.joined = time.perf_counter()

    # -- the harness's collectives -----------------------------------------
    def barrier(self) -> None:
        if self.device.type == "cuda":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def flag(self, call: int, go: bool) -> bool:
        """Whether call ``call`` is made: rank 0's ``go``, on every rank.
        Rank 0 writes it to the store and goes on; the other ranks wait
        for it. Rank 0 never waits here for another rank, so a rank that
        ends a call later holds up rank 0's next call, on its clock."""
        key = f"h100_bench/go/{call}"
        if self.rank == 0:
            self.store.set(key, "1" if go else "0")
            return go
        return self.store.get(key) == b"1"

    def gather(self, values: Sequence[int]) -> List[List[int]]:
        """Every rank's ``values`` (ints), in rank order, on every rank."""
        t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                         device=self.device)
        out = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(out, t)
        return [o.tolist() for o in out]

    # -- ending -------------------------------------------------------------
    def leave(self) -> None:
        """Every rank, once its state is freed: the final barrier, then
        out of the group."""
        self.barrier()
        dist.destroy_process_group()

    def close(self) -> None:
        """Rank 0, once it has left the group: wait for the other ranks,
        each of which has to exit with 0, and stop watching."""
        for r, p in enumerate(self.procs, 1):
            try:
                code = p.wait(timeout=max(self.deadline - time.monotonic(),
                                          POLL_S))
            except subprocess.TimeoutExpired:
                self.abort(f"rank {r} did not exit by the deadline")
            if code != 0:
                self.abort(f"rank {r} exited with code {code}")
        self._stop.set()
        shutil.rmtree(self.logs, ignore_errors=True)

    def kill(self) -> None:
        """Kill every other rank still running and wait for each."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def abort(self, why: str) -> None:
        """Rank 0: kill every other rank, say why on standard error with
        each rank that had already failed and the end of its standard
        error, and exit with 3 and no result."""
        with self._lock:
            self._stop.set()
            codes = {r: p.poll() for r, p in enumerate(self.procs, 1)}
            failed = {r: c for r, c in codes.items() if c not in (None, 0)}
            self.kill()
            lines = [f"ranks: {why}: no result"]
            for r, code in failed.items():
                err = self.logs / f"rank{r}.err"
                tail = err.read_text(errors="replace")[-TAIL_CHARS:] \
                    if err.is_file() else ""
                lines.append(f"--- rank {r} had exited with code {code}; "
                             f"the end of its standard error:\n{tail}")
            print("\n".join(lines), file=sys.stderr, flush=True)
            sys.stdout.flush()
            shutil.rmtree(self.logs, ignore_errors=True)
            os._exit(3)

    def _watch(self) -> None:
        while not self._stop.wait(POLL_S):
            for r, p in enumerate(self.procs, 1):
                code = p.poll()
                if code is not None and code != 0:
                    self.abort(f"rank {r} exited with code {code}")
            if time.monotonic() > self.deadline:
                self.abort("the run passed its deadline")


def _device(device_type: str, rank: int) -> torch.device:
    return torch.device("cuda", rank) if device_type == "cuda" \
        else torch.device(device_type)
