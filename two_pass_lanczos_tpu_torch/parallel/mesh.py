"""Process groups for the sharded solvers: ``torch.distributed`` in place of
a JAX mesh.

Counterpart of ``two_pass_lanczos_tpu/parallel/mesh.py``. A JAX mesh is a
set of devices that one program drives; under ``torch.distributed`` each
process drives one device, so a :class:`Mesh` is a process group and this
process's rank in it. Its parallelism is the same 1-D partition over the
``"rows"`` axis.

* A CUDA mesh takes NCCL, a CPU mesh gloo (which has no ``all_gather`` for
  CUDA tensors). A mismatch raises; nothing falls back to the other.
* NCCL refuses two ranks on one GPU, so one card holds a one-rank mesh:
  without a distributed run, ``make_mesh(1)`` forms that one-rank group on
  the spot, with an in-process store.
* A multi-rank run starts one process per rank (``torchrun``, or by hand
  with ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` set, or
  an explicit ``init_method`` such as ``file:///shared/store``) and calls
  :func:`initialize_distributed` or :func:`make_mesh` in each.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from two_pass_lanczos_tpu_torch.devices import DEFAULT_DEVICE, resolve_device

__all__ = ["Mesh", "make_mesh", "initialize_distributed", "BACKENDS"]

DEFAULT_AXIS = "rows"
#: the process-group backend of each device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ``size`` ranks: the process group of its collectives,
    this process's ``rank`` in it and the ``device`` it drives."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis: str = DEFAULT_AXIS

    @property
    def backend(self) -> str:
        return BACKENDS[self.device.type]


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def _bind_device(dev: torch.device, rank: int) -> torch.device:
    """The CUDA device this rank drives (``LOCAL_RANK``, else rank modulo
    the cards), made current; a CPU device as it is."""
    if dev.type != "cuda":
        return dev
    if dev.index is None:
        local = _int_env("LOCAL_RANK")
        dev = torch.device("cuda", (rank if local is None else local)
                           % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           device=DEFAULT_DEVICE) -> bool:
    """Join the default process group of a multi-process run.

    Arguments default to the variables ``torchrun`` sets (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); ``init_method`` defaults to
    ``tcp://MASTER_ADDR:MASTER_PORT``. The backend follows ``device``:
    NCCL for CUDA, gloo for the CPU. Returns True once the group is up (at
    once if it already is), False when there is nothing to initialise (no
    ``init_method``, no ``MASTER_ADDR`` and no ``WORLD_SIZE``).
    """
    if dist.is_initialized():
        return True
    addr = os.environ.get("MASTER_ADDR")
    world_size = world_size if world_size is not None else _int_env(
        "WORLD_SIZE")
    rank = rank if rank is not None else _int_env("RANK")
    if init_method is None and addr is None and world_size is None:
        return False
    if world_size is None or rank is None:
        raise ValueError("a distributed run needs its world size and rank "
                         "(arguments, or WORLD_SIZE and RANK)")
    if init_method is None:
        port = os.environ.get("MASTER_PORT")
        if addr is None or port is None:
            raise ValueError("init_method, or MASTER_ADDR and MASTER_PORT, "
                             "must name the rendezvous")
        init_method = f"tcp://{addr}:{port}"
    dev = _bind_device(resolve_device(device), rank)
    dist.init_process_group(BACKENDS[dev.type], init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def make_mesh(n_devices: Optional[int] = None, axis: str = DEFAULT_AXIS,
              device=DEFAULT_DEVICE) -> Optional[Mesh]:
    """1-D mesh over the first ``n_devices`` ranks (default: all).

    Joins the run of :func:`initialize_distributed` when none is up; with
    no distributed run, a one-rank group on this process (``n_devices`` 1
    or None). Raises ``ValueError`` when more ranks are asked for than the
    run has, or when the run's backend is not the device's (NCCL for CUDA,
    gloo for the CPU), and ``RuntimeError`` for a CUDA device without a
    card or an NCCL group that cannot be formed. A rank past ``n_devices``
    holds no part of the mesh and gets None.
    """
    dev = resolve_device(device)
    backend = BACKENDS[dev.type]
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("a CUDA mesh needs NCCL, which this PyTorch lacks")
    if not dist.is_initialized() and not initialize_distributed(device=dev):
        if n_devices not in (None, 1):
            raise ValueError(
                f"requested {n_devices} devices, have 1: start one process "
                "per rank (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)")
        _bind_device(dev, 0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    have = dist.get_backend()
    if have != backend:
        raise ValueError(f"a {dev.type} mesh needs {backend}, but the "
                         f"process group runs {have}")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"requested {n} devices, have {world}")
    rank = dist.get_rank()
    dev = _bind_device(dev, rank)
    # new_group is collective: every rank of the run calls it
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        return None
    return Mesh(group=group, rank=rank, size=n, device=dev, axis=axis)
