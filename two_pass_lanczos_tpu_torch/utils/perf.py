"""Performance measurement: wall clock, host RSS, device memory, the card.

Counterpart of ``two_pass_lanczos_tpu/utils/perf.py``. ``get_peak_rss_kb``
reads ``VmPeak`` from ``/proc/self/status`` (the reference's
``src/utils/perf.rs:16-31``). Device memory is the CUDA caching
allocator's count of allocated bytes (``torch.cuda.memory_stats``), reset
per measurement with ``torch.cuda.reset_peak_memory_stats``, so a row's
device peak needs no process isolation. On the CPU the device functions
return ``{}`` and 0, as the JAX package's do on its CPU backend.
"""

from __future__ import annotations

import subprocess
import time
import warnings
from typing import Optional

import torch

__all__ = ["get_peak_rss_kb", "device_memory_stats", "Timer",
           "live_device_bytes", "reset_peak_memory", "card_description"]

_warned = False


def get_peak_rss_kb() -> int:
    """Peak resident set size (VmPeak) in KB; 0 on non-Linux platforms."""
    global _warned
    try:
        with open("/proc/self/status", "r") as fh:
            for line in fh:
                if line.startswith("VmPeak:"):
                    return int(line.split()[1])
    except OSError:
        pass
    if not _warned:
        warnings.warn("peak RSS unavailable on this platform; reporting 0",
                      stacklevel=2)
        _warned = True
    return 0


def _cuda(device) -> Optional[torch.device]:
    """``device`` as a CUDA device, None for the CPU; None means the
    current card when there is one."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    return dev if dev.type == "cuda" else None


def device_memory_stats(device=None) -> dict:
    """The caching allocator's statistics of a card
    (``torch.cuda.memory_stats``), with the allocated bytes also under the
    JAX package's names: ``peak_bytes_in_use`` (since the last
    :func:`reset_peak_memory`) and ``bytes_in_use``. ``{}`` on the CPU."""
    dev = _cuda(device)
    if dev is None:
        return {}
    stats = dict(torch.cuda.memory_stats(dev))
    stats["peak_bytes_in_use"] = stats.get("allocated_bytes.all.peak", 0)
    stats["bytes_in_use"] = stats.get("allocated_bytes.all.current", 0)
    return stats


def live_device_bytes(device=None) -> int:
    """Bytes of the tensors alive on a card (``memory_allocated``); 0 on
    the CPU."""
    dev = _cuda(device)
    return 0 if dev is None else int(torch.cuda.memory_allocated(dev))


def reset_peak_memory(device=None) -> None:
    """Start a new device peak (``peak_bytes_in_use``) on a card; nothing on
    the CPU, whose VmPeak never resets."""
    dev = _cuda(device)
    if dev is not None:
        torch.cuda.reset_peak_memory_stats(dev)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def synchronize(*outputs) -> None:
    """Wait for the cards that hold any tensor in ``outputs`` (tensors, or
    tuples, lists and dicts of them) to finish their queued work."""
    for dev in {t.device for t in _tensors(outputs) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def card_description(device=None) -> str:
    """``"<name>, <power limit>"`` of the card behind ``device`` as
    ``nvidia-smi --query-gpu=name,power.limit`` gives them (the name alone,
    with a note, where ``nvidia-smi`` cannot be run); ``"cpu"`` on the
    CPU."""
    dev = _cuda(device)
    if dev is None:
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={dev.index or 0}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return (f"{torch.cuda.get_device_name(dev)}, power limit not read "
                "(nvidia-smi failed)")


class Timer:
    """Wall-clock timer that waits for the card.

    Usage::

        with Timer() as t:
            y = fn(x)
            t.block_on(y)
        print(t.elapsed)

    ``block_on`` ends in ``torch.cuda.synchronize()`` for every card that
    holds one of its tensors.
    """

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def block_on(self, *arrays):
        synchronize(*arrays)

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False
