"""Where the port's tensors live: on the card unless the caller asks for
the CPU.

Every entry point of the port (the solvers' constructors, the operators,
the loaders, ``load_decomposition``) takes ``device="cuda"`` by default and
resolves it here. Without a card a CUDA device raises: there is no silent
CPU route. The CPU runs the plain PyTorch versions of the kernels, and the
tests ask for it explicitly.
"""

from __future__ import annotations

import numbers

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "cpu_generator"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` for a CUDA
    device without a card and ``ValueError`` for anything but CUDA or CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(dev)!r} but torch.cuda.is_available() is False: "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def cpu_generator(key) -> torch.Generator:
    """The random stream of a keyed entry point (the JAX package takes a
    ``jax.random`` key there): a CPU ``torch.Generator`` as it is, or an
    ``int`` as the seed of a fresh one. Random numbers are drawn on the CPU
    and uploaded, so the CPU and the card see the same draws for the same
    seed; no global random state is read or written."""
    if isinstance(key, torch.Generator):
        if key.device.type != "cpu":
            raise ValueError(
                f"key must be a CPU torch.Generator, got one on {key.device}")
        return key
    if isinstance(key, numbers.Integral) and not isinstance(key, bool):
        return torch.Generator().manual_seed(int(key))
    raise TypeError(
        f"key must be a torch.Generator or an int seed, got {type(key)!r}")
