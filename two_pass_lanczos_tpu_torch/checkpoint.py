"""Checkpoint/resume for the two-pass pipeline.

Counterpart of ``two_pass_lanczos_tpu/checkpoint.py``, in the **same
``.npz`` format, version 1**: a decomposition saved by either package loads
in the other. Pass one can run in one job, the decomposition (a few KB of
scalars) be saved, and pass two resume later or elsewhere; pass two is a
pure replay of the stored coefficients.

Bit-fidelity caveat, as in the JAX package: the replay is bit-identical to
pass one only when pass two runs on the same operator layout and the same
build. Across packages or devices the resumed pass two is still a correct
reconstruction, but agreement is at rounding tolerance rather than bitwise.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.algorithms.core import LanczosDecomposition
from two_pass_lanczos_tpu_torch.devices import DEFAULT_DEVICE, resolve_device

__all__ = ["save_decomposition", "load_decomposition"]

_FORMAT_VERSION = 1


def _npz_path(path) -> Path:
    # np.savez silently appends ".npz" to extension-less paths while np.load
    # opens the literal path; normalize so save/load always agree.
    path = Path(path)
    return path if path.suffix == ".npz" else path.with_suffix(
        path.suffix + ".npz")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_decomposition(path, decomposition: LanczosDecomposition) -> None:
    """Serialize a decomposition to ``.npz`` (portable, dtype-preserving)."""
    np.savez(
        _npz_path(path),
        alphas=_host(decomposition.alphas),
        betas=_host(decomposition.betas),
        steps_taken=_host(decomposition.steps_taken),
        b_norm=_host(decomposition.b_norm),
        meta=json.dumps({"version": _FORMAT_VERSION}),
    )


def load_decomposition(path, device=DEFAULT_DEVICE) -> LanczosDecomposition:
    """Load a decomposition saved by either package, onto ``device`` (the
    card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    with np.load(_npz_path(path), allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("version") != _FORMAT_VERSION:
            raise ValueError(f"unsupported decomposition format: {meta}")

        def t(name):
            return torch.from_numpy(np.array(z[name])).to(device)

        return LanczosDecomposition(
            alphas=t("alphas"), betas=t("betas"),
            steps_taken=t("steps_taken").to(torch.int32).reshape(()),
            b_norm=t("b_norm").reshape(()),
        )
