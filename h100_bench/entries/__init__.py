"""Entry points of the program under test, one file each, found by the
name a traffic mix gives under ``entry``.

An entry module has ``build(instance, traffic, device)``, which builds the
system under test from the instance's arrays, ``solve(system, b,
traffic)``, which makes one call as the traffic says and returns an
:class:`Output`, ``traced(system)``, the system with the harness's spans
around the calls into its layers (only the traced stretch uses it), and
``counters()``, a snapshot of the program's counters.

In a cell of D > 1 cards the same module runs in every rank, one process
a card, once the harness's process group is up (so the program's own mesh,
``make_mesh(D)``, finds it): ``build`` runs on every rank with that rank's
card, ``solve`` is called on every rank in the same order with the same b
(drawn on each card), rank 0's :class:`Output` is the one checked, and
``counters()`` are rank 0's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Output:
    """What one call produced, as the program returned it (device
    tensors); the decomposition's parts are None where the entry does not
    return them."""

    x: torch.Tensor
    alphas: Optional[torch.Tensor] = None
    betas: Optional[torch.Tensor] = None
    steps: Optional[torch.Tensor] = None
    b_norm: Optional[torch.Tensor] = None
