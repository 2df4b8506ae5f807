"""Error-free transformations in plain PyTorch: the twin of the CUDA helpers
``two_sum``, ``two_prod`` and ``df_add2`` (``csrc/lanczos_common.cuh``) and
of the tripwire kernel K13 (``csrc/eft_check.cu``).

Counterpart of ``_two_sum_k``, ``_two_prod`` and ``_df_add2`` in
``two_pass_lanczos_tpu/ops/kkt_fused.py``. Eager PyTorch rounds after every
operation and never contracts, so the sums are written as in the kernel;
the product's rounding error is taken in f64, where an f32 product is exact.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["two_sum", "two_prod", "df_add2", "eft_check_plain", "EFT_ROWS"]

Pair = Tuple[torch.Tensor, torch.Tensor]

#: rows of the tripwire's output, in order
EFT_ROWS = ("two_sum_s", "two_sum_e", "two_prod_p", "two_prod_e",
            "df_add2_hi", "df_add2_lo")


def two_sum(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """``s + e == a + b`` exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def two_prod(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """``p + e == a * b`` exactly, for f32 ``a`` and ``b``."""
    p = a * b
    e = a.to(torch.float64) * b.to(torch.float64) - p.to(torch.float64)
    return p, e.to(a.dtype)


def df_add2(ah: torch.Tensor, al: torch.Tensor, bh: torch.Tensor,
            bl: torch.Tensor) -> Pair:
    """``(ah, al) + (bh, bl)`` as a renormalised two-float pair."""
    s = ah + bh
    bb = s - ah
    e = (ah - (s - bb)) + (bh - bb) + (al + bl)
    hi = s + e
    return hi, e - (hi - s)


def eft_check_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of K13: a ``(6, n)`` stack of ``two_sum(a, b)``,
    ``two_prod(a, a)`` and ``df_add2((a, 0), (b, 0))`` (rows ``EFT_ROWS``)."""
    zero = torch.zeros_like(a)
    return torch.stack([*two_sum(a, b), *two_prod(a, a),
                        *df_add2(a, zero, b, zero)])
