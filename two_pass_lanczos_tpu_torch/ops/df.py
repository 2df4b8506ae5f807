"""Double-float (two-float) arithmetic on (hi, lo) f32 tensor pairs.

Counterpart of ``two_pass_lanczos_tpu/ops/df.py``, with the same functions
and the same operation order. A double-float value is the unevaluated sum
``hi + lo`` of two f32 tensors (~49-bit effective mantissa against f64's
53), computed with error-free transformations:

* ``two_sum``  — Knuth's branch-free exact addition;
* ``two_prod`` — compensated product via a 12-bit mantissa-mask split
  (every partial product of the split pieces is exact in f32);
* ``df_*``     — double-float add/mul/div/sqrt built on those (Dekker 1971,
  Bailey's ddfun conventions), and compensated reductions.

Eager PyTorch rounds after every operation and never contracts a product
into a sum, so no barrier is needed; nothing here uses ``addcmul`` or any
other fused operation. These functions are device-generic: on the CPU they
are the plain versions of the df kernels in ``csrc/df_*.cu``, which spell
the same transformations with explicit round-to-nearest intrinsics.

Representation: a pair ``(hi, lo)`` of equal-shape f32 tensors with
``|lo| <= ulp(hi)/2`` (normalized). f64 data is split exactly by
:func:`df_from_f64`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

__all__ = [
    "DF",
    "two_sum",
    "fast_two_sum",
    "two_prod",
    "df_from_f64",
    "df_to_f64",
    "df_zeros_like",
    "df_add",
    "df_add_f32",
    "df_sub",
    "df_neg",
    "df_mul",
    "df_mul_f32",
    "df_div",
    "df_sqrt",
    "df_sum",
    "df_dot",
    "df_norm",
]

Pair = Tuple[torch.Tensor, torch.Tensor]


class DF(NamedTuple):
    """A double-float value/tensor: the unevaluated exact sum ``hi + lo``."""

    hi: torch.Tensor
    lo: torch.Tensor


def two_sum(a, b) -> Pair:
    """Exact addition: returns (s, e) with s = fl(a+b) and a+b = s+e."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b) -> Pair:
    """Exact addition assuming |a| >= |b| (3 flops)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a: torch.Tensor) -> Pair:
    """Split ``a`` into a 12-bit-significand head and a ≤12-bit tail by
    masking the low 12 mantissa bits (integer ops, no rounding): every
    partial product of two heads or tails is exact in f32."""
    hi = torch.bitwise_and(a.view(torch.int32), -4096).view(torch.float32)
    return hi, a - hi


def two_prod(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """Compensated multiplication: returns (p, e) with p + e = a·b up to
    O(2⁻⁴⁸)·|a·b| (the two roundings in the tail recombination; all four
    partial products are exact — see :func:`_split`)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    p0 = ah * bh
    t1 = ah * bl
    t2 = al * bh
    r2 = al * bl
    s1, e1 = two_sum(t1, t2)
    s2, e2 = two_sum(p0, s1)
    return fast_two_sum(s2, (e1 + e2) + r2)


# ---------------------------------------------------------------------------
# Construction / conversion
# ---------------------------------------------------------------------------

def df_from_f64(x, device=None) -> DF:
    """Split f64 data exactly into a (hi, lo) f32 pair: ``hi = f32(x)``,
    ``lo = f32(x − hi)``. A tensor is split on its own device (or moved to
    ``device`` first); NumPy data is split on ``device``, the CPU if None."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.array(x, np.float64))
    if device is not None:
        t = t.to(device)
    t = t.to(torch.float64)
    hi = t.to(torch.float32)
    lo = (t - hi.to(torch.float64)).to(torch.float32)
    return DF(hi, lo)


def df_to_f64(x: DF) -> torch.Tensor:
    """Recombine to f64 on the pair's own device (for validation against
    the f64 oracle and for the host's projected solve)."""
    return x.hi.to(torch.float64) + x.lo.to(torch.float64)


def df_zeros_like(x) -> DF:
    z = torch.zeros_like(x.hi if isinstance(x, DF) else x)
    return DF(z, z)


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------

def df_add(x: DF, y: DF) -> DF:
    """Double-float addition (Knuth 2Sum based, ~20 flops)."""
    s, e = two_sum(x.hi, y.hi)
    t, f = two_sum(x.lo, y.lo)
    e = e + t
    s, e = fast_two_sum(s, e)
    e = e + f
    hi, lo = fast_two_sum(s, e)
    return DF(hi, lo)


def df_add_f32(x: DF, a) -> DF:
    s, e = two_sum(x.hi, a)
    e = e + x.lo
    hi, lo = fast_two_sum(s, e)
    return DF(hi, lo)


def df_neg(x: DF) -> DF:
    return DF(-x.hi, -x.lo)


def df_sub(x: DF, y: DF) -> DF:
    return df_add(x, df_neg(y))


def df_mul(x: DF, y: DF) -> DF:
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    hi, lo = fast_two_sum(p, e)
    return DF(hi, lo)


def df_mul_f32(x: DF, a) -> DF:
    p, e = two_prod(x.hi, a)
    e = e + x.lo * a
    hi, lo = fast_two_sum(p, e)
    return DF(hi, lo)


def df_div(x: DF, y: DF) -> DF:
    """Double-float division (one Newton correction on the f32 quotient)."""
    q1 = x.hi / y.hi
    r = df_add(x, df_neg(df_mul_f32(y, q1)))
    q2 = r.hi / y.hi
    r2 = df_add(r, df_neg(df_mul_f32(y, q2)))
    q3 = r2.hi / y.hi
    s, e = two_sum(q1, q2)
    e = e + q3
    hi, lo = fast_two_sum(s, e)
    return DF(hi, lo)


def df_sqrt(x: DF) -> DF:
    """Double-float square root (Karp–Markstein style correction).

    Domain: x > 0 (the Lanczos β² is positive until breakdown); a
    non-positive input gives (0, 0)."""
    safe_hi = torch.where(x.hi > 0, x.hi, torch.ones_like(x.hi))
    s = torch.sqrt(safe_hi)
    # residual r = x - s*s computed exactly, correction = r / (2s)
    p, e = two_prod(s, s)
    r = df_add(x, DF(-p, -e))
    c = r.hi / (2.0 * s)
    hi, lo = fast_two_sum(s, c)
    zero = torch.zeros_like(hi)
    pos = x.hi > 0
    return DF(torch.where(pos, hi, zero), torch.where(pos, lo, zero))


# ---------------------------------------------------------------------------
# Reductions (compensated)
# ---------------------------------------------------------------------------

def _df_pairwise_reduce(hi: torch.Tensor, lo: torch.Tensor) -> DF:
    """Log-depth pairwise df_add fold of all elements (any shape -> 0-d
    pair): each combine is a full double-float addition, so the reduction
    error is O(ε²·log m)."""
    hi = hi.reshape(-1)
    lo = lo.reshape(-1)
    m = hi.shape[0]
    # pad to a power of two with exact zeros
    size = 1 << max((m - 1).bit_length(), 0)
    if size != m:
        hi = torch.cat([hi, hi.new_zeros(size - m)])
        lo = torch.cat([lo, lo.new_zeros(size - m)])
    while hi.shape[0] > 1:
        h = hi.shape[0] // 2
        hi, lo = df_add(DF(hi[:h], lo[:h]), DF(hi[h:], lo[h:]))
    return DF(hi[0], lo[0])


def df_sum(x: DF, reduce_sum=None) -> DF:
    """Compensated sum of all elements; ``reduce_sum`` finishes a partial
    sum across processes (applied to hi and lo separately, then
    renormalized)."""
    s = _df_pairwise_reduce(x.hi, x.lo)
    if reduce_sum is not None:
        s = DF(reduce_sum(s.hi), reduce_sum(s.lo))
        s = DF(*fast_two_sum(s.hi, s.lo))
    return s


def df_dot(x: DF, y: DF, reduce_sum=None) -> DF:
    """Compensated inner product: elementwise df_mul then pairwise df_add."""
    return df_sum(df_mul(x, y), reduce_sum)


def df_norm(x: DF, reduce_sum=None) -> DF:
    return df_sqrt(df_dot(x, x, reduce_sum))
