"""The comparison that decides ``correct``.

A checked solve's outputs are set against the plain reference's solve of
the same A and b. The numbers, each a worst case over the checked solves:

* ``steps_gap``: |steps taken − the reference's| (exact: limit 0);
* ``bnorm_gap``: |‖b‖ − the reference's| / the reference's: a wrong ‖b‖
  scales x by itself. No cell compares it yet: the TF32 control's ‖b‖
  lands near the program's on some seeds (PERF.md §2);
* ``ab_gap``: over the first :data:`AB_STEPS` steps, the larger of
  max |Δα_j| / max |α_j| and max |Δβ_j| / |β_j| (the reference's α and β
  below the bars). Only the first steps: an f32 recurrence without
  reorthogonalisation leaves f64's within a few hundred steps, by its
  nature (PERF.md §2);
* ``ritz_gap``: the extreme eigenvalues of T_k over all the steps taken,
  max(|Δθ_min|, |Δθ_max|) / max(|θ_min|, |θ_max|) (the reference's θ
  below the bar). The extremes converge within the first steps and stay
  put however the recurrence loses orthogonality, so this is the number
  that sees the later steps, which ``ab_gap`` leaves out;
* ``x_gap``: ‖x − x_ref‖ / ‖x_ref‖. At k = 500 it swings from seed to
  seed by the same forward instability (a median of 7 % at 500k arcs, a
  tail measured over 900 seeds, PERF.md §2), so its limit stands well
  above that tail and well below the control's.

A cell's limits file (``limits/<cell>.json``) maps each number it compares
to its limit; a number the outputs cannot give (the generic tier returns
x alone) is not compared there.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

#: the steps ``ab_gap`` reads: those on which an f32 recurrence still
#: follows f64's to rounding (α to ~5e-7 over 50 steps at k = 500, 4.5e-2
#: by step 200); clamped to the steps both sides took
AB_STEPS = 50


def _host(t) -> Optional[np.ndarray]:
    if t is None:
        return None
    return np.asarray(t.detach().cpu().double().numpy() if hasattr(
        t, "detach") else t, np.float64)


def host_output(out) -> dict:
    """An :class:`entries.Output` copied to the host in float64."""
    return {"x": _host(out.x), "alphas": _host(out.alphas),
            "betas": _host(out.betas), "steps": _host(out.steps),
            "b_norm": _host(out.b_norm)}


def ritz_ends(alphas: np.ndarray, betas: np.ndarray, steps: int):
    """The least and the largest eigenvalue of the ``steps`` × ``steps``
    tridiagonal T of ``alphas`` and ``betas``, in float64."""
    a = np.asarray(alphas[:steps], np.float64)
    b = np.asarray(betas[:steps - 1], np.float64)
    theta = np.linalg.eigvalsh(np.diag(a) + np.diag(b, 1) + np.diag(b, -1))
    return float(theta[0]), float(theta[-1])


def numbers(got: dict, ref) -> Dict[str, float]:
    """The comparison's numbers for one solve (``got`` from
    :func:`host_output`, ``ref`` the reference's ``Result`` for the same
    b)."""
    x = got["x"]
    out = {"x_gap": float(np.linalg.norm(x - ref.x)
                          / np.linalg.norm(ref.x))}
    if got.get("b_norm") is not None:
        out["bnorm_gap"] = float(abs(float(got["b_norm"]) - ref.b_norm)
                                 / ref.b_norm)
    if got["alphas"] is None:
        return out
    steps = int(got["steps"])
    out["steps_gap"] = float(abs(steps - ref.steps))
    lo, hi = ritz_ends(got["alphas"], got["betas"], max(steps, 1))
    lo_ref, hi_ref = ritz_ends(ref.alphas, ref.betas, max(ref.steps, 1))
    out["ritz_gap"] = (max(abs(lo - lo_ref), abs(hi - hi_ref))
                       / max(abs(lo_ref), abs(hi_ref)))
    j = max(min(AB_STEPS, steps, ref.steps), 1)
    da = np.abs(got["alphas"][:j] - ref.alphas[:j])
    a_gap = float(da.max() / np.abs(ref.alphas[:j]).max())
    b_gap = 0.0
    if j > 1:
        db = np.abs(got["betas"][:j - 1] - ref.betas[:j - 1])
        b_gap = float((db / np.abs(ref.betas[:j - 1])).max())
    out["ab_gap"] = max(a_gap, b_gap)
    return out


def within(value: float, limit: float) -> bool:
    """A number passes when it is finite and at most its limit."""
    return math.isfinite(value) and value <= limit


def judge(per_solve, limits: Dict[str, float]):
    """``(correct, failed, checks)`` over the checked solves' numbers:
    ``checks`` maps each compared number to its worst value and limit."""
    if not per_solve:
        return False, 0, {}
    failed = 0
    worst: Dict[str, float] = {}
    for nums in per_solve:
        missing = set(limits) - set(nums)
        if missing:
            raise KeyError(f"the outputs give no {sorted(missing)}")
        bad = False
        for name, limit in limits.items():
            v = nums[name]
            if not within(v, limit):
                bad = True
            w = worst.get(name)
            worst[name] = v if (w is None or not math.isfinite(v)
                                or v > w) else w
        failed += bad
    checks = {name: {"value": worst[name], "limit": limits[name]}
              for name in limits}
    return failed == 0, failed, checks
