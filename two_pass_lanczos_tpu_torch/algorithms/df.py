"""Double-float Lanczos in plain PyTorch: near-f64 accuracy from f32 pairs.

Counterpart of ``two_pass_lanczos_tpu/algorithms/df.py``. The whole
recurrence — matvec, orthogonalization axpys, inner products, normalization
— runs in double-float arithmetic (:mod:`two_pass_lanczos_tpu_torch.ops.df`,
~49-bit effective mantissa), so the per-step rounding that the forward
instability of the three-term recurrence amplifies is ~2⁻⁴⁹ instead of
2⁻²⁴. The projected f(T_k)e₁ solve recombines (hi, lo) to f64 on the host.

Like ``algorithms/core.py`` the passes run a masked fixed-length loop: a
``done`` flag freezes the state after a breakdown (β_hi ≤ 1000·2⁻⁴⁹) and
``steps_taken`` counts the executed steps, with no host synchronisation.
Pass two replays pass one from the stored df α, β through the same update
routines (:func:`_sub_scaled`, :func:`_inverse`), so its regenerated basis
is bit-identical to pass one's in both the hi and the lo plane.

The passes are eager PyTorch around the operator's ``matvec_df``; on a card
:class:`DFKKTOperator` runs the df matvec kernel (K11,
``csrc/df_kkt_matvec.cu``). The fused kernels of the df tier (K9, K10) are
driven by ``ops/kkt_fused_df.DFFusedKKTSolver``, which runs these passes as
their plain versions on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.algorithms.core import zero_tolerance
from two_pass_lanczos_tpu_torch.devices import DEFAULT_DEVICE, resolve_device
from two_pass_lanczos_tpu_torch.functions import host_f_tk_solve
from two_pass_lanczos_tpu_torch.ops import eft
from two_pass_lanczos_tpu_torch.ops.df import (
    DF,
    df_add,
    df_div,
    df_dot,
    df_from_f64,
    df_mul,
    df_sqrt,
    df_sub,
    df_to_f64,
    df_zeros_like,
    two_prod,
)
from two_pass_lanczos_tpu_torch.ops.kkt_fused import KKTLayout

__all__ = [
    "DF_EPS",
    "df_breakdown_tolerance",
    "DFDiagonalOperator",
    "DFKKTOperator",
    "DFDecomposition",
    "lanczos_pass_one_df",
    "lanczos_standard_df",
    "lanczos_pass_two_df",
    "lanczos_pass_two_with_basis_df",
    "solve_fAb_df",
]

#: effective machine epsilon of a normalized double-float (2⁻⁴⁹).
DF_EPS = 2.0 ** -49
#: ‖b‖_hi at or below this is the zero vector (1000 · tiny of f32)
_ZTOL = zero_tolerance(torch.float32)
#: entries of one dense (p, K) segmented-sum table: 512 MB of int64
MAX_TABLE_ENTRIES = 1 << 26


def df_breakdown_tolerance() -> float:
    """1000·ε of the double-float format (the reference's 1000·ε rule,
    ``src/algorithms/mod.rs:140-143``, applied to the working precision)."""
    return 1000.0 * DF_EPS


def _host(a, dtype) -> np.ndarray:
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a, dtype)


def _f32_tensor(a, device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.array(a, np.float32))
    if t.dtype != torch.float32:
        raise ValueError(f"a (hi, lo) pair must be f32, got {t.dtype}")
    return t.to(device).contiguous()


def _as_pair(x, device) -> DF:
    """``x`` as a df pair on ``device``: a ``(hi, lo)`` tuple of f32 planes is
    taken as it is (never recombined: hi + lo need not be an f64 value);
    anything else is f64 data, split exactly on the device."""
    if isinstance(x, tuple):
        return DF(_f32_tensor(x[0], device), _f32_tensor(x[1], device))
    return df_from_f64(x, device)


def _as_df(b, device) -> DF:
    """A right-hand side as a df pair: a pair as it is, f64 data split, f32
    data with a zero lo plane (as the JAX ``_as_df``)."""
    if isinstance(b, tuple):
        return _as_pair(b, device)
    t = b if isinstance(b, torch.Tensor) else torch.from_numpy(np.asarray(b))
    if t.dtype == torch.float64:
        return df_from_f64(t, device)
    hi = t.to(device=device, dtype=torch.float32)
    return DF(hi, torch.zeros_like(hi))


def _where(cond: torch.Tensor, a: DF, b: DF) -> DF:
    return DF(torch.where(cond, a.hi, b.hi), torch.where(cond, a.lo, b.lo))


def _mask(x: DF, cond: torch.Tensor) -> DF:
    zero = torch.zeros((), dtype=x.hi.dtype, device=x.hi.device)
    return DF(torch.where(cond, x.hi, zero), torch.where(cond, x.lo, zero))


def _scalar(value: float, device) -> DF:
    return DF(torch.tensor(value, dtype=torch.float32, device=device),
              torch.zeros((), dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# Double-float operators
# ---------------------------------------------------------------------------

class DFDiagonalOperator:
    """Diagonal operator in double-float (the stability-scenario oracle
    problems, reference ``src/bin/stability.rs:98-157``)."""

    def __init__(self, diag: DF):
        self.diag = diag
        self.device = diag.hi.device

    @classmethod
    def from_f64(cls, diag, device=DEFAULT_DEVICE) -> "DFDiagonalOperator":
        return cls(_as_pair(diag, resolve_device(device)))

    @property
    def shape(self):
        n = self.diag.hi.shape[0]
        return (n, n)

    def matvec_df(self, x: DF) -> DF:
        return df_mul(self.diag, x)


def _node_table(key: np.ndarray, m: int, p: int, device) -> torch.Tensor:
    """(p, K) arc index per (node, slot), K the max degree rounded up to a
    power of two, padded with m (the zero pad slot)."""
    counts = np.bincount(key, minlength=p)
    k_max = max(int(counts.max()), 1)
    k_pad = 1 << (k_max - 1).bit_length()  # pow2: clean pairwise fold
    if p * k_pad > MAX_TABLE_ENTRIES:
        raise ValueError(
            f"DFKKTOperator.from_f64: dense segmented-sum table would be {p}"
            f" nodes x {k_pad} slots (max degree {k_max}) = {p * k_pad}"
            f" entries, over the {MAX_TABLE_ENTRIES}-entry cap. This"
            " hub-heavy topology needs a path without the table:"
            " ops.kkt_fused_df.DFFusedKKTSolver or"
            " parallel.DFShardedFusedKKTSolver on a card.")
    tab = np.full((p, k_pad), m, np.int64)
    order = np.argsort(key, kind="stable")
    ks = key[order]
    rank = np.arange(m) - np.concatenate([[0], np.cumsum(counts)])[:-1][ks]
    tab[ks, rank] = order
    return torch.from_numpy(tab).to(device)


class DFKKTOperator:
    """Structure-aware KKT operator ``[[D, Eᵀ], [E, 0]]`` in double-float.

    ``d`` is the (hi, lo) split of the f64 costs, or a ``(hi, lo)`` pair
    taken as it is. The arcs are held in the f32 solver's
    :class:`~two_pass_lanczos_tpu_torch.ops.kkt_fused.KKTLayout` (original
    order plus the node-sorted incidence CSR), the costs as one ``(2, m)``
    tensor ``d2``.

    * arc rows: ``y_a = d ⊗ x_a + (x_n[u] ⊖ x_n[v])`` — the exact product
      with its cross terms, then the df difference of the gathered pairs (a
      gather moves hi and lo unchanged), in the kernel's operation order;
    * node rows: ``y_n = E x_a`` — a compensated segmented sum. The plain
      version gathers the arc values into a dense ``(p, K)`` table per
      endpoint (K the max degree, host-built) and folds it pairwise with
      full df additions; the kernel folds each node's CSR segment.

    ``matvec_df`` runs K11 (``csrc/df_kkt_matvec.cu``, its pair instance)
    on a card and :meth:`plain_matvec_df`, its plain version, on the CPU.
    The tables are built at the first plain matvec (the fused solver on a
    card needs none); :meth:`from_f64` builds them at once, so that a
    hub-heavy topology is refused there, as in the JAX package.
    """

    def __init__(self, quad_costs, arc_u, arc_v, num_nodes,
                 device=DEFAULT_DEVICE):
        dev = resolve_device(device)
        d = _as_pair(quad_costs, dev)
        u, v = _host(arc_u, np.int64), _host(arc_v, np.int64)
        p = int(num_nodes)
        self.layout = KKTLayout.build(d.hi.cpu().numpy(), u, v, p, dev)
        self.d2 = torch.stack([d.hi, d.lo]).contiguous()
        self.d = DF(self.d2[0], self.d2[1])
        self.num_nodes = p
        self.device = dev
        self._u = self.layout.u.long()
        self._v = self.layout.v.long()
        self._tables = None

    @classmethod
    def from_f64(cls, quad_costs, arc_u, arc_v, num_nodes,
                 device=DEFAULT_DEVICE) -> "DFKKTOperator":
        op = cls(quad_costs, arc_u, arc_v, num_nodes, device=device)
        op.node_tables()
        return op

    def node_tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (p, K) arc-index tables of the tails and of the heads (built
        once; raises for a hub-heavy topology)."""
        if self._tables is None:
            m, p = self.layout.m, self.num_nodes
            self._tables = tuple(
                _node_table(e.cpu().numpy().astype(np.int64), m, p,
                            self.device)
                for e in (self.layout.u, self.layout.v))
        return self._tables

    @property
    def num_arcs(self) -> int:
        return self.layout.m

    @property
    def shape(self):
        n = self.layout.n
        return (n, n)

    @staticmethod
    def _segsum(xa_pad: DF, tab: torch.Tensor) -> DF:
        hi, lo = xa_pad.hi[tab], xa_pad.lo[tab]  # (p, K) exact gather
        k = hi.shape[1]  # power of two by construction (_node_table)
        while k > 1:
            h = k // 2
            hi, lo = df_add(DF(hi[:, :h], lo[:, :h]),
                            DF(hi[:, h:k], lo[:, h:k]))
            k = h
        return DF(hi[:, 0], lo[:, 0])

    def plain_matvec_df(self, x: DF) -> DF:
        """The plain version of K11, on any device."""
        tab_u, tab_v = self.node_tables()
        m = self.num_arcs
        xah, xal = x.hi[:m], x.lo[:m]
        xnh, xnl = x.hi[m:], x.lo[m:]
        # arc rows, in K11's order: exact product plus cross terms, then
        # the df difference of the gathered endpoint pairs
        ph, pe = eft.two_prod(self.d.hi, xah)
        pe = pe + (self.d.hi * xal + self.d.lo * xah)
        th, tl = eft.df_add2(xnh[self._u], xnl[self._u],
                             -xnh[self._v], -xnl[self._v])
        yah, yal = eft.df_add2(ph, pe, th, tl)
        # node rows: compensated segmented sums (pad slot m holds exact 0)
        zero = xah.new_zeros(1)
        xa_pad = DF(torch.cat([xah, zero]), torch.cat([xal, zero]))
        yn = df_sub(self._segsum(xa_pad, tab_u), self._segsum(xa_pad, tab_v))
        return DF(torch.cat([yah, yn.hi]), torch.cat([yal, yn.lo]))

    def matvec_df(self, x: DF) -> DF:
        """y = A·x: the pair K11 for CUDA planes (x stacked into (hi, lo)
        pairs, y split back), the plain version for CPU ones."""
        if not x.hi.is_cuda:
            return self.plain_matvec_df(x)
        # K11's wrapper sits beside the fused df solver, which imports this
        # module
        from two_pass_lanczos_tpu_torch.ops.kkt_fused_df import (
            df_kkt_matvec_pairs_cuda,
        )
        y = df_kkt_matvec_pairs_cuda(self.layout, self.d2,
                                     torch.stack([x.hi, x.lo], -1))
        return DF(y[:, 0], y[:, 1])


# ---------------------------------------------------------------------------
# Double-float Lanczos passes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DFDecomposition:
    """Pass-one output with double-float coefficients (padded to length k):
    ``alphas`` and ``betas`` are (k,) pairs, ``steps_taken`` an int32 0-d
    tensor, ``b_norm`` a 0-d pair."""

    alphas: DF
    betas: DF
    steps_taken: torch.Tensor
    b_norm: DF

    def steps(self) -> int:
        return int(self.steps_taken)

    def alphas_f64(self) -> np.ndarray:
        """α₁..α_steps recombined to f64 (for the projected solve/oracle)."""
        return df_to_f64(self.alphas).cpu().numpy()[: self.steps()]

    def betas_f64(self) -> np.ndarray:
        """β₁..β_{steps-1} recombined to f64."""
        return df_to_f64(self.betas).cpu().numpy()[: max(self.steps() - 1, 0)]


def _sub_scaled(w: DF, c: DF, x: DF) -> DF:
    """``w − c·x`` for a df scalar ``c``: both axpys of the update, in pass
    one and pass two alike."""
    return df_sub(w, df_mul(c, x))


def _inverse(beta: DF, keep: torch.Tensor) -> DF:
    """``1/β`` by ``df_div``, zero where ``keep`` is false (β_hi ≤ 0 is
    never divided by); ``v_next = w·(1/β)`` in both passes."""
    one = _scalar(1.0, beta.hi.device)
    safe = DF(torch.where(beta.hi > 0, beta.hi, one.hi), beta.lo)
    return _mask(df_div(one, safe), keep)


def _v1(b: DF, b_norm: DF) -> Tuple[DF, torch.Tensor]:
    """v₁ = b·(1/‖b‖) and the zero-b flag: a zero b (‖b‖_hi ≤ 1000·tiny)
    gives v₁ = 0, so pass two's x is 0 and never 0·∞ = NaN."""
    zero_b = b_norm.hi <= _ZTOL
    return df_mul(b, _inverse(b_norm, ~zero_b)), zero_b


def _pass_one_df(op, b: DF, k: int, emit_basis: bool, dot=df_dot):
    """k masked df steps from b: ``(DFDecomposition, basis or None,
    (v_prev, v_curr))``, basis row i = v_{i+1} when ``emit_basis``. ``dot``
    computes ‖b‖², α and β² as df pairs: ``df_dot``, or the sharded df
    solver's dot across ranks (``parallel/fused_sharded_df.py``). Pass two
    computes no inner product, so it takes no dot."""
    dev = b.hi.device
    tol = df_breakdown_tolerance()
    b_norm = df_sqrt(dot(b, b))
    vc, done = _v1(b, b_norm)
    vp = df_zeros_like(b)
    beta_prev = _scalar(0.0, dev)
    steps = torch.zeros((), dtype=torch.int32, device=dev)
    coeffs = torch.zeros((4, k), dtype=torch.float32, device=dev)
    basis = None
    if emit_basis:
        basis = DF(torch.zeros((k,) + b.hi.shape, device=dev),
                   torch.zeros((k,) + b.hi.shape, device=dev))
    for j in range(k):
        executed = ~done
        if emit_basis:
            # row = v_{j+1} (the vector entering this step), zeros once done
            row = _mask(vc, executed)
            basis.hi[j], basis.lo[j] = row.hi, row.lo
        w = op.matvec_df(vc)
        w = _sub_scaled(w, beta_prev, vp)
        alpha = dot(vc, w)
        w = _sub_scaled(w, alpha, vc)
        beta = df_sqrt(dot(w, w))
        breakdown = beta.hi <= tol
        advance = executed & ~breakdown
        a_out, b_out = _mask(alpha, executed), _mask(beta, advance)
        coeffs[0, j], coeffs[1, j] = a_out.hi, a_out.lo
        coeffs[2, j], coeffs[3, j] = b_out.hi, b_out.lo
        v_next = df_mul(w, _inverse(beta, advance))
        vp, vc = _where(advance, vc, vp), _where(advance, v_next, vc)
        beta_prev = _where(advance, beta, beta_prev)
        done = done | breakdown
        steps = steps + executed.to(torch.int32)
    dec = DFDecomposition(alphas=DF(coeffs[0], coeffs[1]),
                          betas=DF(coeffs[2], coeffs[3]), steps_taken=steps,
                          b_norm=b_norm)
    return dec, basis, (vp, vc)


def _pass_two_df(op, b: DF, decomp: DFDecomposition, y: DF,
                 emit_basis: bool):
    """Replay from the stored df α, β and accumulate x = Σ y_j v_j:
    ``(x, basis, (v_prev, v_curr))``. Step j (0 ≤ j < k−1) regenerates
    v_{j+2} and is a no-op unless j < steps_taken − 1."""
    dev = b.hi.device
    k = decomp.alphas.hi.shape[0]
    steps = decomp.steps_taken
    vc, _ = _v1(b, decomp.b_norm)
    vp = df_zeros_like(b)
    idx = torch.arange(k, device=dev)
    ym = _mask(y, idx < steps)
    x = df_mul(DF(ym.hi[0], ym.lo[0]), vc)
    basis = None
    if emit_basis:
        basis = DF(torch.zeros((k,) + b.hi.shape, device=dev),
                   torch.zeros((k,) + b.hi.shape, device=dev))
        basis.hi[0], basis.lo[0] = vc.hi, vc.lo
    zero = _scalar(0.0, dev)
    for j in range(k - 1):
        active = j < steps - 1
        beta_p = (DF(decomp.betas.hi[j - 1], decomp.betas.lo[j - 1])
                  if j > 0 else zero)
        alpha_j = DF(decomp.alphas.hi[j], decomp.alphas.lo[j])
        beta_j = DF(decomp.betas.hi[j], decomp.betas.lo[j])
        w = op.matvec_df(vc)
        w = _sub_scaled(w, beta_p, vp)
        w = _sub_scaled(w, alpha_j, vc)
        v_next = df_mul(w, _inverse(beta_j, active))
        x = df_add(x, df_mul(DF(ym.hi[j + 1], ym.lo[j + 1]), v_next))
        if emit_basis:
            row = _mask(v_next, active)
            basis.hi[j + 1], basis.lo[j + 1] = row.hi, row.lo
        vp, vc = _where(active, vc, vp), _where(active, v_next, vc)
    return x, basis, (vp, vc)


def lanczos_pass_one_df(operator, b, k: int) -> DFDecomposition:
    """Pass one entirely in double-float (O(n) memory, scalars kept).

    Same structure as ``core.pass_one_scan`` (masked fixed-length loop,
    reference op order ``src/algorithms/mod.rs:167-212``), every operation
    replaced by its error-free-compensated counterpart.
    """
    if k < 1:
        raise ValueError("k must be >= 1")
    dec, _, _ = _pass_one_df(operator, _as_df(b, operator.device), k, False)
    return dec


def lanczos_standard_df(operator, b, k: int):
    """One-pass in double-float: ``(DFDecomposition, basis)`` with
    ``basis`` a DF pair of shape (k, n), row i = v_{i+1} (the O(nk)
    variant — reference ``src/algorithms/lanczos.rs:55-156`` — at df
    precision)."""
    if k < 1:
        raise ValueError("k must be >= 1")
    dec, basis, _ = _pass_one_df(operator, _as_df(b, operator.device), k,
                                 True)
    return dec, basis


def _y_df(y_f64, k: int, device) -> DF:
    """A length-≤k f64 y, zero-padded to k and split."""
    yv = _host(y_f64, np.float64)
    y = np.zeros(k)
    y[: len(yv)] = yv
    return df_from_f64(y, device)


def lanczos_pass_two_df(operator, b, decomp: DFDecomposition, y_f64) -> DF:
    """Pass two in double-float: replay from the stored df β (never
    recomputing inner products — the reference's bit-faithful-replay
    design, ``src/algorithms/lanczos_two_pass.rs:176-199``, at df
    precision). ``y_f64`` (length ≤ k, f64) is split exactly."""
    b = _as_df(b, operator.device)
    k = decomp.alphas.hi.shape[0]
    x, _, _ = _pass_two_df(operator, b, decomp,
                           _y_df(y_f64, k, operator.device), False)
    return x


def lanczos_pass_two_with_basis_df(operator, b, decomp: DFDecomposition,
                                   y_f64):
    """df pass two that also returns the regenerated basis as a DF pair of
    shape (k, n), rows beyond ``steps_taken`` zero (the test-only
    capability of reference ``lanczos_pass_two_with_basis``)."""
    b = _as_df(b, operator.device)
    k = decomp.alphas.hi.shape[0]
    x, basis, _ = _pass_two_df(operator, b, decomp,
                               _y_df(y_f64, k, operator.device), True)
    return x, basis


def solve_fAb_df(operator, b, *, k: int, f="inv",
                 method: str = "two_pass") -> torch.Tensor:
    """f(A)·b in double-float; returns x as an f64 tensor (hi + lo
    recombined) on the operator's device.

    ``method`` ∈ {"one_pass", "two_pass"}. The projected k×k solve runs on
    the host in f64 (tiny), as the reference hands f64 (α, β) to the user
    closure.
    """
    if method == "one_pass":
        decomp, basis = lanczos_standard_df(operator, b, k)
    elif method == "two_pass":
        decomp = lanczos_pass_one_df(operator, b, k)
        basis = None
    else:
        raise ValueError(f"unknown method {method!r}")
    steps = decomp.steps()
    dev = operator.device
    if steps == 0:
        return torch.zeros(operator.shape[0], dtype=torch.float64, device=dev)
    y = host_f_tk_solve(decomp.alphas_f64(), decomp.betas_f64(), f)
    b_norm = float(df_to_f64(decomp.b_norm))
    if method == "one_pass":
        y_full = np.zeros(decomp.alphas.hi.shape[0])
        y_full[:steps] = y * b_norm
        return df_to_f64(_gemv_df(basis, df_from_f64(y_full, dev)))
    return df_to_f64(lanczos_pass_two_df(operator, b, decomp, y * b_norm))


def _gemv_df(basis: DF, y: DF) -> DF:
    """x = Vᵀ·y in double-float: elementwise df products, pairwise df fold
    over the k axis (basis stored (k, n))."""
    ph, pe = two_prod(basis.hi, y.hi[:, None])
    pe = pe + (basis.hi * y.lo[:, None] + basis.lo * y.hi[:, None])
    h, l = ph, pe
    r = h.shape[0]
    xh: Optional[torch.Tensor] = None
    xl: Optional[torch.Tensor] = None
    while r > 1:
        if r % 2:
            if xh is None:
                xh, xl = h[r - 1:r], l[r - 1:r]
            else:
                xh, xl = df_add(DF(xh, xl), DF(h[r - 1:r], l[r - 1:r]))
            r -= 1
        half = r // 2
        h, l = df_add(DF(h[:half], l[:half]), DF(h[half:r], l[half:r]))
        r = half
    if xh is not None:
        h, l = df_add(DF(h, l), DF(xh, xl))
    return DF(h[0], l[0])
