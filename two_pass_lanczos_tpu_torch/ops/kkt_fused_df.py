"""Fused two-pass Lanczos in double-float, on hand-written CUDA kernels.

Counterpart of ``two_pass_lanczos_tpu/ops/kkt_fused_df.py``: the whole
recurrence — matvec (exact-product diagonal term, exact hi/lo gathers,
compensated segmented-sum scatter), orthogonalization axpys, inner
products, normalization — runs in double-float (hi, lo) f32 pairs, so the
coefficients track an f64 run to ~1e-14 relative where plain f32 leaves it
within a few steps (on the 500k-arc headline, until forward instability
parts every pair of precisions past ~140 steps).

The TPU kernels held both sorted arc orderings in VMEM with 128-lane
padding and 256-node scatter windows; the port keeps the f32 solver's
Hopper layout (:class:`~two_pass_lanczos_tpu_torch.ops.kkt_fused.KKTLayout`:
arcs in their original order plus a node-sorted incidence CSR) with the
costs as a ``(2, m)`` hi/lo tensor. A df vector at the Python boundary is
one ``(2, n)`` tensor, hi plane first ("planar"). A vector that a kernel
gathers from is ``(n, 2)``, (hi, lo) pairs: one 8-byte load and one L2
sector an entry, where the planes take two. The kernels
(``csrc/df_*.cu``):

* K11 ``df_kkt_matvec.cu`` — one df ``y = A·x``, planar
  (:func:`df_kkt_matvec`; the per-step references launch this instance)
  and on pairs (:func:`df_kkt_matvec_pairs_cuda`, ``DFKKTOperator``'s on a
  card), bitwise equal;
* K9 ``df_lanczos_pass_one.cu`` — pass one, α, β and ‖b‖ as df pairs; its
  w halves, v_prev and v_curr are pairs in its scratch;
* K10 ``df_lanczos_pass_two.cu`` — the replay from the stored df β and the
  df accumulation of x; its hi and lo basis are bitwise pass one's; its
  v_prev, v_curr and x are pairs in its scratch;
* K12 ``df_kkt_shard_matvec.cu`` — one shard's df matvec with its df node
  partial, on pairs (:func:`df_kkt_shard_matvec`), for the sharded df
  solver (``parallel/fused_sharded_df.py``).

b comes in planar and x and the final state go out planar: K9 and K10 read
and write the planes once a pass, never a copy a step.

K9 and K10 are each ONE persistent cooperative launch
(``csrc/lanczos_persistent.cuh``, as K2 and K3) that runs K11's rows as a
phase of every step. The per-step launches they replaced stay as their
bitwise reference, :func:`df_pass_one_steps_cuda` and
:func:`df_pass_two_steps_cuda`, which only ``chip_smoke.py`` and the card
tests call: no solve reaches them, and a refused cooperative launch raises.

Each wrapper launches its kernel for CUDA tensors and raises on anything it
does not take; on the CPU the solver runs the plain versions,
``algorithms/df.py``'s passes over ``DFKKTOperator.plain_matvec_df``.
``LAUNCHES`` (``ops/kkt_fused.py``) counts each kernel's launches; K9 and
K10 count their matvec phases as ``df_kkt_matvec_in_pass`` (they launch no
K11), the per-step reference its (planar) K11 launches as
``df_kkt_matvec``, the pair K11 its own as ``df_kkt_matvec_pairs``.

Not ported, as for the f32 solver: the VMEM admission (``MAX_ARCS``,
``VMEM_BUDGET``, ``pass_vmem_bytes``), ``windowed``, ``interpret`` and the
TPU's transfer batching (``pack_flat``, ``_p1_flat``, ``_p2_flat``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.algorithms.core import zero_tolerance
from two_pass_lanczos_tpu_torch.algorithms.df import (
    DF,
    DFDecomposition,
    DFKKTOperator,
    _pass_one_df,
    _pass_two_df,
)
from two_pass_lanczos_tpu_torch.devices import DEFAULT_DEVICE, resolve_device
from two_pass_lanczos_tpu_torch.functions import host_f_tk_solve
from two_pass_lanczos_tpu_torch.ops._build import load_library
from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
    LAUNCHES,
    MAX_PARTIALS,
    KKTLayout,
    _check,
    _clock_ptr,
    _need,
    _ptr,
    _stream,
)

__all__ = ["DFFusedKKTSolver", "DF_BREAKDOWN_TOL", "df_kkt_matvec",
           "df_kkt_matvec_cuda", "df_kkt_matvec_pairs_cuda",
           "df_kkt_shard_matvec",
           "df_kkt_shard_matvec_cuda", "df_pass_one_cuda",
           "df_pass_two_cuda", "df_pass_one_steps_cuda",
           "df_pass_two_steps_cuda", "DFPassOneScratch",
           "df_pass_one_last_vector"]

#: breakdown tolerance at double-float working precision (1000 · 2⁻⁴⁹).
DF_BREAKDOWN_TOL = 1000.0 * 2.0 ** -49

#: pass one's outputs, as the JAX kernel returns them: αh, αl, βh, βl (k,),
#: ‖b‖ (2,) hi/lo, steps (1,) int32
Coeffs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
               torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------

def _df_layout_args(lay: KKTLayout, d2: torch.Tensor):
    if lay.d.device.type != "cuda":
        raise ValueError(
            f"the df kernels take a CUDA layout, not {lay.d.device}")
    _need(d2, (2, lay.m), torch.float32, lay.d.device, "d2")
    return (_ptr(d2), _ptr(lay.u), _ptr(lay.v), _ptr(lay.ptr), _ptr(lay.ent),
            lay.m, lay.p)


def df_kkt_matvec_cuda(lay: KKTLayout, d2: torch.Tensor,
                       x2: torch.Tensor) -> torch.Tensor:
    """K11 (``csrc/df_kkt_matvec.cu``): ``y = A·x`` for a (2, n) hi/lo CUDA
    x; returns y as (2, n)."""
    args = _df_layout_args(lay, d2)
    _need(x2, (2, lay.n), torch.float32, lay.d.device, "x2")
    lib = load_library()
    y2 = torch.empty_like(x2)
    code = lib.tpl_df_kkt_matvec(*args, _ptr(x2), _ptr(y2), _stream())
    _check(lib, code, "df_kkt_matvec")
    LAUNCHES["df_kkt_matvec"] += 1
    return y2


def df_kkt_matvec_pairs_cuda(lay: KKTLayout, d2: torch.Tensor,
                             x: torch.Tensor) -> torch.Tensor:
    """The pair K11 (``csrc/df_kkt_matvec.cu``): ``y = A·x`` for an (n, 2)
    CUDA x of (hi, lo) pairs; returns y as (n, 2), bitwise the planar
    :func:`df_kkt_matvec_cuda` of the same values."""
    args = _df_layout_args(lay, d2)
    _need(x, (lay.n, 2), torch.float32, lay.d.device, "x")
    lib = load_library()
    y = torch.empty_like(x)
    code = lib.tpl_df_kkt_matvec_pairs(*args, _ptr(x), _ptr(y), _stream())
    _check(lib, code, "df_kkt_matvec_pairs")
    LAUNCHES["df_kkt_matvec_pairs"] += 1
    return y


def df_kkt_matvec(op: DFKKTOperator, x2: torch.Tensor) -> torch.Tensor:
    """One df ``y = A·x`` for a (2, n) hi/lo x: K11 for a CUDA x, the plain
    pairwise table fold (``op.plain_matvec_df``) for a CPU x."""
    if x2.is_cuda:
        return df_kkt_matvec_cuda(op.layout, op.d2, x2.contiguous())
    y = op.plain_matvec_df(DF(x2[0], x2[1]))
    return torch.stack([y.hi, y.lo])


def df_kkt_shard_matvec_cuda(lay: KKTLayout, d2: torch.Tensor,
                             x: torch.Tensor) -> torch.Tensor:
    """K12 (``csrc/df_kkt_shard_matvec.cu``): one shard's df matvec for its
    CUDA layout (arcs over the global node ids), its (2, m_d) costs and the
    local ``[x_a of the shard, x_n]`` as (m_d + p, 2) (hi, lo) pairs;
    returns ``[y_a, s]`` as (m_d + p, 2) pairs, s the shard's df node
    partial. With one shard it is bitwise K11."""
    args = _df_layout_args(lay, d2)
    _need(x, (lay.n, 2), torch.float32, lay.d.device, "x")
    lib = load_library()
    y = torch.empty_like(x)
    code = lib.tpl_df_kkt_shard_matvec(*args, _ptr(x), _ptr(y), _stream())
    _check(lib, code, "df_kkt_shard_matvec")
    LAUNCHES["df_kkt_streaming_matvec"] += 1
    return y


def df_kkt_shard_matvec(op: DFKKTOperator, x: torch.Tensor) -> torch.Tensor:
    """One shard's df matvec for the local vector as (m_d + p, 2) (hi, lo)
    pairs, ``op`` the shard's :class:`DFKKTOperator`; returns (m_d + p, 2)
    pairs: K12 for a CUDA x, the plain pairwise table fold over the shard
    (``op.plain_matvec_df``) for a CPU x."""
    if x.is_cuda:
        return df_kkt_shard_matvec_cuda(op.layout, op.d2, x.contiguous())
    y = op.plain_matvec_df(DF(x[:, 0], x[:, 1]))
    return torch.stack([y.hi, y.lo], -1)


@dataclasses.dataclass(frozen=True)
class DFPassOneScratch:
    """Pass one's scratch, as its entry point takes it
    (``csrc/df_lanczos_pass_one.cu``)."""

    w2: torch.Tensor  # (2, n) planar; K9: (2, n, 2), two halves of pairs
    partials: torch.Tensor  # (2 * MAX_PARTIALS,); K9: (4 * MAX_PARTIALS,)
    flags: torch.Tensor  # (1,) int32: live; (1 + p,) for K9: node-row tags
    scal: Optional[torch.Tensor]  # (6,) f32 per-step only: β, α, 1/β pairs
    pairs: Optional[torch.Tensor]  # K9 only: (2, n, 2) v_prev, v_curr pairs

    @classmethod
    def alloc(cls, lay: KKTLayout, persistent: bool) -> "DFPassOneScratch":
        """``persistent``: K9's scratch, two halves of w and v_prev, v_curr
        as (hi, lo) pairs, α's and β's df partial planes apart, and the node
        rows' hand-over tags; the per-step launches need one planar w, one
        pair of planes, the scalars and the live flag."""
        dev = lay.d.device
        f32 = functools.partial(torch.empty, dtype=torch.float32, device=dev)
        return cls(w2=f32((2, lay.n, 2) if persistent else (2, lay.n)),
                   partials=f32((4 if persistent else 2) * MAX_PARTIALS),
                   flags=torch.empty(1 + lay.p if persistent else 1,
                                     dtype=torch.int32, device=dev),
                   scal=None if persistent else f32(6),
                   pairs=f32((2, lay.n, 2)) if persistent else None)


def _df_pass_one(lay: KKTLayout, d2: torch.Tensor, b2: torch.Tensor, k: int,
                 tol: float, ztol: float, state: Optional[torch.Tensor],
                 persistent: bool,
                 clock: Optional[torch.Tensor] = None) -> Coeffs:
    args = _df_layout_args(lay, d2)
    dev = lay.d.device
    _need(b2, (2, lay.n), torch.float32, dev, "b2")
    if state is None:
        state = torch.empty((2, 2, lay.n), dtype=torch.float32, device=dev)
    _need(state, (2, 2, lay.n), torch.float32, dev, "state")
    coeffs = torch.empty((4, k), dtype=torch.float32, device=dev)
    bnorm2 = torch.empty(2, dtype=torch.float32, device=dev)
    steps = torch.empty(1, dtype=torch.int32, device=dev)
    sc = DFPassOneScratch.alloc(lay, persistent)
    lib = load_library()
    mv = ctypes.c_int(0)
    head = (*args, _ptr(b2), k, tol, ztol, _ptr(coeffs), _ptr(bnorm2),
            _ptr(steps), _ptr(state[0]), _ptr(state[1]), _ptr(sc.w2))
    if persistent:
        code = lib.tpl_df_lanczos_pass_one(
            *head, _ptr(sc.pairs), _ptr(sc.partials), _ptr(sc.flags),
            _clock_ptr(clock, "df_lanczos_pass_one"), ctypes.byref(mv),
            _stream())
        name, matvecs = "df_lanczos_pass_one", "df_kkt_matvec_in_pass"
    else:
        code = lib.tpl_df_lanczos_pass_one_steps(
            *head, _ptr(sc.partials), _ptr(sc.scal), _ptr(sc.flags),
            ctypes.byref(mv), _stream())
        name, matvecs = "df_lanczos_pass_one_steps", "df_kkt_matvec"
    LAUNCHES[matvecs] += mv.value
    _check(lib, code, name)
    LAUNCHES[name] += 1
    return coeffs[0], coeffs[1], coeffs[2], coeffs[3], bnorm2, steps


def df_pass_one_cuda(lay: KKTLayout, d2: torch.Tensor, b2: torch.Tensor,
                     k: int, tol: float, ztol: float,
                     state: Optional[torch.Tensor] = None,
                     phase_clock: Optional[torch.Tensor] = None) -> Coeffs:
    """K9 (``csrc/df_lanczos_pass_one.cu``): k masked df steps from the
    (2, n) b in one cooperative launch. A ``(2, 2, n)`` ``state`` receives
    the final ``(v_prev, v_curr)`` pairs; a ``phase_clock``
    (``ops/kkt_fused.phase_clock("df_lanczos_pass_one", ...)``) the stamps
    of ``phase_split``."""
    return _df_pass_one(lay, d2, b2, k, tol, ztol, state, True, phase_clock)


def df_pass_one_steps_cuda(lay: KKTLayout, d2: torch.Tensor, b2: torch.Tensor,
                           k: int, tol: float, ztol: float,
                           state: Optional[torch.Tensor] = None) -> Coeffs:
    """The per-step launches K9 replaced (six a step, K11 the first), K9's
    bitwise reference for ``chip_smoke.py`` and the card tests; no solve
    calls it. Arguments and outputs as :func:`df_pass_one_cuda`."""
    return _df_pass_one(lay, d2, b2, k, tol, ztol, state, False)


def _df_pass_two(lay: KKTLayout, d2: torch.Tensor, b2: torch.Tensor,
                 coeffs: Coeffs, y2: torch.Tensor, ztol: float,
                 state: Optional[torch.Tensor], persistent: bool,
                 clock: Optional[torch.Tensor] = None) -> torch.Tensor:
    args = _df_layout_args(lay, d2)
    dev = lay.d.device
    n = lay.n
    ah, al, bh, bl, bnorm2, steps = coeffs
    k = int(ah.shape[0])
    _need(b2, (2, n), torch.float32, dev, "b2")
    c4 = torch.stack([ah, al, bh, bl]).to(device=dev, dtype=torch.float32)
    y2 = y2.to(device=dev, dtype=torch.float32).contiguous()
    _need(y2, (2, k), torch.float32, dev, "y2")
    bnorm2 = bnorm2.to(device=dev, dtype=torch.float32).contiguous()
    steps = steps.to(device=dev, dtype=torch.int32).reshape(1).contiguous()
    _need(bnorm2, (2,), torch.float32, dev, "bnorm2")
    if state is None:
        state = torch.empty((2, 2, n), dtype=torch.float32, device=dev)
    _need(state, (2, 2, n), torch.float32, dev, "state")
    x2 = torch.empty((2, n), dtype=torch.float32, device=dev)
    lib = load_library()
    mv = ctypes.c_int(0)
    head = (*args, _ptr(b2), k, ztol, _ptr(c4), _ptr(y2), _ptr(bnorm2),
            _ptr(steps), _ptr(x2), _ptr(state[0]), _ptr(state[1]))
    if persistent:
        pairs = torch.empty((3, n, 2), dtype=torch.float32, device=dev)
        code = lib.tpl_df_lanczos_pass_two(
            *head, _ptr(pairs), _clock_ptr(clock, "df_lanczos_pass_two"),
            ctypes.byref(mv), _stream())
        name, matvecs = "df_lanczos_pass_two", "df_kkt_matvec_in_pass"
    else:
        w2 = torch.empty((2, n), dtype=torch.float32, device=dev)
        code = lib.tpl_df_lanczos_pass_two_steps(*head, _ptr(w2),
                                                 ctypes.byref(mv), _stream())
        name, matvecs = "df_lanczos_pass_two_steps", "df_kkt_matvec"
    LAUNCHES[matvecs] += mv.value
    _check(lib, code, name)
    LAUNCHES[name] += 1
    return x2


def df_pass_two_cuda(lay: KKTLayout, d2: torch.Tensor, b2: torch.Tensor,
                     coeffs: Coeffs, y2: torch.Tensor, ztol: float,
                     state: Optional[torch.Tensor] = None,
                     phase_clock: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """K10 (``csrc/df_lanczos_pass_two.cu``): the replay from pass one's
    ``coeffs`` and x = Σ y_j v_j for a (2, k) hi/lo y (zero beyond
    ``steps_taken``, scaled by ‖b‖) in one cooperative launch; returns x as
    (2, n). A ``phase_clock`` receives the stamps of ``phase_split``."""
    return _df_pass_two(lay, d2, b2, coeffs, y2, ztol, state, True,
                        phase_clock)


def df_pass_two_steps_cuda(lay: KKTLayout, d2: torch.Tensor, b2: torch.Tensor,
                           coeffs: Coeffs, y2: torch.Tensor, ztol: float,
                           state: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The two launches a step that K10 replaced (K11, then the update),
    K10's bitwise reference for ``chip_smoke.py`` and the card tests; no
    solve calls it. Arguments and output as :func:`df_pass_two_cuda`."""
    return _df_pass_two(lay, d2, b2, coeffs, y2, ztol, state, False)


def df_pass_one_last_vector(coeffs: Coeffs,
                            state: torch.Tensor) -> torch.Tensor:
    """Pass one's v_{steps_taken} (a (2, n) pair) from its final state:
    ``v_prev`` after a step that advanced, ``v_curr`` after a breakdown at
    the last executed step (stored β_hi = 0)."""
    s = int(coeffs[5].reshape(-1)[0])
    if s == 0:
        raise ValueError("no basis vector: pass one took 0 steps")
    return state[1] if float(coeffs[2][s - 1]) == 0.0 else state[0]


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------

class DFFusedKKTSolver:
    """Fused two-pass f(A)·b in double-float.

    Usage::

        s = DFFusedKKTSolver(quad_costs_f64, arc_u, arc_v, num_nodes)  # card
        x, (alphas64, betas64, steps) = s.solve(b_f64, k=500, f="inv")

    ``quad_costs`` are f64 (split exactly into hi/lo f32 planes, never
    through f32 first) or a ``(hi, lo)`` tuple of f32 planes, taken as it
    is. ``x`` comes back as an f64 tensor (hi + lo) on the solver's device,
    the coefficients as f64 NumPy arrays. On ``device="cuda"`` (the
    default; it raises without a card) the passes are K9 and K10; on
    ``device="cpu"`` the plain ``algorithms/df.py`` passes.
    """

    def __init__(self, quad_costs, arc_u, arc_v, num_nodes,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.op = DFKKTOperator(quad_costs, arc_u, arc_v, num_nodes,
                                device=self.device)
        self.layout = self.op.layout
        self.d2 = self.op.d2
        self.n = self.layout.n
        self.tol = DF_BREAKDOWN_TOL
        self.ztol = zero_tolerance(torch.float32)

    @property
    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    # -- packing ----------------------------------------------------------
    def pack(self, b) -> torch.Tensor:
        """The right-hand side as a (2, n) hi/lo f32 tensor on the solver's
        device. (n,) f64 data (NumPy, or a tensor, on the card or not) is
        split on the device: hi = f32(b), lo = f32(b − hi). A (2, n) f32
        tensor on the device is taken as the packed pair, in place."""
        if (isinstance(b, torch.Tensor) and b.dtype == torch.float32
                and b.dim() == 2):
            if tuple(b.shape) != (2, self.n):
                raise ValueError(f"a packed b must be (2, {self.n}), got "
                                 f"{tuple(b.shape)}")
            return b.to(self.device).contiguous()
        t = b if isinstance(b, torch.Tensor) else torch.from_numpy(
            np.asarray(b, np.float64))
        t = t.to(device=self.device, dtype=torch.float64)
        if tuple(t.shape) != (self.n,):
            raise ValueError(f"b must have shape ({self.n},), got "
                             f"{tuple(t.shape)}")
        hi = t.to(torch.float32)
        return torch.stack([hi, (t - hi.to(torch.float64)).to(torch.float32)])

    @staticmethod
    def unpack64(x2: torch.Tensor) -> torch.Tensor:
        """A (2, n) hi/lo pair as an (n,) f64 tensor, on its device."""
        return x2[0].to(torch.float64) + x2[1].to(torch.float64)

    # -- passes -----------------------------------------------------------
    def pass_one(self, b_rep, k: int,
                 state: Optional[torch.Tensor] = None) -> Coeffs:
        """Pass one (K9 on CUDA): ``(αh, αl, βh, βl, bnorm2, steps)``. A
        ``(2, 2, n)`` ``state`` receives the final (v_prev, v_curr)."""
        if k < 1:
            raise ValueError("k must be >= 1")
        b2 = self.pack(b_rep)
        if self._cuda:
            return df_pass_one_cuda(self.layout, self.d2, b2, k, self.tol,
                                    self.ztol, state)
        dec, _, (vp, vc) = _pass_one_df(self.op, DF(b2[0], b2[1]), k, False)
        if state is not None:
            state.copy_(torch.stack([torch.stack(vp), torch.stack(vc)]))
        return (dec.alphas.hi, dec.alphas.lo, dec.betas.hi, dec.betas.lo,
                torch.stack([dec.b_norm.hi, dec.b_norm.lo]),
                dec.steps_taken.reshape(1))

    def pass_two(self, b_rep, coeffs: Coeffs, y_h, y_l,
                 state: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Pass two (K10 on CUDA): x's (2, n) hi/lo pair for the (k,) y
        planes ``y_h``, ``y_l`` (zero beyond ``steps_taken``, scaled by
        ‖b‖)."""
        b2 = self.pack(b_rep)
        y2 = torch.stack([torch.as_tensor(y_h), torch.as_tensor(y_l)]).to(
            device=self.device, dtype=torch.float32)
        if self._cuda:
            return df_pass_two_cuda(self.layout, self.d2, b2, coeffs, y2,
                                    self.ztol, state)
        ah, al, bh, bl, bnorm2, steps = coeffs
        dec = DFDecomposition(alphas=DF(ah, al), betas=DF(bh, bl),
                              steps_taken=steps.reshape(()),
                              b_norm=DF(bnorm2[0], bnorm2[1]))
        x, _, (vp, vc) = _pass_two_df(self.op, DF(b2[0], b2[1]), dec,
                                      DF(y2[0], y2[1]), False)
        if state is not None:
            state.copy_(torch.stack([torch.stack(vp), torch.stack(vc)]))
        return torch.stack([x.hi, x.lo])

    def solve(self, b, *, k: int, f="inv"):
        """Two-pass f(A)·b in double-float. Returns ``(x, (alphas_f64,
        betas_f64, steps))``: x an (n,) f64 tensor on the solver's device.

        One readback of the packed coefficients, f(T_k)e₁ on the host in
        f64, one upload of the (2, k) y."""
        b2 = self.pack(b)
        coeffs = self.pass_one(b2, k)
        ah, al, bh, bl, bn2, st = coeffs
        pk = torch.cat([ah, al, bh, bl, bn2, st.to(torch.float32)]).cpu()
        pk = pk.numpy().astype(np.float64)  # the one device-to-host copy
        a64 = pk[:k] + pk[k:2 * k]
        b64 = pk[2 * k:3 * k] + pk[3 * k:4 * k]
        b_norm64 = pk[4 * k] + pk[4 * k + 1]
        steps = int(pk[4 * k + 2])
        if steps == 0:
            x = torch.zeros(self.n, dtype=torch.float64, device=self.device)
            return x, (a64[:0], b64[:0], 0)
        alphas = a64[:steps]
        betas = b64[: steps - 1]
        y_full = np.zeros(k)
        y_full[:steps] = host_f_tk_solve(alphas, betas, f) * b_norm64
        y_h = y_full.astype(np.float32)
        y_l = (y_full - y_h.astype(np.float64)).astype(np.float32)
        y2 = torch.from_numpy(np.stack([y_h, y_l])).to(self.device)  # upload
        x2 = self.pass_two(b2, coeffs, y2[0], y2[1])
        return self.unpack64(x2), (alphas, betas, steps)
