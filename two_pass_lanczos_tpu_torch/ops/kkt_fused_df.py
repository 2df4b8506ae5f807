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
costs as a ``(2, m)`` hi/lo tensor, and every df vector as one ``(2, n)``
tensor, hi plane first. The kernels (``csrc/df_*.cu``):

* K11 ``df_kkt_matvec.cu`` — one df ``y = A·x`` (:func:`df_kkt_matvec`);
* K9 ``df_lanczos_pass_one.cu`` — pass one, α, β and ‖b‖ as df pairs;
* K10 ``df_lanczos_pass_two.cu`` — the replay from the stored df β and the
  df accumulation of x; its hi and lo basis are bitwise pass one's.

Each wrapper launches its kernel for CUDA tensors and raises on anything it
does not take; on the CPU the solver runs the plain versions,
``algorithms/df.py``'s passes over ``DFKKTOperator.plain_matvec_df``.
``LAUNCHES`` (``ops/kkt_fused.py``) counts each kernel's launches; K9 and
K10 add their in-pass K11 launches to ``df_kkt_matvec``.

Not ported, as for the f32 solver: the VMEM admission (``MAX_ARCS``,
``VMEM_BUDGET``, ``pass_vmem_bytes``), ``windowed``, ``interpret`` and the
TPU's transfer batching (``pack_flat``, ``_p1_flat``, ``_p2_flat``).
"""

from __future__ import annotations

import ctypes
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
    _need,
    _ptr,
    _stream,
)

__all__ = ["DFFusedKKTSolver", "DF_BREAKDOWN_TOL", "df_kkt_matvec",
           "df_kkt_matvec_cuda", "df_pass_one_cuda", "df_pass_two_cuda",
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


def df_kkt_matvec(op: DFKKTOperator, x2: torch.Tensor) -> torch.Tensor:
    """One df ``y = A·x`` for a (2, n) hi/lo x: K11 for a CUDA x, the plain
    pairwise table fold (``op.plain_matvec_df``) for a CPU x."""
    if x2.is_cuda:
        return df_kkt_matvec_cuda(op.layout, op.d2, x2.contiguous())
    y = op.plain_matvec_df(DF(x2[0], x2[1]))
    return torch.stack([y.hi, y.lo])


def df_pass_one_cuda(lay: KKTLayout, d2: torch.Tensor, b2: torch.Tensor,
                     k: int, tol: float, ztol: float,
                     state: Optional[torch.Tensor] = None) -> Coeffs:
    """K9 (``csrc/df_lanczos_pass_one.cu``): k masked df steps from the
    (2, n) b. A ``(2, 2, n)`` ``state`` receives the final ``(v_prev,
    v_curr)`` pairs."""
    args = _df_layout_args(lay, d2)
    dev = lay.d.device
    n = lay.n
    _need(b2, (2, n), torch.float32, dev, "b2")
    if state is None:
        state = torch.empty((2, 2, n), dtype=torch.float32, device=dev)
    _need(state, (2, 2, n), torch.float32, dev, "state")

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    coeffs, bnorm2, w2 = f32(4, k), f32(2), f32(2, n)
    partials, scal = f32(2 * MAX_PARTIALS), f32(6)
    steps = torch.empty(1, dtype=torch.int32, device=dev)
    flags = torch.empty(1, dtype=torch.int32, device=dev)
    lib = load_library()
    mv = ctypes.c_int(0)
    code = lib.tpl_df_lanczos_pass_one(
        *args, _ptr(b2), k, tol, ztol, _ptr(coeffs), _ptr(bnorm2),
        _ptr(steps), _ptr(state[0]), _ptr(state[1]), _ptr(w2),
        _ptr(partials), _ptr(scal), _ptr(flags), ctypes.byref(mv), _stream())
    LAUNCHES["df_kkt_matvec"] += mv.value
    _check(lib, code, "df_lanczos_pass_one")
    LAUNCHES["df_lanczos_pass_one"] += 1
    return coeffs[0], coeffs[1], coeffs[2], coeffs[3], bnorm2, steps


def df_pass_two_cuda(lay: KKTLayout, d2: torch.Tensor, b2: torch.Tensor,
                     coeffs: Coeffs, y2: torch.Tensor, ztol: float,
                     state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K10 (``csrc/df_lanczos_pass_two.cu``): the replay from pass one's
    ``coeffs`` and x = Σ y_j v_j for a (2, k) hi/lo y (zero beyond
    ``steps_taken``, scaled by ‖b‖); returns x as (2, n)."""
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
    w2 = torch.empty((2, n), dtype=torch.float32, device=dev)
    lib = load_library()
    mv = ctypes.c_int(0)
    code = lib.tpl_df_lanczos_pass_two(
        *args, _ptr(b2), k, ztol, _ptr(c4), _ptr(y2), _ptr(bnorm2),
        _ptr(steps), _ptr(x2), _ptr(state[0]), _ptr(state[1]), _ptr(w2),
        ctypes.byref(mv), _stream())
    LAUNCHES["df_kkt_matvec"] += mv.value
    _check(lib, code, "df_lanczos_pass_two")
    LAUNCHES["df_lanczos_pass_two"] += 1
    return x2


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
