"""Fused two-pass Lanczos for the KKT operator, on hand-written CUDA kernels.

Counterpart of ``two_pass_lanczos_tpu/ops/kkt_fused.py``. The TPU version
laid the arcs out twice, sorted by each endpoint and padded to 128 lanes,
because a TPU has no hardware gather and a serial scatter. Hopper gathers
natively and the whole headline state fits in its 50 MB L2, so this layout
is chosen for Hopper:

* arcs in their original order: ``d`` f32, ``u`` and ``v`` int32;
* one node-sorted incidence CSR for ``y_n = E·x_a``: ``ptr`` (p+1) and, for
  each of the 2m endpoint entries, the arc id with its sign (``a`` for the
  tail, ``~a`` for the head);
* the Krylov vectors are plain ``(n,)`` tensors, so the TPU's
  ``pack``/``unpack`` become a device copy and a no-op.

Three kernels carry the main path (``csrc/``): K1 the matvec, K2 pass one,
K3 pass two. Each has a wrapper here that launches it for CUDA tensors and
raises on anything it does not take, and a plain PyTorch version
(``ops/spmv.kkt_matvec``, ``algorithms/core.pass_one_scan`` and
``pass_two_scan``) that the solver runs for CPU tensors. ``LAUNCHES`` counts
the kernel launches of each wrapper.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.algorithms.core import (
    LanczosDecomposition,
    breakdown_tolerance,
    pass_one_scan,
    pass_two_scan,
    zero_tolerance,
)
from two_pass_lanczos_tpu_torch.functions import padded_f_e1
from two_pass_lanczos_tpu_torch.ops._build import load_library
from two_pass_lanczos_tpu_torch.ops.spmv import kkt_matvec

__all__ = ["KKTLayout", "FusedKKTSolver", "LAUNCHES", "reset_launches"]

#: kernel launches per kernel since the last :func:`reset_launches`
LAUNCHES = {"kkt_matvec": 0, "lanczos_pass_one": 0, "lanczos_pass_two": 0}
#: size of pass one's block-partials scratch (``tpl::kMaxPartials``)
MAX_PARTIALS = 1024


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True)
class KKTLayout:
    """Device layout of one KKT instance (see the module docstring)."""

    d: torch.Tensor  # (m,) f32
    u: torch.Tensor  # (m,) int32 tail node
    v: torch.Tensor  # (m,) int32 head node
    ptr: torch.Tensor  # (p+1,) int32 CSR row pointer over nodes
    ent: torch.Tensor  # (2m,) int32: a (sign +1) or ~a (sign -1)
    m: int
    p: int

    @property
    def n(self) -> int:
        return self.m + self.p

    @classmethod
    def build(cls, quad_costs, arc_u, arc_v, num_nodes: int,
              device) -> "KKTLayout":
        """Host build (NumPy, O(m log m)), then one upload per array."""
        d = np.asarray(quad_costs, np.float32)
        u = np.asarray(arc_u, np.int64)
        v = np.asarray(arc_v, np.int64)
        m, p = len(d), int(num_nodes)
        if m < 1 or p < 1:
            raise ValueError("a KKT instance needs at least one arc and node")
        if u.shape != (m,) or v.shape != (m,):
            raise ValueError("arc_u, arc_v and quad_costs differ in length")
        if min(u.min(), v.min()) < 0 or max(u.max(), v.max()) >= p:
            raise ValueError(f"arc endpoint outside [0, {p})")
        if 2 * m >= 2 ** 31:
            raise ValueError(f"{m} arcs overflow the int32 incidence CSR")
        ends = np.concatenate([u, v])
        ids = np.concatenate([np.arange(m), ~np.arange(m)])
        order = np.argsort(ends, kind="stable")  # per node: tails, then heads
        ptr = np.zeros(p + 1, np.int64)
        np.cumsum(np.bincount(ends, minlength=p), out=ptr[1:])
        dev = torch.device(device)

        def up(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)

        return cls(d=up(d, np.float32), u=up(u, np.int32), v=up(v, np.int32),
                   ptr=up(ptr, np.int32), ent=up(ids[order], np.int32),
                   m=m, p=p)


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------

def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.tpl_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def _need(t: torch.Tensor, shape, dtype, device, name: str) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _layout_args(lay: KKTLayout):
    return (_ptr(lay.d), _ptr(lay.u), _ptr(lay.v), _ptr(lay.ptr),
            _ptr(lay.ent), lay.m, lay.p)


def kkt_matvec_cuda(lay: KKTLayout, x: torch.Tensor) -> torch.Tensor:
    """K1 (``csrc/kkt_matvec.cu``): ``y = A·x`` for an (n,) f32 CUDA x."""
    _need(x, (lay.n,), torch.float32, lay.d.device, "x")
    lib = load_library()
    y = torch.empty_like(x)
    code = lib.tpl_kkt_matvec(*_layout_args(lay), _ptr(x), _ptr(y), _stream())
    _check(lib, code, "kkt_matvec")
    LAUNCHES["kkt_matvec"] += 1
    return y


def pass_one_cuda(lay: KKTLayout, b: torch.Tensor, k: int, tol: float,
                  ztol: float, state: Optional[torch.Tensor] = None
                  ) -> LanczosDecomposition:
    """K2 (``csrc/lanczos_pass_one.cu``): k masked steps from b; the final
    ``(v_prev, v_curr)`` land in ``state`` when it is given."""
    dev = lay.d.device
    _need(b, (lay.n,), torch.float32, dev, "b")
    if state is None:
        state = torch.empty((2, lay.n), dtype=torch.float32, device=dev)
    _need(state, (2, lay.n), torch.float32, dev, "state")
    lib = load_library()
    f32 = functools.partial(torch.empty, dtype=torch.float32, device=dev)
    alphas, betas, bnorm = f32(k), f32(k), f32(1)
    steps = torch.empty(1, dtype=torch.int32, device=dev)
    w, partials, scal = f32(lay.n), f32(MAX_PARTIALS), f32(3)
    flags = torch.empty(1, dtype=torch.int32, device=dev)
    mv = ctypes.c_int(0)
    code = lib.tpl_lanczos_pass_one(
        *_layout_args(lay), _ptr(b), k, tol, ztol, _ptr(alphas), _ptr(betas),
        _ptr(bnorm), _ptr(steps), _ptr(state[0]), _ptr(state[1]), _ptr(w),
        _ptr(partials), _ptr(scal), _ptr(flags), ctypes.byref(mv), _stream())
    LAUNCHES["kkt_matvec"] += mv.value
    _check(lib, code, "lanczos_pass_one")
    LAUNCHES["lanczos_pass_one"] += 1
    return LanczosDecomposition(alphas=alphas, betas=betas,
                                steps_taken=steps[0], b_norm=bnorm[0])


def pass_two_cuda(lay: KKTLayout, b: torch.Tensor,
                  decomp: LanczosDecomposition, y_full: torch.Tensor,
                  ztol: float, state: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """K3 (``csrc/lanczos_pass_two.cu``): replay and accumulate for a
    ``(k,)`` or ``(nf, k)`` y; returns ``(n,)`` or ``(nf, n)``."""
    dev = lay.d.device
    k = decomp.k_max
    _need(b, (lay.n,), torch.float32, dev, "b")
    if y_full.dim() not in (1, 2) or y_full.shape[-1] != k:
        raise ValueError(f"y_full must be (k,) or (nf, k) with k={k}")
    y2 = y_full.to(device=dev, dtype=torch.float32).reshape(-1, k).contiguous()
    nf = y2.shape[0]
    alphas = decomp.alphas.to(device=dev, dtype=torch.float32).contiguous()
    betas = decomp.betas.to(device=dev, dtype=torch.float32).contiguous()
    bnorm = decomp.b_norm.to(device=dev, dtype=torch.float32).reshape(1)
    steps = decomp.steps_taken.to(device=dev, dtype=torch.int32).reshape(1)
    if state is None:
        state = torch.empty((2, lay.n), dtype=torch.float32, device=dev)
    _need(state, (2, lay.n), torch.float32, dev, "state")
    lib = load_library()
    x = torch.empty((nf, lay.n), dtype=torch.float32, device=dev)
    w = torch.empty(lay.n, dtype=torch.float32, device=dev)
    mv = ctypes.c_int(0)
    code = lib.tpl_lanczos_pass_two(
        *_layout_args(lay), _ptr(b), k, ztol, _ptr(alphas), _ptr(betas),
        _ptr(y2), nf, _ptr(bnorm), _ptr(steps), _ptr(x), _ptr(state[0]),
        _ptr(state[1]), _ptr(w), ctypes.byref(mv), _stream())
    LAUNCHES["kkt_matvec"] += mv.value
    _check(lib, code, "lanczos_pass_two")
    LAUNCHES["lanczos_pass_two"] += 1
    return x if y_full.dim() == 2 else x[0]


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------

class FusedKKTSolver:
    """End-to-end two-pass f(A)·b solver for one KKT instance.

    Usage::

        s = FusedKKTSolver(quad_costs, arc_u, arc_v, num_nodes, device="cuda")
        x, decomp = s.solve(b, k=500, f="inv")            # NumPy (n,)
        x_dev, decomp = s.solve(b, k=500, f="inv", raw=True)  # device tensor

    On ``device="cuda"`` every pass runs the hand-written kernels; on
    ``device="cpu"`` the plain PyTorch versions. f32 only, as the TPU path.
    """

    def __init__(self, quad_costs, arc_u, arc_v, num_nodes,
                 dtype=torch.float32, device="cpu"):
        if dtype not in (torch.float32, np.float32):
            raise ValueError(
                "FusedKKTSolver kernels are f32; the plain pass_one_scan / "
                "pass_two_scan take f64 on the CPU")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.layout = KKTLayout.build(quad_costs, arc_u, arc_v, num_nodes,
                                      self.device)
        self.n = self.layout.n
        self.tol = breakdown_tolerance(torch.float32)
        self.ztol = zero_tolerance(torch.float32)

    @property
    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    def _plain_matvec(self, x: torch.Tensor) -> torch.Tensor:
        lay = self.layout
        return kkt_matvec(lay.d.to(x.dtype), lay.u, lay.v, lay.p, x)

    def pack(self, b) -> torch.Tensor:
        """(n,) right-hand side as an f32 tensor on the solver's device; a
        tensor already there is taken as it is (no host round trip)."""
        if isinstance(b, torch.Tensor):
            t = b.to(device=self.device, dtype=torch.float32)
        else:
            t = torch.as_tensor(np.asarray(b, np.float32), device=self.device)
        if tuple(t.shape) != (self.n,):
            raise ValueError(f"b must have shape ({self.n},), got {tuple(t.shape)}")
        return t.contiguous()

    def matvec(self, x) -> torch.Tensor:
        """``A·x`` for an (n,) x on the solver's device (K1 on CUDA)."""
        x = self.pack(x)
        if self._cuda:
            return kkt_matvec_cuda(self.layout, x)
        return self._plain_matvec(x)

    def pass_one(self, b, k: int, state: Optional[torch.Tensor] = None
                 ) -> LanczosDecomposition:
        """Pass one: ``k`` masked steps, scalars only (K2 on CUDA). A
        ``(2, n)`` ``state`` receives the final ``(v_prev, v_curr)``."""
        if k < 1:
            raise ValueError("k must be >= 1")
        b = self.pack(b)
        if self._cuda:
            return pass_one_cuda(self.layout, b, k, self.tol, self.ztol, state)
        dec, _ = pass_one_scan(self._plain_matvec, b, k, state=state)
        return dec

    def pass_two(self, b, decomp: LanczosDecomposition, y_full,
                 state: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Pass two (K3 on CUDA). ``y_full`` is ``(k,)`` or ``(nf, k)``,
        zero beyond ``steps_taken`` and scaled by ‖b‖; returns ``(n,)`` or
        ``(nf, n)``. ``state`` receives the final ``(v_prev, v_curr)``."""
        b = self.pack(b)
        y_full = torch.as_tensor(y_full, dtype=torch.float32, device=self.device)
        if self._cuda:
            return pass_two_cuda(self.layout, b, decomp, y_full, self.ztol,
                                 state)
        x, _ = pass_two_scan(self._plain_matvec, b, decomp, y_full, state=state)
        return x

    def solve(self, b, k: int, f="inv", method: str = "two_pass",
              raw: bool = False, callback=None):
        """``f(A)·b`` by two-pass Lanczos. Returns ``(x, decomposition)``.

        ``f`` is "inv", "exp", a callable on a tensor of eigenvalues, or a
        tuple of these: pass one runs once, pass two replays the basis once
        for all of them, and ``x`` gains a leading nf axis. ``x`` is a NumPy
        array, or the device tensor when ``raw=True``. An (n,) f32 tensor
        ``b`` on the solver's device is used in place.
        """
        if method == "one_pass":
            raise NotImplementedError(
                "method='one_pass' needs the pass-one-with-basis kernel "
                "(ROADMAP Queue 2, kernel 4)")
        if method != "two_pass":
            raise ValueError(f"unknown method {method!r}")
        if callback is not None:
            raise NotImplementedError(
                "callback early stopping needs the resumable pass-one kernel "
                "(ROADMAP Queue 2, kernel 5)")
        b = self.pack(b)
        decomp = self.pass_one(b, k)
        multi = isinstance(f, tuple)
        fs = f if multi else (f,)
        y = torch.stack([padded_f_e1(decomp, fi) for fi in fs])
        keep = torch.arange(k, device=y.device) < decomp.steps_taken
        y_full = torch.where(keep, y * decomp.b_norm, torch.zeros_like(y))
        x = self.pass_two(b, decomp, y_full if multi else y_full[0])
        if raw:
            return x, decomp
        return x.cpu().numpy(), decomp
