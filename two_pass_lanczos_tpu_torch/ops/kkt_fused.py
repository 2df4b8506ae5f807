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

The kernels (``csrc/``): K1 the matvec, K2 pass one, K3 pass two, K4 pass
one with the basis (``method="one_pass"``), K5 the resumable pass one
(``callback=``, :meth:`FusedKKTSolver.pass_one_chunked`), K6 the compensated
builds of K2, K4 and K5 (``compensated=True``) and K13 the tripwire of their
error-free transformations. Each has a wrapper here that launches it for
CUDA tensors and raises on anything it does not take, and a plain PyTorch
version (``ops/spmv.kkt_matvec``, ``algorithms/core.pass_one_scan``,
``pass_one_chunk_scan`` and ``pass_two_scan``, ``dot_f64`` for the
compensated reductions, ``ops/eft.eft_check_plain``) that the solver runs
for CPU tensors. ``LAUNCHES`` counts the kernel launches of each wrapper.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.algorithms.core import (
    LanczosDecomposition,
    basis_product,
    breakdown_tolerance,
    dot_f64,
    pass_one_chunk_scan,
    pass_one_scan,
    pass_two_scan,
    zero_tolerance,
)
from two_pass_lanczos_tpu_torch.devices import DEFAULT_DEVICE, resolve_device
from two_pass_lanczos_tpu_torch.functions import padded_f_e1
from two_pass_lanczos_tpu_torch.ops._build import load_library
from two_pass_lanczos_tpu_torch.ops.eft import eft_check_plain
from two_pass_lanczos_tpu_torch.ops.spmv import kkt_matvec

__all__ = ["KKTLayout", "FusedKKTSolver", "LAUNCHES", "reset_launches"]

#: kernel launches per kernel since the last :func:`reset_launches`; a
#: compensated launch of K2, K4 or K5 counts as ``lanczos_pass_one_comp``,
#: and K8, the matvec of the generic KKT operators (``ops/spmv_kernel.py``),
#: as ``kkt_operator_matvec``; K11, K9 and K10, the double-float kernels
#: (``ops/kkt_fused_df.py``), as ``df_kkt_matvec``, ``df_lanczos_pass_one``
#: and ``df_lanczos_pass_two``
LAUNCHES = {"kkt_matvec": 0, "lanczos_pass_one": 0, "lanczos_pass_two": 0,
            "lanczos_pass_one_basis": 0, "lanczos_pass_one_chunk": 0,
            "lanczos_pass_one_comp": 0, "eft_check": 0,
            "kkt_operator_matvec": 0, "df_kkt_matvec": 0,
            "df_lanczos_pass_one": 0, "df_lanczos_pass_two": 0}
#: size of one plane of pass one's block-partials scratch
#: (``tpl::kMaxPartials``); the scratch holds two planes
MAX_PARTIALS = 1024


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True)
class KKTLayout:
    """Device layout of one KKT instance (see the module docstring)."""

    d: torch.Tensor  # (m,) f32 (f64 for the f64 instance of K8)
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
    def build(cls, quad_costs, arc_u, arc_v, num_nodes: int, device,
              dtype=np.float32) -> "KKTLayout":
        """Host build (NumPy, O(m log m)), then one upload per array; ``d``
        is stored in ``dtype``."""
        d = np.asarray(quad_costs, dtype)
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
            return torch.from_numpy(np.array(a, dt)).to(dev)

        return cls(d=up(d, dtype), u=up(u, np.int32), v=up(v, np.int32),
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


@dataclasses.dataclass(frozen=True)
class PassOneBuffers:
    """Device outputs and scratch of one pass-one run (K2, K4 or K5). K5
    keeps them between its chunk calls: they are the carried state."""

    alphas: torch.Tensor  # (k,) f32
    betas: torch.Tensor  # (k,) f32
    bnorm: torch.Tensor  # (1,) f32
    steps: torch.Tensor  # (1,) int32
    state: torch.Tensor  # (2, n) f32: v_prev, v_curr
    w: torch.Tensor  # (n,) f32
    partials: torch.Tensor  # (2 * MAX_PARTIALS,) f32
    scal: torch.Tensor  # (3,) f32: beta_prev, alpha, 1/beta
    flags: torch.Tensor  # (1,) int32: live

    @classmethod
    def alloc(cls, lay: KKTLayout, k: int,
              state: Optional[torch.Tensor] = None) -> "PassOneBuffers":
        dev = lay.d.device
        f32 = functools.partial(torch.empty, dtype=torch.float32, device=dev)
        i32 = functools.partial(torch.empty, dtype=torch.int32, device=dev)
        if state is None:
            state = f32((2, lay.n))
        _need(state, (2, lay.n), torch.float32, dev, "state")
        return cls(alphas=f32(k), betas=f32(k), bnorm=f32(1), steps=i32(1),
                   state=state, w=f32(lay.n), partials=f32(2 * MAX_PARTIALS),
                   scal=f32(3), flags=i32(1))

    def decomposition(self) -> LanczosDecomposition:
        return LanczosDecomposition(alphas=self.alphas, betas=self.betas,
                                    steps_taken=self.steps[0],
                                    b_norm=self.bnorm[0])


def _launch_pass_one(entry: str, name: str, lay: KKTLayout,
                     bufs: PassOneBuffers, b: torch.Tensor, tol: float,
                     ztol: float, compensated: bool, *extra) -> None:
    """Call the pass-one entry point ``entry`` (``csrc/lanczos_pass_one.cu``)
    and count it as ``name``, or as ``lanczos_pass_one_comp``."""
    _need(b, (lay.n,), torch.float32, lay.d.device, "b")
    lib = load_library()
    mv = ctypes.c_int(0)
    code = getattr(lib, entry)(
        *_layout_args(lay), _ptr(b), bufs.alphas.shape[0], tol, ztol,
        int(compensated), _ptr(bufs.alphas), _ptr(bufs.betas),
        _ptr(bufs.bnorm), _ptr(bufs.steps), _ptr(bufs.state[0]),
        _ptr(bufs.state[1]), _ptr(bufs.w), _ptr(bufs.partials),
        _ptr(bufs.scal), _ptr(bufs.flags), *extra, ctypes.byref(mv),
        _stream())
    LAUNCHES["kkt_matvec"] += mv.value
    _check(lib, code, entry)
    LAUNCHES["lanczos_pass_one_comp" if compensated else name] += 1


def pass_one_cuda(lay: KKTLayout, b: torch.Tensor, k: int, tol: float,
                  ztol: float, state: Optional[torch.Tensor] = None,
                  compensated: bool = False) -> LanczosDecomposition:
    """K2 (``csrc/lanczos_pass_one.cu``): k masked steps from b; the final
    ``(v_prev, v_curr)`` land in ``state`` when it is given."""
    bufs = PassOneBuffers.alloc(lay, k, state)
    _launch_pass_one("tpl_lanczos_pass_one", "lanczos_pass_one", lay, bufs, b,
                     tol, ztol, compensated)
    return bufs.decomposition()


def pass_one_basis_cuda(lay: KKTLayout, b: torch.Tensor, k: int, tol: float,
                        ztol: float, compensated: bool = False
                        ) -> Tuple[LanczosDecomposition, torch.Tensor]:
    """K4: K2 that also returns the ``(k, n)`` basis, row ``j`` = v_{j+1}
    and zero beyond ``steps_taken`` (k·n·4 bytes on the card)."""
    bufs = PassOneBuffers.alloc(lay, k)
    # zeros, not empty: the kernel stores no row for a step that does not
    # advance, and a garbage row times a zero coefficient is NaN in V·y
    basis = torch.zeros((k, lay.n), dtype=torch.float32, device=lay.d.device)
    _launch_pass_one("tpl_lanczos_pass_one_basis", "lanczos_pass_one_basis",
                     lay, bufs, b, tol, ztol, compensated, _ptr(basis))
    return bufs.decomposition(), basis


def pass_one_chunk_cuda(lay: KKTLayout, bufs: PassOneBuffers,
                        b: torch.Tensor, j0: int, count: int, tol: float,
                        ztol: float, compensated: bool = False) -> None:
    """K5: enqueue steps ``[j0, j0 + count)`` of a ``k``-step run on the
    carried ``bufs`` (``k = len(bufs.alphas)``); ``j0 == 0`` starts from b.
    α and β land at their global indices; nothing is read back."""
    k = bufs.alphas.shape[0]
    if not (0 <= j0 and 1 <= count and j0 + count <= k):
        raise ValueError(f"chunk [{j0}, {j0 + count}) outside [0, {k})")
    _launch_pass_one("tpl_lanczos_pass_one_chunk", "lanczos_pass_one_chunk",
                     lay, bufs, b, tol, ztol, compensated, j0, count)


def eft_check_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K13 (``csrc/eft_check.cu``): the ``(6, n)`` stack of
    ``ops/eft.eft_check_plain``, computed by the header's helpers."""
    if a.dim() != 1:
        raise ValueError("a must be 1-D")
    _need(a, a.shape, torch.float32, a.device, "a")
    _need(b, a.shape, torch.float32, a.device, "b")
    if a.device.type != "cuda":
        raise ValueError(f"eft_check_cuda takes CUDA tensors, got {a.device}")
    lib = load_library()
    out = torch.empty((6, a.shape[0]), dtype=torch.float32, device=a.device)
    code = lib.tpl_eft_check(_ptr(a), _ptr(b), a.shape[0], _ptr(out),
                             _stream())
    _check(lib, code, "eft_check")
    LAUNCHES["eft_check"] += 1
    return out


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

#: inputs of the EFT tripwire with exact, known outputs (``ops/eft.py``)
_EFT_A, _EFT_B = 1.0 + 2.0 ** -12, 2.0 ** -30


class FusedKKTSolver:
    """End-to-end f(A)·b solver for one KKT instance.

    Usage::

        s = FusedKKTSolver(quad_costs, arc_u, arc_v, num_nodes)  # the card
        x, decomp = s.solve(b, k=500, f="inv")            # NumPy (n,)
        x_dev, decomp = s.solve(b, k=500, f="inv", raw=True)  # device tensor
        x, decomp = s.solve(b, k=500, method="one_pass")  # stores the basis
        x, decomp = s.solve(b, k=500, callback=cb)        # in-run early stop

    On ``device="cuda"`` (the default; it raises without a card) every pass
    runs the hand-written kernels; on ``device="cpu"`` the plain PyTorch
    versions. f32 only, as the TPU path.
    ``compensated=True`` takes the α, β and ‖b‖ reductions as exact products
    folded in two-float pairs (the plain version: f64-accumulated dots); on
    the card the constructor first checks the compiled error-free
    transformations (K13) and raises if one is not exact.
    """

    def __init__(self, quad_costs, arc_u, arc_v, num_nodes,
                 dtype=torch.float32, device=DEFAULT_DEVICE,
                 compensated: bool = False):
        if dtype not in (torch.float32, np.float32):
            raise ValueError(
                "FusedKKTSolver kernels are f32; the plain pass_one_scan / "
                "pass_two_scan take f64 on the CPU")
        self.device = resolve_device(device)
        self.layout = KKTLayout.build(quad_costs, arc_u, arc_v, num_nodes,
                                      self.device)
        self.n = self.layout.n
        self.tol = breakdown_tolerance(torch.float32)
        self.ztol = zero_tolerance(torch.float32)
        self.compensated = bool(compensated)
        self._dot: Callable = dot_f64 if self.compensated else torch.dot
        if self.compensated and self._cuda:
            self._check_eft()

    @property
    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    def _check_eft(self) -> None:
        a = torch.full((128,), _EFT_A, dtype=torch.float32)
        b = torch.full((128,), _EFT_B, dtype=torch.float32)
        got = eft_check_cuda(a.to(self.device), b.to(self.device)).cpu()
        if not torch.equal(got, eft_check_plain(a, b)):
            raise RuntimeError(
                "the compiled two_sum/two_prod/df_add2 are not exact on this "
                "card (contracted or reordered by the build): the "
                "compensated reductions would be wrong")

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
            return pass_one_cuda(self.layout, b, k, self.tol, self.ztol, state,
                                 self.compensated)
        dec, _ = pass_one_scan(self._plain_matvec, b, k, state=state,
                               dot=self._dot)
        return dec

    def pass_one_with_basis(self, b, k: int
                            ) -> Tuple[LanczosDecomposition, torch.Tensor]:
        """The O(n·k) pass one (K4 on CUDA): the decomposition and the
        ``(k, n)`` basis, row ``j`` = v_{j+1}, zero beyond ``steps_taken``.
        α and β are bitwise those of :meth:`pass_one`."""
        if k < 1:
            raise ValueError("k must be >= 1")
        b = self.pack(b)
        if self._cuda:
            return pass_one_basis_cuda(self.layout, b, k, self.tol, self.ztol,
                                       self.compensated)
        return pass_one_scan(self._plain_matvec, b, k, emit_basis=True,
                             dot=self._dot)

    def pass_one_chunked(self, b, k: int, callback=None, chunk: int = 64
                         ) -> LanczosDecomposition:
        """Pass one with a live per-step callback (K5 on CUDA): the
        reference's in-run ``LanczosCallback`` stop.

        Runs ``ceil(k/chunk)`` resumable chunks; after each, the chunk's α,
        β, ``steps``, live flag and ‖b‖ come back in one copy and
        ``callback(s, None, (alphas[:s], betas[:s-1]))`` (NumPy views) is
        replayed for every new step ``s``; returning False stops. A stop at
        ``s`` costs at most ``ceil(s/chunk)·chunk`` matvecs and zeroes α
        from ``s`` and β from ``s-1``; a full run or a breakdown keeps
        β_steps as :meth:`pass_one` does. α and β are bitwise those of
        :meth:`pass_one`.
        """
        if k < 1 or chunk < 1:
            raise ValueError("k and chunk must be >= 1")
        b = self.pack(b)
        if self._cuda:
            bufs = PassOneBuffers.alloc(self.layout, k)

            def run(j0, c):
                pass_one_chunk_cuda(self.layout, bufs, b, j0, c, self.tol,
                                    self.ztol, self.compensated)
                packed = torch.cat([
                    bufs.alphas[j0:j0 + c], bufs.betas[j0:j0 + c],
                    bufs.steps.float(), bufs.flags.float(), bufs.bnorm,
                ]).cpu().numpy()  # the chunk's one device-to-host copy
                return (packed[:c], packed[c:2 * c], int(packed[2 * c]),
                        bool(packed[2 * c + 1]), packed[2 * c + 2])
        else:
            carry = None

            def run(j0, c):
                nonlocal carry
                a, bt, carry = pass_one_chunk_scan(
                    self._plain_matvec, b, c, carry, k, dot=self._dot)
                return (a.numpy(), bt.numpy(), int(carry.steps),
                        not bool(carry.done), carry.b_norm.numpy())

        alphas = np.zeros(k, np.float32)
        betas = np.zeros(k, np.float32)
        visited, stopped = 0, False
        for j0 in range(0, k, chunk):
            a_c, b_c, steps_now, live, b_norm = run(j0, min(chunk, k - j0))
            alphas[visited:steps_now] = a_c[:steps_now - visited]
            betas[visited:steps_now] = b_c[:steps_now - visited]
            for s in range(visited + 1, steps_now + 1):
                visited = s
                if callback is not None and not callback(
                        s, None, (alphas[:s], betas[:s - 1])):
                    stopped = True
                    break
            if stopped or not live or steps_now >= k:
                break
        alphas[visited:] = 0.0
        betas[max(visited - 1, 0) if stopped else visited:] = 0.0
        dev = self.device
        return LanczosDecomposition(
            alphas=torch.from_numpy(alphas).to(dev),
            betas=torch.from_numpy(betas).to(dev),
            steps_taken=torch.tensor(visited, dtype=torch.int32, device=dev),
            b_norm=torch.tensor(b_norm, dtype=torch.float32, device=dev))

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
              raw: bool = False, callback=None, callback_chunk: int = 64):
        """``f(A)·b`` by Lanczos. Returns ``(x, decomposition)``.

        ``method="two_pass"`` replays the basis in pass two (O(n) memory);
        ``"one_pass"`` stores it (k·n·4 bytes on the device) and forms
        ``x = V_k·y`` as one full-f32 product. ``f`` is "inv", "exp", a
        callable on a tensor of eigenvalues, or a tuple of these: pass one
        runs once, and ``x`` gains a leading nf axis. ``callback`` (two_pass
        only) runs pass one by :meth:`pass_one_chunked` in
        ``callback_chunk``-step chunks; a stop at step s truncates the solve
        to s. ``x`` is a NumPy array, or the device tensor when
        ``raw=True``. An (n,) f32 tensor ``b`` on the solver's device is
        used in place.
        """
        if method not in ("one_pass", "two_pass"):
            raise ValueError(f"unknown method {method!r}")
        if callback is not None and method != "two_pass":
            raise ValueError(
                "callback early stopping is implemented for the two_pass "
                "method (the one-pass variant stores its basis in one run)")
        b = self.pack(b)
        basis = None
        if callback is not None:
            decomp = self.pass_one_chunked(b, k, callback, callback_chunk)
        elif method == "one_pass":
            decomp, basis = self.pass_one_with_basis(b, k)
        else:
            decomp = self.pass_one(b, k)
        multi = isinstance(f, tuple)
        fs = f if multi else (f,)
        y = torch.stack([padded_f_e1(decomp, fi) for fi in fs])
        keep = torch.arange(k, device=y.device) < decomp.steps_taken
        y_full = torch.where(keep, y * decomp.b_norm, torch.zeros_like(y))
        y_full = y_full if multi else y_full[0]
        if basis is not None:
            x = basis_product(y_full, basis)
        else:
            x = self.pass_two(b, decomp, y_full)
        if raw:
            return x, decomp
        return x.cpu().numpy(), decomp
