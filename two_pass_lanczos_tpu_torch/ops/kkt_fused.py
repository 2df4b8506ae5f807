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
one with the basis (``method="one_pass"``) and K5 the resumable pass one
(``callback=``, :meth:`FusedKKTSolver.pass_one_chunked`, one launch a
chunk): each of K2-K5 one persistent cooperative launch
(``csrc/lanczos_persistent.cuh``) that runs K1's matvec as a phase of every
step; K6 is the compensated instance of each of K2, K4 and K5
(``compensated=True``), one cooperative launch alike; K2, K4, K5 (each
instance) and K3 carry a phase timer that only ``chip_smoke.py`` switches on
(:func:`phase_clock`, :func:`phase_split`). The per-step launches that K2,
K4, K5 and K6 replaced, :func:`pass_one_steps_cuda`, stay as their bitwise
reference, which only ``chip_smoke.py`` and the card tests call; so does
the block-row matvec (one block a node row) that the warp rows of K1, K8
and K7 replaced (:func:`kkt_matvec_blockrows_cuda`,
:func:`kkt_shard_matvec_blockrows_cuda`); K13 is the
tripwire of K6's error-free transformations; K7, one shard's matvec with
a node partial, serves the sharded solver (``parallel/fused_sharded.py``).
Each kernel has a wrapper here that launches it for CUDA tensors and raises
on anything it does not take, and a plain PyTorch version
(``ops/spmv.kkt_matvec``, ``algorithms/core.pass_one_scan``,
``pass_one_chunk_scan`` and ``pass_two_scan``, ``dot_f64`` for the
compensated reductions, ``ops/eft.eft_check_plain``,
:func:`kkt_shard_matvec`) that runs for CPU tensors. ``LAUNCHES`` counts the kernel launches of each wrapper.

The solver's capability methods (JAX ``ops/kkt_fused.py:1241-1426``) run
on the same kernels: the SLQ methods one K2 launch (or K6's instance) per
probe (:func:`pass_one_batched_cuda`), ``chebyshev_fAb`` one K1 launch per
degree, ``estimate_interval`` ``eigsh`` over the K8 of the instance's KKT
operator; their host work is ``slq.py``, ``eigen.py`` and
``algorithms/chebyshev.py``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

# the module, not the name: functions.py imports ops.tridiag, and so this
# package's __init__, which imports this module
from two_pass_lanczos_tpu_torch import functions, slq
from two_pass_lanczos_tpu_torch.algorithms.chebyshev import (
    chebyshev_coefficients,
    chebyshev_scan,
    estimate_interval,
    validate_interval_for_f,
)
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
from two_pass_lanczos_tpu_torch.observability import trace
from two_pass_lanczos_tpu_torch.ops._build import load_library
from two_pass_lanczos_tpu_torch.ops.eft import eft_check_plain
from two_pass_lanczos_tpu_torch.ops.spmv import kkt_matvec

__all__ = ["KKTLayout", "FusedKKTSolver", "LAUNCHES", "reset_launches",
           "kkt_shard_matvec", "kkt_shard_matvec_cuda"]

#: kernel launches per kernel since the last :func:`reset_launches`; a
#: launch of K6, the compensated instance of K2, K4 or K5, counts as
#: ``lanczos_pass_one_comp``; the matvec phases inside the persistent K2, K4
#: and K6 (k a pass), K5 (its count a chunk) and K3 (k - 1, each gated on
#: ``steps_taken``) as ``kkt_matvec_in_pass``, which launch no K1; the
#: per-step launches K2, K4, K5 and K6 replaced (their reference, with
#: either comp, which launches K1) as ``lanczos_pass_one_steps``; K8, the
#: matvec of the generic KKT operators (``ops/spmv_kernel.py``), as
#: ``kkt_operator_matvec``; K11, K9 and K10, the double-float kernels
#: (``ops/kkt_fused_df.py``), as ``df_kkt_matvec``, ``df_lanczos_pass_one``
#: and ``df_lanczos_pass_two``, the K11 phases inside the persistent K9 (k a
#: pass) and K10 (k - 1) as ``df_kkt_matvec_in_pass``, and the per-step
#: launches K9 and K10 replaced (their reference, which launches K11) as
#: ``df_lanczos_pass_one_steps`` and ``df_lanczos_pass_two_steps``; K7 and
#: K12, the shard matvecs of the sharded
#: solvers (``parallel/``), as ``kkt_streaming_matvec`` and
#: ``df_kkt_streaming_matvec``, the names of the TPU kernels' wrappers; the
#: K14 micro-kernels (``probes/``) as ``probe_gather``, ``probe_stream``,
#: ``probe_stages`` and ``probe_pipeline``; K15, the CSR SpMV of the sparse
#: operators (``ops/spmv_kernel.csr_spmv_cuda``), as ``csr_spmv``, one a
#: product; the block-row references of K1,
#: K8 and K7 (one block a node row, which their warp rows replaced; no solve
#: calls them) as ``kkt_matvec_blockrows``, ``kkt_operator_matvec_blockrows``
#: and ``kkt_streaming_matvec_blockrows``
LAUNCHES = {"kkt_matvec": 0, "kkt_matvec_in_pass": 0,
            "kkt_matvec_blockrows": 0, "kkt_operator_matvec_blockrows": 0,
            "kkt_streaming_matvec_blockrows": 0,
            "lanczos_pass_one": 0, "lanczos_pass_two": 0,
            "lanczos_pass_one_basis": 0, "lanczos_pass_one_chunk": 0,
            "lanczos_pass_one_comp": 0, "lanczos_pass_one_steps": 0,
            "eft_check": 0,
            "kkt_streaming_matvec": 0, "kkt_operator_matvec": 0,
            "df_kkt_matvec": 0, "df_kkt_matvec_pairs": 0,
            "df_kkt_matvec_in_pass": 0,
            "df_lanczos_pass_one": 0, "df_lanczos_pass_two": 0,
            "df_lanczos_pass_one_steps": 0, "df_lanczos_pass_two_steps": 0,
            "df_kkt_streaming_matvec": 0,
            "probe_gather": 0, "probe_stream": 0, "probe_stages": 0,
            "probe_pipeline": 0, "csr_spmv": 0}
#: size of one plane of pass one's block-partials scratch
#: (``tpl::kMaxPartials``); the per-step scratch holds two planes, the
#: persistent one four (K6's two dots, a hi and a lo plane each)
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


def kkt_matvec_blockrows_cuda(lay: KKTLayout, x: torch.Tensor
                              ) -> torch.Tensor:
    """The reference of K1 and K8: the block-row kernel they replaced (one
    block of 256 threads a node row, ``kkt_node_row``), bitwise theirs. For
    an (n,) CUDA x in the layout's dtype (f32 or f64); no solve calls it."""
    dt = lay.d.dtype
    entry = {torch.float32: "tpl_kkt_matvec_blockrows",
             torch.float64: "tpl_kkt_matvec_blockrows_f64"}.get(dt)
    if entry is None:
        raise ValueError(f"the block-row reference has f32 and f64 "
                         f"instances, not {dt}")
    _need(x, (lay.n,), dt, lay.d.device, "x")
    lib = load_library()
    y = torch.empty_like(x)
    code = getattr(lib, entry)(*_layout_args(lay), _ptr(x), _ptr(y),
                               _stream())
    _check(lib, code, entry)
    LAUNCHES["kkt_matvec_blockrows" if dt == torch.float32
             else "kkt_operator_matvec_blockrows"] += 1
    return y


def kkt_shard_matvec(lay: KKTLayout, x: torch.Tensor,
                     e_scale: float = 1.0) -> torch.Tensor:
    """The plain version of K7 on any device: for one shard's layout (its
    arcs over the global node ids) and the local ``[x_a of the shard, x_n]``,
    ``[y_a, s]`` with ``y_a = (d·x_a + e·x_n[u]) − e·x_n[v]`` in K7's order
    and ``s = e·E_shard·x_a`` the shard's node partial (an atomic
    ``index_add_`` on CUDA: a reference, never the solver's path there)."""
    m = lay.m
    xa, xn = x[:m], x[m:]
    ya = lay.d * xa + e_scale * xn[lay.u] - e_scale * xn[lay.v]
    s = torch.zeros(lay.p, dtype=x.dtype, device=x.device)
    s.index_add_(0, lay.u, xa).index_add_(0, lay.v, -xa)
    return torch.cat([ya, e_scale * s])


def kkt_shard_matvec_cuda(lay: KKTLayout, x: torch.Tensor,
                          e_scale: float = 1.0,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7 (``csrc/kkt_shard_matvec.cu``): :func:`kkt_shard_matvec` for an
    (m_d + p,) f32 CUDA x on a CUDA shard layout. With ``e_scale = 1`` and
    one shard it is bitwise K1. ``out``, an (m_d + p,) f32 tensor other
    than x, receives y in place of a new tensor."""
    if lay.d.device.type != "cuda":
        raise ValueError(f"K7 takes a CUDA layout, not {lay.d.device}")
    _need(x, (lay.n,), torch.float32, lay.d.device, "x")
    if out is None:
        y = torch.empty_like(x)
    else:
        _need(out, (lay.n,), torch.float32, lay.d.device, "out")
        if out.data_ptr() == x.data_ptr():
            raise ValueError("out must not be x: K7 reads x while it writes")
        y = out
    lib = load_library()
    code = lib.tpl_kkt_shard_matvec(*_layout_args(lay), float(e_scale),
                                    _ptr(x), _ptr(y), _stream())
    _check(lib, code, "kkt_shard_matvec")
    LAUNCHES["kkt_streaming_matvec"] += 1
    return y


def kkt_shard_matvec_blockrows_cuda(lay: KKTLayout, x: torch.Tensor,
                                    e_scale: float = 1.0) -> torch.Tensor:
    """The reference of K7: the block-row kernel it replaced, bitwise K7,
    for the arguments of :func:`kkt_shard_matvec_cuda` (no ``out``); no
    solve calls it."""
    if lay.d.device.type != "cuda":
        raise ValueError(f"K7 takes a CUDA layout, not {lay.d.device}")
    _need(x, (lay.n,), torch.float32, lay.d.device, "x")
    y = torch.empty_like(x)
    lib = load_library()
    code = lib.tpl_kkt_shard_matvec_blockrows(
        *_layout_args(lay), float(e_scale), _ptr(x), _ptr(y), _stream())
    _check(lib, code, "kkt_shard_matvec_blockrows")
    LAUNCHES["kkt_streaming_matvec_blockrows"] += 1
    return y


@dataclasses.dataclass(frozen=True)
class PassOneBuffers:
    """Device outputs and scratch of one pass-one run (K2, K4, K5 or K6).
    K5 keeps them between its chunk calls: they are the carried state (the
    node-row tags in ``flags[1:]`` and the two-half ``w`` included)."""

    alphas: torch.Tensor  # (k,) f32
    betas: torch.Tensor  # (k,) f32
    bnorm: torch.Tensor  # (1,) f32
    steps: torch.Tensor  # (1,) int32
    state: torch.Tensor  # (2, n) f32: v_prev, v_curr
    w: torch.Tensor  # (2, n) f32, whose halves K2, K4, K5 alternate; (n,)
    partials: torch.Tensor  # (4 * MAX_PARTIALS,) f32; (2 * MAX_PARTIALS,)
    scal: torch.Tensor  # (3,) f32: beta_prev, alpha, 1/beta
    flags: torch.Tensor  # (1 + p,) int32: live, node-row tags; (1,): live

    @classmethod
    def alloc(cls, lay: KKTLayout, k: int,
              state: Optional[torch.Tensor] = None,
              persistent: bool = False) -> "PassOneBuffers":
        """``persistent``: the scratch of the persistent K2, K4, K5 and
        K6, w of (2, n), partials of 4 planes and flags of 1 + p; the
        per-step launches (the reference :func:`pass_one_steps_cuda`) need
        (n,), 2 planes and (1,)."""
        dev = lay.d.device
        f32 = functools.partial(torch.empty, dtype=torch.float32, device=dev)
        i32 = functools.partial(torch.empty, dtype=torch.int32, device=dev)
        if state is None:
            state = f32((2, lay.n))
        _need(state, (2, lay.n), torch.float32, dev, "state")
        return cls(alphas=f32(k), betas=f32(k), bnorm=f32(1), steps=i32(1),
                   state=state, w=f32((2, lay.n) if persistent else lay.n),
                   partials=f32((4 if persistent else 2) * MAX_PARTIALS),
                   scal=f32(3),
                   flags=i32(1 + lay.p if persistent else 1))

    @property
    def persistent(self) -> bool:
        return self.w.dim() == 2

    def decomposition(self) -> LanczosDecomposition:
        return LanczosDecomposition(alphas=self.alphas, betas=self.betas,
                                    steps_taken=self.steps[0],
                                    b_norm=self.bnorm[0])


def _launch_pass_one(entry: str, name: str, lay: KKTLayout,
                     bufs: PassOneBuffers, b: torch.Tensor, tol: float,
                     ztol: float, *extra, per_step: bool = False) -> None:
    """Call the pass-one entry point ``entry`` (``csrc/lanczos_pass_one.cu``)
    and count it as ``name``. A persistent entry point's matvecs count as
    ``kkt_matvec_in_pass``, and ``bufs`` must hold its scratch; those of the
    per-step launches (``per_step``) count as ``kkt_matvec``."""
    _need(b, (lay.n,), torch.float32, lay.d.device, "b")
    if bufs.persistent == per_step:
        want = "per-step" if per_step else "persistent"
        raise ValueError(
            f"{entry} needs the {want} scratch: "
            f"PassOneBuffers.alloc(..., persistent={not per_step})")
    lib = load_library()
    mv = ctypes.c_int(0)
    code = getattr(lib, entry)(
        *_layout_args(lay), _ptr(b), bufs.alphas.shape[0], tol, ztol,
        _ptr(bufs.alphas), _ptr(bufs.betas), _ptr(bufs.bnorm),
        _ptr(bufs.steps), _ptr(bufs.state[0]), _ptr(bufs.state[1]),
        _ptr(bufs.w), _ptr(bufs.partials), _ptr(bufs.scal), _ptr(bufs.flags),
        *extra, ctypes.byref(mv), _stream())
    LAUNCHES["kkt_matvec" if per_step else "kkt_matvec_in_pass"] += mv.value
    _check(lib, code, entry)
    LAUNCHES[name] += 1


def _clock_ptr(clock: Optional[torch.Tensor], name: str) -> ctypes.c_void_p:
    """The phase timer's buffer for pass ``name`` as the kernel takes it:
    nullptr for none, else a :func:`phase_clock` of this card's grid."""
    if clock is None:
        return ctypes.c_void_p(None)
    per_sm, sms = persistent_grid()[name]
    _need(clock, (TIMED_STEPS, per_sm * sms, len(PHASES[name]) + 1),
          torch.int64, clock.device, "phase_clock")
    return _ptr(clock)


def _comp(name: str, compensated: bool) -> str:
    """The counter of a pass-one launch: K6's for a compensated instance."""
    return "lanczos_pass_one_comp" if compensated else name


def _grid(name: str, compensated: bool) -> str:
    """The :func:`persistent_grid` key of pass-one instance ``name``."""
    return name + "_comp" if compensated else name


def pass_one_cuda(lay: KKTLayout, b: torch.Tensor, k: int, tol: float,
                  ztol: float, state: Optional[torch.Tensor] = None,
                  compensated: bool = False,
                  phase_clock: Optional[torch.Tensor] = None
                  ) -> LanczosDecomposition:
    """K2 (``csrc/lanczos_pass_one.cu``; compensated: its K6 instance): k
    masked steps from b in one cooperative launch; the final ``(v_prev,
    v_curr)`` land in ``state`` when it is given. A ``phase_clock`` of the
    instance's grid receives the stamps of :func:`phase_split`."""
    bufs = PassOneBuffers.alloc(lay, k, state, persistent=True)
    name = _comp("lanczos_pass_one", compensated)
    _launch_pass_one("tpl_lanczos_pass_one", name, lay, bufs, b, tol, ztol,
                     int(compensated), _clock_ptr(phase_clock, name))
    return bufs.decomposition()


def pass_one_batched_cuda(lay: KKTLayout, probes: torch.Tensor, k: int,
                          tol: float, ztol: float,
                          compensated: bool = False) -> LanczosDecomposition:
    """K2 (compensated: its K6 instance) once per row of an ``(m, n)`` f32
    CUDA ``probes``: the stacked decomposition, ``alphas`` and ``betas``
    (m, k), ``steps_taken`` and ``b_norm`` (m,), each row written in place
    by its launch. The launches share one scratch, which each start from b
    resets (α, β and the node-row tags), so row i is bitwise
    :func:`pass_one_cuda` on probe i alone."""
    m = probes.shape[0]
    _need(probes, (m, lay.n), torch.float32, lay.d.device, "probes")
    dev = lay.d.device
    alphas = torch.empty((m, k), dtype=torch.float32, device=dev)
    betas = torch.empty((m, k), dtype=torch.float32, device=dev)
    bnorm = torch.empty(m, dtype=torch.float32, device=dev)
    steps = torch.empty(m, dtype=torch.int32, device=dev)
    scratch = PassOneBuffers.alloc(lay, k, persistent=True)
    name = _comp("lanczos_pass_one", compensated)
    for i in range(m):
        bufs = dataclasses.replace(scratch, alphas=alphas[i], betas=betas[i],
                                   bnorm=bnorm[i:i + 1], steps=steps[i:i + 1])
        _launch_pass_one("tpl_lanczos_pass_one", name, lay, bufs, probes[i],
                         tol, ztol, int(compensated), ctypes.c_void_p(None))
    return LanczosDecomposition(alphas=alphas, betas=betas,
                                steps_taken=steps, b_norm=bnorm)


def pass_one_basis_cuda(lay: KKTLayout, b: torch.Tensor, k: int, tol: float,
                        ztol: float, compensated: bool = False,
                        state: Optional[torch.Tensor] = None,
                        phase_clock: Optional[torch.Tensor] = None
                        ) -> Tuple[LanczosDecomposition, torch.Tensor]:
    """K4 (compensated: its K6 instance): K2 that also returns the ``(k,
    n)`` basis, row ``j`` = v_{j+1} and zero beyond ``steps_taken`` (k·n·4
    bytes on the card), in one cooperative launch. ``state`` receives the
    final ``(v_prev, v_curr)``; a ``phase_clock`` of the instance's grid
    the stamps of :func:`phase_split`."""
    bufs = PassOneBuffers.alloc(lay, k, state, persistent=True)
    # zeros, not empty: the kernel stores no row for a step that does not
    # advance, and a garbage row times a zero coefficient is NaN in V·y
    basis = torch.zeros((k, lay.n), dtype=torch.float32, device=lay.d.device)
    _launch_pass_one("tpl_lanczos_pass_one_basis",
                     _comp("lanczos_pass_one_basis", compensated), lay, bufs,
                     b, tol, ztol, int(compensated), _ptr(basis),
                     _clock_ptr(phase_clock, _grid("lanczos_pass_one_basis",
                                                   compensated)))
    return bufs.decomposition(), basis


def _check_chunk(bufs: PassOneBuffers, j0: int, count: int) -> None:
    k = bufs.alphas.shape[0]
    if not (0 <= j0 and 1 <= count and j0 + count <= k):
        raise ValueError(f"chunk [{j0}, {j0 + count}) outside [0, {k})")


def pass_one_chunk_cuda(lay: KKTLayout, bufs: PassOneBuffers,
                        b: torch.Tensor, j0: int, count: int, tol: float,
                        ztol: float, compensated: bool = False,
                        phase_clock: Optional[torch.Tensor] = None) -> None:
    """K5 (compensated: its K6 instance): enqueue steps ``[j0, j0 +
    count)`` of a ``k``-step run on the carried ``bufs`` (``k =
    len(bufs.alphas)``; the persistent scratch) in one cooperative launch;
    ``j0 == 0`` starts from b. α and β land at their global indices;
    nothing is read back. A ``phase_clock`` of the instance's grid, passed
    to every chunk of the run, receives the stamps of :func:`phase_split`
    from the chunks that hold steps ``k // 2`` on."""
    _check_chunk(bufs, j0, count)
    _launch_pass_one("tpl_lanczos_pass_one_chunk",
                     _comp("lanczos_pass_one_chunk", compensated), lay, bufs,
                     b, tol, ztol, int(compensated), j0, count,
                     _clock_ptr(phase_clock, _grid("lanczos_pass_one_chunk",
                                                   compensated)))


def pass_one_steps_cuda(lay: KKTLayout, bufs: PassOneBuffers,
                        b: torch.Tensor, j0: int, count: int, tol: float,
                        ztol: float, basis: Optional[torch.Tensor] = None,
                        compensated: bool = False) -> None:
    """The per-step launches (six a step, a K1 among them) that K2, K4 and
    K5 (``compensated``: their K6 instances) replaced: the reference they
    are held to bit for bit, which no solve calls (counted as
    ``lanczos_pass_one_steps`` with either ``compensated``). Steps ``[j0,
    j0 + count)`` on the carried per-step ``bufs`` as K5 runs them (``j0 ==
    0`` starts from b), storing K4's rows in ``basis`` (a zeroed ``(k, n)``
    f32 tensor) when it is given."""
    _check_chunk(bufs, j0, count)
    k = bufs.alphas.shape[0]
    if basis is not None:
        _need(basis, (k, lay.n), torch.float32, lay.d.device, "basis")
    _launch_pass_one("tpl_lanczos_pass_one_steps", "lanczos_pass_one_steps",
                     lay, bufs, b, tol, ztol, int(compensated),
                     ctypes.c_void_p(None) if basis is None else _ptr(basis),
                     j0, count, per_step=True)


#: steps the phase timer samples, from step k // 2 (``tpl::kTimedSteps``)
TIMED_STEPS = 8
#: the phases of one step of each persistent pass, in order: the timer stamps
#: the step's start and the end of each
PHASES = {"lanczos_pass_one": ("node rows", "arc rows + <v,w>", "barrier 1",
                               "alpha + <w,w>", "barrier 2"),
          "lanczos_pass_two": ("node rows", "arc rows", "barrier")}
# K4, K5, K6's instances of K2, K4 and K5, K9 and K10
# (``ops/kkt_fused_df.py``) step as K2 and K3
PHASES.update({name: PHASES["lanczos_pass_one"] for name in (
    "lanczos_pass_one_comp", "lanczos_pass_one_basis",
    "lanczos_pass_one_basis_comp", "lanczos_pass_one_chunk",
    "lanczos_pass_one_chunk_comp")})
PHASES["df_lanczos_pass_one"] = PHASES["lanczos_pass_one"]
PHASES["df_lanczos_pass_two"] = PHASES["lanczos_pass_two"]


def phase_clock(name: str, device) -> torch.Tensor:
    """A zeroed stamp buffer for the phase timer of pass ``name`` (a key of
    :data:`PHASES`) on the current card's cooperative grid: (TIMED_STEPS,
    blocks, phases + 1) int64 nanoseconds."""
    per_sm, sms = persistent_grid()[name]
    return torch.zeros((TIMED_STEPS, per_sm * sms, len(PHASES[name]) + 1),
                       dtype=torch.int64, device=device)


def phase_split(clock, name: str) -> dict:
    """The phases of pass ``name`` from a filled :func:`phase_clock`: for
    each phase, the matvec phase and the whole step (start to last stamp),
    the max, median and mean over the resident blocks in µs, each averaged
    over the sampled steps; ``tick_ns`` is the smallest step between two
    stamps seen (the timer's resolution, at most)."""
    t = torch.as_tensor(clock).cpu().numpy().astype(np.int64)
    spans = {ph: np.diff(t, axis=2)[:, :, e] for e, ph in
             enumerate(PHASES[name])}
    # the matvec phase, from the step's start to the block's arrival at its
    # first barrier: the node and arc rows of A·v with the elementwise work
    # fused into them, in K2 w -= beta_prev·v_prev and <v, w>, in K3 the
    # update of v_next and x (the same matvec, each pass with its own
    # epilogue)
    spans["matvec phase"] = t[:, :, 2] - t[:, :, 0]
    spans["step"] = t[:, :, -1] - t[:, :, 0]
    out = {ph: {"max_us": float(d.max(axis=1).mean() / 1e3),
                "median_us": float(np.median(d, axis=1).mean() / 1e3),
                "mean_us": float(d.mean() / 1e3)}
           for ph, d in spans.items()}
    seen = np.unique(t)
    gaps = np.diff(seen)
    out["tick_ns"] = int(gaps.min()) if gaps.size else 0
    return out


def persistent_grid() -> dict:
    """The cooperative grids of the persistent passes on the current card,
    K2, K3, K9 and K10 by the names of :data:`PHASES`, K4 and K5 by their
    counters' names, and K6's instances of K2, K4 and K5 by those names
    with ``_comp``: ``{"lanczos_pass_one": (blocks per SM, SMs), ...}``
    (``"lanczos_pass_one_comp"``: K6's K2 instance, as in :data:`PHASES`).
    The passes' sums do not depend on it (``csrc/lanczos_persistent.cuh``)."""
    lib = load_library()
    queries = {name: (name, ()) for name in (
        "lanczos_pass_two", "df_lanczos_pass_one", "df_lanczos_pass_two")}
    for name in ("lanczos_pass_one", "lanczos_pass_one_basis",
                 "lanczos_pass_one_chunk"):
        queries[name] = (name, (0,))
        queries[name + "_comp"] = (name, (1,))
    grids = {}
    for name, (entry, comp) in queries.items():
        per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
        code = getattr(lib, f"tpl_{entry}_grid")(
            *comp, ctypes.byref(per_sm), ctypes.byref(sms))
        _check(lib, code, name)
        grids[name] = (per_sm.value, sms.value)
    return grids


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


def empty_launch_cuda(device) -> None:
    """One launch of a kernel that does nothing (``tpl_empty_launch`` in
    ``csrc/eft_check.cu``) on the current stream of a CUDA ``device``: the
    launch floor that K13's time is set beside. Counted nowhere: it is a
    yardstick, no kernel of a path."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"empty_launch_cuda takes a CUDA device, got "
                         f"{device}")
    lib = load_library()
    _check(lib, lib.tpl_empty_launch(_stream()), "empty_launch")


def pass_two_cuda(lay: KKTLayout, b: torch.Tensor,
                  decomp: LanczosDecomposition, y_full: torch.Tensor,
                  ztol: float, state: Optional[torch.Tensor] = None,
                  phase_clock: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3 (``csrc/lanczos_pass_two.cu``): replay and accumulate for a
    ``(k,)`` or ``(nf, k)`` y in one cooperative launch; returns ``(n,)``
    or ``(nf, n)``. A ``phase_clock`` receives the stamps of
    :func:`phase_split`."""
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
    mv = ctypes.c_int(0)
    code = lib.tpl_lanczos_pass_two(
        *_layout_args(lay), _ptr(b), k, ztol, _ptr(alphas), _ptr(betas),
        _ptr(y2), nf, _ptr(bnorm), _ptr(steps), _ptr(x), _ptr(state[0]),
        _ptr(state[1]), _clock_ptr(phase_clock, "lanczos_pass_two"),
        ctypes.byref(mv), _stream())
    LAUNCHES["kkt_matvec_in_pass"] += mv.value
    _check(lib, code, "lanczos_pass_two")
    LAUNCHES["lanczos_pass_two"] += 1
    return x if y_full.dim() == 2 else x[0]


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------

#: inputs of the EFT tripwire with exact, known outputs (``ops/eft.py``)
_EFT_A, _EFT_B = 1.0 + 2.0 ** -12, 2.0 ** -30


def scaled_y(decomp: LanczosDecomposition, f, k: int) -> torch.Tensor:
    """``f(T_k)e₁·‖b‖``, zero beyond ``steps_taken``: pass two's y, ``(k,)``
    for one function spec and ``(nf, k)`` for a tuple of them."""
    multi = isinstance(f, tuple)
    fs = f if multi else (f,)
    with trace("tpl.f_tk"):
        y = torch.stack([functions.padded_f_e1(decomp, fi) for fi in fs])
        keep = torch.arange(k, device=y.device) < decomp.steps_taken
        y_full = torch.where(keep, y * decomp.b_norm, torch.zeros_like(y))
    return y_full if multi else y_full[0]


def run_chunks(run, k: int, chunk: int, callback, device,
               dtype=torch.float32) -> Tuple[LanczosDecomposition, bool, int]:
    """The host side of a chunked pass one (the fused and the sharded
    solvers' ``pass_one_chunked``), with α, β and ‖b‖ kept in ``dtype``.
    ``run(j0, c)`` runs the ``c`` steps
    from step ``j0`` and returns their α and β (NumPy, indexed from the
    chunk's first step), the steps executed so far, whether the run is still
    live, and ‖b‖. After each chunk ``callback(s, None, (alphas[:s],
    betas[:s-1]))`` is replayed for every new step ``s``; returning False
    stops, which zeroes α from ``s`` and β from ``s-1``; a full run or a
    breakdown keeps β_steps. Returns ``(decomposition, stopped, chunks
    run)``."""
    if k < 1 or chunk < 1:
        raise ValueError("k and chunk must be >= 1")
    alphas = torch.zeros(k, dtype=dtype).numpy()
    betas = torch.zeros(k, dtype=dtype).numpy()
    visited, stopped, chunks = 0, False, 0
    for j0 in range(0, k, chunk):
        a_c, b_c, steps_now, live, b_norm = run(j0, min(chunk, k - j0))
        chunks += 1
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
    decomp = LanczosDecomposition(
        alphas=torch.from_numpy(alphas).to(device),
        betas=torch.from_numpy(betas).to(device),
        steps_taken=torch.tensor(visited, dtype=torch.int32, device=device),
        b_norm=torch.as_tensor(b_norm, dtype=dtype).to(device).reshape(()))
    return decomp, stopped, chunks


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
    versions. f32 only, as the TPU path. The capability methods run on the
    same kernels: :meth:`slq_trace`, :meth:`slq_spectral_density` and
    :meth:`slq_trace_adaptive` one pass one (K2, or K6's instance) per
    probe, :meth:`estimate_interval` ``eigsh`` on the instance's
    ``make_kkt_operator`` (K8), :meth:`chebyshev_fAb` one K1 per degree.
    ``compensated=True`` takes the α, β and ‖b‖ reductions as exact products
    folded in two-float pairs (the plain version: f64-accumulated dots),
    on the card in K6, the compensated instances of K2, K4 and K5, each
    one cooperative launch as theirs; the constructor first checks the
    compiled error-free transformations (K13) and raises if one is not
    exact.
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
        # the host arrays of estimate_interval's KKT operator, and its cache
        self._kkt_arrays = (np.asarray(quad_costs, np.float32),
                            np.asarray(arc_u), np.asarray(arc_v),
                            int(num_nodes))
        self._interval_cache = None
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
        """Pass one: ``k`` masked steps, scalars only (K2 on CUDA, or its
        compensated K6 instance). A ``(2, n)`` ``state`` receives the final
        ``(v_prev, v_curr)``."""
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
        """The O(n·k) pass one (K4 on CUDA, or its K6 instance): the
        decomposition and the ``(k, n)`` basis, row ``j`` = v_{j+1}, zero
        beyond ``steps_taken``. α and β are bitwise those of
        :meth:`pass_one`."""
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
        """Pass one with a live per-step callback (K5 on CUDA, or its K6
        instance): the reference's in-run ``LanczosCallback`` stop.

        Runs ``ceil(k/chunk)`` resumable chunks; after each, the chunk's α,
        β, ``steps``, live flag and ‖b‖ come back in one copy and
        ``callback(s, None, (alphas[:s], betas[:s-1]))`` (NumPy views) is
        replayed for every new step ``s``; returning False stops. A stop at
        ``s`` costs at most ``ceil(s/chunk)·chunk`` matvecs and zeroes α
        from ``s`` and β from ``s-1``; a full run or a breakdown keeps
        β_steps as :meth:`pass_one` does. α and β are bitwise those of
        :meth:`pass_one`.
        """
        b = self.pack(b)
        if self._cuda:
            bufs = PassOneBuffers.alloc(self.layout, k, persistent=True)

            def run(j0, c):
                pass_one_chunk_cuda(self.layout, bufs, b, j0, c, self.tol,
                                    self.ztol, self.compensated)
                packed = torch.cat([
                    bufs.alphas[j0:j0 + c], bufs.betas[j0:j0 + c],
                    bufs.steps.float(), bufs.flags[:1].float(), bufs.bnorm,
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

        decomp, _, _ = run_chunks(run, k, chunk, callback, self.device)
        return decomp

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
        with trace("tpl.solve"):
            b = self.pack(b)
            basis = None
            with trace("tpl.pass_one"):
                if callback is not None:
                    decomp = self.pass_one_chunked(b, k, callback,
                                                   callback_chunk)
                elif method == "one_pass":
                    decomp, basis = self.pass_one_with_basis(b, k)
                else:
                    decomp = self.pass_one(b, k)
            y_full = scaled_y(decomp, f, k)
            if basis is not None:
                with trace("tpl.basis_product"):
                    x = basis_product(y_full, basis)
            else:
                with trace("tpl.pass_two"):
                    x = self.pass_two(b, decomp, y_full)
            if raw:
                return x, decomp
            return x.cpu().numpy(), decomp

    # -- capability methods --------------------------------------------------
    def _slq_pass_one(self, probes, k: int) -> LanczosDecomposition:
        """Pass one for each row of the ``(m, n)`` probes, uploaded once as
        f32: on CUDA one K2 launch (or K6's instance) a probe, on the CPU
        the plain ``pass_one_scan`` with the solver's dot. Returns the
        stacked decomposition the batched quadratures take."""
        if k < 1:
            raise ValueError("k must be >= 1")
        z = torch.as_tensor(probes).to(device=self.device,
                                       dtype=torch.float32).contiguous()
        if z.dim() != 2 or z.shape[1] != self.n:
            raise ValueError(f"probes must be (m, {self.n}), got "
                             f"{tuple(z.shape)}")
        if self._cuda:
            return pass_one_batched_cuda(self.layout, z, k, self.tol,
                                         self.ztol, self.compensated)
        return slq.stack_decompositions(
            [pass_one_scan(self._plain_matvec, row, k, dot=self._dot)[0]
             for row in z])

    def slq_trace(self, f="inv", *, k: int = 50, num_probes: int = 16,
                  key, probe: str = "rademacher") -> slq.SLQResult:
        """``tr f(A)`` by stochastic Lanczos quadrature (the estimator of
        :func:`slq.slq_trace`) with every probe's pass one in the solver's
        kernel: the probes are drawn from ``key`` (a CPU ``torch.Generator``
        or an ``int`` seed) on the CPU, uploaded once, run by one K2 launch
        each, and all quadratures are one batched ``eigh`` on the device."""
        if num_probes < 1:
            raise ValueError("num_probes must be >= 1")
        if not callable(f):
            slq._f_of_theta(torch.ones(1), f)  # reject unknown strings first
        probes = slq._draw_probes(key, num_probes, self.n, torch.float32,
                                  probe)
        decomp = self._slq_pass_one(probes, k)
        return slq.slq_stats(slq.batched_quadratic_form(decomp, f))

    def slq_spectral_density(self, grid, *, sigma=None, k: int = 50,
                             num_probes: int = 16, key,
                             probe: str = "gaussian") -> torch.Tensor:
        """Smoothed spectral density (the estimator of
        :func:`slq.slq_spectral_density`) with the unit probes' pass one in
        the solver's kernel; the probes are normalised in f32 on the CPU.
        Returns a tensor on the solver's device."""
        grid, sigma = slq.validate_dos_params(grid, sigma, num_probes)
        probes = slq._draw_probes(key, num_probes, self.n, torch.float32,
                                  probe)
        probes = probes / torch.linalg.norm(probes, dim=1, keepdim=True)
        decomp = self._slq_pass_one(probes, k)
        return slq.dos_from_decomposition(decomp, grid, sigma)

    def slq_trace_adaptive(self, f="inv", *, k: int = 50, key,
                           probe: str = "rademacher",
                           target_rel_stderr: float = 0.01,
                           batch: int = 8, max_probes: int = 512
                           ) -> slq.SLQResult:
        """:meth:`slq_trace` with the probe count chosen adaptively by the
        shared :func:`slq.adaptive_probe_loop`: ``batch`` probes a round
        through this solver's kernel, from one generator, until the sample
        standard error certifies ``target_rel_stderr`` (or
        ``max_probes``)."""
        return slq.adaptive_probe_loop(
            lambda gen, take: self.slq_trace(
                f, k=k, num_probes=take, key=gen, probe=probe).samples,
            key, batch=batch, max_probes=max_probes,
            target_rel_stderr=target_rel_stderr)

    def estimate_interval(self, *, margin: float = 0.05, tol: float = 1e-3,
                          key=None):
        """Cached spec(A) interval: :func:`algorithms.chebyshev
        .estimate_interval` (two 1-eigenpair ``eigsh`` runs, LA and SA) on
        the f32 ``make_kkt_operator`` of the same arrays on the solver's
        device, whose matvec is K8 on a card. Computed once; later calls
        return the same object."""
        if self._interval_cache is None:
            # operators.py imports this module for KKTLayout
            from two_pass_lanczos_tpu_torch.operators import make_kkt_operator

            d, u, v, p = self._kkt_arrays
            op = make_kkt_operator(d, u, v, p, dtype=torch.float32,
                                   device=self.device)
            self._interval_cache = estimate_interval(
                op, margin=margin, tol=tol, key=key)
        return self._interval_cache

    def chebyshev_fAb(self, b, f, *, degree: int = 100, interval=None,
                      raw: bool = False):
        """Storage-free Chebyshev f(A)·b (:func:`algorithms.chebyshev
        .chebyshev_scan`) on the solver's matvec: ``degree`` K1 launches on
        a card, the plain matvec on the CPU, no basis and no (α, β).
        ``interval`` must hold spec(A); ``None`` takes
        :meth:`estimate_interval` (cached). Returns NumPy, or the device
        tensor when ``raw=True``."""
        if interval is None:
            interval = self.estimate_interval()
        a_lo, a_hi = float(interval[0]), float(interval[1])
        validate_interval_for_f(f, a_lo, a_hi)
        cs = torch.as_tensor(chebyshev_coefficients(f, interval, degree),
                             dtype=torch.float32, device=self.device)
        scale = torch.tensor(
            [2.0 / (a_hi - a_lo), (a_hi + a_lo) / (a_hi - a_lo)],
            dtype=torch.float32, device=self.device)
        b = self.pack(b)
        if self._cuda:
            y = chebyshev_scan(lambda x: kkt_matvec_cuda(self.layout, x), b,
                               cs, scale)
        else:
            y = chebyshev_scan(self._plain_matvec, b, cs, scale)
        return y if raw else y.cpu().numpy()
