"""K14c, the stage probe: K7 (one shard's KKT matvec) with each stage
switched, on the hand-written kernel ``csrc/probe_stages.cu``.

Counterpart of the Pallas probes ``stream_stages.py`` (the streaming matvec
with its gather and scatter each switchable) and ``stream_overlap.py``
(extra ALU or gather work per arc). :func:`stages` takes K7's arguments (a
shard's :class:`KKTLayout` and its local ``[x_a, x_n]``) and a ``mode``
(:data:`MODES`; ``param`` is N for ``"alu"`` and G for ``"gather"``). It
launches the kernel for CUDA tensors (counted in
``LAUNCHES["probe_stages"]``) and runs :func:`stages_plain` for CPU ones.
``"full"`` is bitwise K7; a mode that skips a part leaves it as ``out``
had it (zeros by default), as the plain version does. ``"node_sorted"``
runs the node blocks on :func:`node_sorted_copy` (the signed copy of x_a
in the CSR's entry order, read through the identity index), which
:func:`stages_cuda` takes prebuilt so that a timed launch does not build
it; its y_n is bitwise ``"full"``'s.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from two_pass_lanczos_tpu_torch.ops._build import load_library
from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
    LAUNCHES,
    KKTLayout,
    _check,
    _layout_args,
    _need,
    _ptr,
    _stream,
    kkt_shard_matvec,
)
from two_pass_lanczos_tpu_torch.probes.stream import TINY

__all__ = ["MODES", "ARC_MODES", "NODE_MODES", "SortedCopy",
           "node_sorted_copy", "stages", "stages_cuda", "stages_plain"]

#: the stages (``tpl::StagesMode``)
MODES = {"full": 0, "arc_only": 1, "node_only": 2, "node_no_gather": 3,
         "no_gather": 4, "stream_only": 5, "alu": 6, "gather": 7,
         "node_sorted": 8}
#: the modes that write y_a, and those that write y_n
ARC_MODES = frozenset(MODES) - {"node_only", "node_no_gather", "node_sorted"}
NODE_MODES = frozenset(MODES) - {"arc_only", "stream_only"}
#: the ALU chain's step ``r = r·0.999 + 1e-3`` (``kAluMul``, ``kAluAdd``)
_ALU_MUL, _ALU_ADD = 0.999, 1e-3


def _check_mode(mode: str, param: int, p: int) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, not {mode!r}")
    if param < 0 or (mode == "gather" and param >= p):
        raise ValueError(f"param {param} out of range for mode {mode!r}")


class SortedCopy(NamedTuple):
    """The node-sorted signed copy of x_a that ``"node_sorted"`` reads."""

    index: torch.Tensor  #: (2m,) int32, the identity 0 .. 2m − 1
    xs: torch.Tensor  #: (2m,) xs[q] = x_a[a] for ent[q] = a, −x_a[a] for ~a


def node_sorted_copy(lay: KKTLayout, x: torch.Tensor) -> SortedCopy:
    """x_a copied into the CSR's entry order with each entry's sign: the
    node walk then reads entry q's value at q, contiguous in every row."""
    ent = lay.ent.long()
    vals = x[:lay.m][torch.where(ent >= 0, ent, ~ent)]
    return SortedCopy(
        torch.arange(ent.numel(), dtype=torch.int32, device=x.device),
        torch.where(ent >= 0, vals, -vals))


def _entry_positions(lay: KKTLayout):
    """Each arc's two CSR entries: the position q of ``a`` (its tail) and
    of ``~a`` (its head)."""
    ent = lay.ent.long()
    q = torch.arange(ent.numel(), device=ent.device)
    plus = ent >= 0
    pos_u = torch.empty(lay.m, dtype=torch.long, device=ent.device)
    pos_v = torch.empty_like(pos_u)
    pos_u[ent[plus]] = q[plus]
    pos_v[~ent[~plus]] = q[~plus]
    return pos_u, pos_v


def stages_plain(lay: KKTLayout, x: torch.Tensor, mode: str = "full",
                 param: int = 0, e_scale: float = 1.0) -> torch.Tensor:
    """The plain version of each mode, in the kernel's operation order (the
    node sums by ``index_add_``: another order than the kernel's fixed
    tree, so the node part agrees within 2·deg·ε·Σ|x|). ``"node_sorted"``
    sums its signed copy in the plain K7's order (each arc's tail entry,
    then each arc's head entry), so its y_n is the plain ``"full"``'s."""
    _check_mode(mode, param, lay.p)
    if mode == "full":
        return kkt_shard_matvec(lay, x, e_scale)
    m, p = lay.m, lay.p
    xa, xn = x[:m], x[m:]
    u, v = lay.u.long(), lay.v.long()
    y = torch.zeros_like(x)
    if mode == "stream_only":
        y[:m] = lay.d * xa
    elif mode in ARC_MODES:
        if mode == "no_gather":
            gu = e_scale * (TINY * lay.u.float())
            gv = e_scale * (TINY * lay.v.float())
        else:
            gu, gv = e_scale * xn[u], e_scale * xn[v]
        ya = (lay.d * xa + gu) - gv
        if mode == "alu":
            r = xa.clone()
            for _ in range(param):
                r = r * _ALU_MUL + _ALU_ADD
            ya = ya + TINY * r
        elif mode == "gather":
            acc = torch.zeros_like(xa)
            for g in range(1, param + 1):
                t = u + g
                acc = acc + xn[torch.where(t >= p, t - p, t)]
            ya = ya + TINY * acc
        y[:m] = ya
    if mode in NODE_MODES:
        if mode in ("no_gather", "node_no_gather"):
            terms = TINY * torch.arange(m, device=x.device).float()
        else:
            terms = xa
        s = torch.zeros(p, dtype=x.dtype, device=x.device)
        if mode == "node_sorted":
            xs = node_sorted_copy(lay, x).xs
            pos_u, pos_v = _entry_positions(lay)
            s.index_add_(0, u, xs[pos_u]).index_add_(0, v, xs[pos_v])
        else:
            s.index_add_(0, u, terms).index_add_(0, v, -terms)
        y[m:] = e_scale * s
    return y


def stages_cuda(lay: KKTLayout, x: torch.Tensor, mode: str = "full",
                param: int = 0, e_scale: float = 1.0,
                out: Optional[torch.Tensor] = None,
                copy: Optional[SortedCopy] = None) -> torch.Tensor:
    """K14c for an (m + p,) f32 CUDA x on a CUDA shard layout; ``out``
    receives y (allocated with zeros when None). ``"node_sorted"`` reads
    ``copy`` (:func:`node_sorted_copy` of ``x``; built here when None)."""
    if lay.d.device.type != "cuda":
        raise ValueError(f"probe_stages takes a CUDA layout, not {lay.d.device}")
    _check_mode(mode, param, lay.p)
    _need(x, (lay.n,), torch.float32, lay.d.device, "x")
    if out is None:
        out = torch.zeros_like(x)
    _need(out, (lay.n,), torch.float32, lay.d.device, "out")
    args = _layout_args(lay)
    if mode == "node_sorted":
        if copy is None:
            copy = node_sorted_copy(lay, x)
        _need(copy.index, (2 * lay.m,), torch.int32, lay.d.device,
              "copy.index")
        _need(copy.xs, (2 * lay.m,), torch.float32, lay.d.device, "copy.xs")
        # the node walk reads the identity index and the copy as its x_a
        args = (*args[:4], _ptr(copy.index), *args[5:])
        x = copy.xs
    lib = load_library()
    code = lib.tpl_probe_stages(*args, float(e_scale), _ptr(x),
                                _ptr(out), MODES[mode], int(param), _stream())
    _check(lib, code, "probe_stages")
    LAUNCHES["probe_stages"] += 1
    return out


def stages(lay: KKTLayout, x: torch.Tensor, mode: str = "full",
           param: int = 0, e_scale: float = 1.0) -> torch.Tensor:
    """K14c for a CUDA x, the plain version for a CPU one."""
    if x.is_cuda:
        return stages_cuda(lay, x, mode, param, e_scale)
    return stages_plain(lay, x, mode, param, e_scale)
