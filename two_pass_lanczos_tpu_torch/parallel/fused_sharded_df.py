"""Arc-sharded double-float f(A)·b on the hand-written shard df matvec (K12).

Counterpart of ``two_pass_lanczos_tpu/parallel/fused_sharded_df.py`` on
``torch.distributed``: the arc-sharded design of ``parallel/fused_sharded.py``
in the double-float arithmetic of ``ops/kkt_fused_df.py``.

* Rank r owns the arcs ``np.array_split(np.arange(m), D)[r]``, held as a
  :class:`~two_pass_lanczos_tpu_torch.algorithms.df.DFKKTOperator` over the
  *global* node ids (the f32 solver's Hopper layout, d as a (2, m_d) hi/lo
  pair); its local vector is the (2, m_d + p) pair ``[x_a of its arcs,
  x_n]``, which each matvec hands K12 as (m_d + p, 2) (hi, lo) pairs (one
  copy a call, as the planes took).
* Each matvec runs K12 over the shard (its plain version on the CPU): the
  arc outputs are local, the node output is the shard's df partial of
  E·x_a. A plain f32 sum of df partials would re-round them to f32, so
  ``parallel/comm.df_gather_fold`` gathers them as one (D, 2, p) buffer and
  folds them with ``df_add`` in rank order (``_df_fold_leading`` of the JAX
  package); a dot gathers its (D, 2) arc partials the same way and adds the
  replicated node block's part. Per step: O(p) bytes, bit-replicated on
  every rank.

The recurrence is ``algorithms/df.py``'s (``_pass_one_df``, ``_pass_two_df``)
over that matvec and dot, eager PyTorch with no host sync; the solve reads
the packed α, β, ‖b‖ back once, solves f(T_k)e₁ on the host in f64 and
uploads the (2, k) y once, as ``DFFusedKKTSolver.solve`` does. Pass two
replays pass one's df update routines, so its hi and lo basis are bitwise
pass one's on every rank.

Not ported: the TPU layout (dual sorted orderings padded to a common R,
the lo planes scattered into them) and the ``streaming`` auto-select by
``DFFusedKKTSolver.MAX_ARCS``, which chose between the VMEM-resident and
the grid-streaming TPU kernels: on Hopper K12 serves every shard size.
``interpret`` has no counterpart.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.algorithms.core import zero_tolerance
from two_pass_lanczos_tpu_torch.algorithms.df import (
    DFDecomposition,
    DFKKTOperator,
    _pass_one_df,
    _pass_two_df,
)
from two_pass_lanczos_tpu_torch.functions import host_f_tk_solve
from two_pass_lanczos_tpu_torch.ops.df import DF, df_add, df_dot
from two_pass_lanczos_tpu_torch.ops.kkt_fused_df import (
    DF_BREAKDOWN_TOL,
    Coeffs,
    df_kkt_shard_matvec,
)
from two_pass_lanczos_tpu_torch.parallel.comm import (
    all_gather_arcs,
    df_gather_fold,
)
from two_pass_lanczos_tpu_torch.parallel.fused_sharded import split_arcs
from two_pass_lanczos_tpu_torch.parallel.mesh import Mesh

__all__ = ["DFShardedFusedKKTSolver"]


def _planes(x: DF, lo: int, hi: Optional[int] = None) -> DF:
    return DF(x.hi[lo:hi], x.lo[lo:hi])


class DFShardedFusedKKTSolver:
    """Distributed double-float two-pass f(A)·b over a 1-D mesh.

    Usage, in every rank of the run::

        mesh = make_mesh()                                # NCCL, one card per rank
        s = DFShardedFusedKKTSolver(d64, u, v, p, mesh)
        x, (alphas64, betas64, steps) = s.solve(b64, k=500, f="inv")

    ``quad_costs`` are f64 (each shard split exactly into hi/lo f32 planes
    on its device) or a ``(hi, lo)`` tuple of f32 planes, taken as it is.
    ``x`` is the full NumPy f64 (n,) array on every rank.
    """

    def __init__(self, quad_costs, arc_u, arc_v, num_nodes, mesh: Mesh):
        self.mesh = mesh
        self.device = mesh.device
        u = np.asarray(arc_u)
        v = np.asarray(arc_v)
        self.m, self.p = len(u), int(num_nodes)
        self.n = self.m + self.p
        self.arc_idx, ix = split_arcs(self.m, mesh)
        self.shard_sizes = [len(i) for i in self.arc_idx]
        self._arc0 = int(ix[0])
        if isinstance(quad_costs, tuple):
            d = tuple(np.asarray(c, np.float32)[ix] for c in quad_costs)
        else:
            d = np.asarray(quad_costs, np.float64)[ix]
        # this rank's shard only, over the global node ids
        self.op = DFKKTOperator(d, u[ix], v[ix], self.p, device=self.device)
        self.layout = self.op.layout
        self.d2 = self.op.d2
        self.m_d = self.layout.m
        self.n_local = self.layout.n
        self.tol = DF_BREAKDOWN_TOL
        self.ztol = zero_tolerance(torch.float32)

    # -- packing ----------------------------------------------------------
    def pack(self, b) -> torch.Tensor:
        """The local (2, m_d + p) hi/lo right-hand side on this rank's
        device from an (n,) f64 b (NumPy, or a tensor anywhere), split on
        the device: hi = f32(b), lo = f32(b − hi). A (2, m_d + p) f32 tensor
        is the packed pair, used in place."""
        if (isinstance(b, torch.Tensor) and b.dtype == torch.float32
                and b.dim() == 2):
            if tuple(b.shape) != (2, self.n_local):
                raise ValueError(f"a packed b must be (2, {self.n_local}), "
                                 f"got {tuple(b.shape)}")
            return b.to(self.device).contiguous()
        t = b if isinstance(b, torch.Tensor) else torch.from_numpy(
            np.asarray(b, np.float64))
        if tuple(t.shape) != (self.n,):
            raise ValueError(f"b must have shape ({self.n},), got "
                             f"{tuple(t.shape)}")
        t = t.to(device=self.device, dtype=torch.float64)
        a0 = self._arc0
        t = torch.cat([t[a0:a0 + self.m_d], t[self.m:]])
        hi = t.to(torch.float32)
        return torch.stack([hi, (t - hi.to(torch.float64)).to(torch.float32)])

    def unpack64(self, xa2: torch.Tensor, xn2: torch.Tensor) -> np.ndarray:
        """The full (n,) f64 x as NumPy on every rank from this rank's
        (2, m_d) arc pair and the replicated (2, p) node pair: one
        all-gather of the arc shards (each padded to the largest)."""
        x2 = torch.cat([all_gather_arcs(xa2, self.shard_sizes, self.mesh),
                        xn2], dim=-1)
        return (x2[0].double() + x2[1].double()).cpu().numpy()

    # -- the per-step collectives -----------------------------------------
    def matvec_df(self, x: DF) -> DF:
        """The local part of the df A·x: K12 (its plain version on the
        CPU), then the df node partials folded across ranks in place of
        y_n. The df passes call it as their operator's matvec."""
        m = self.m_d
        y = df_kkt_shard_matvec(self.op, torch.stack([x.hi, x.lo], -1))
        s = df_gather_fold(y[m:, 0], y[m:, 1], self.mesh)
        y[m:, 0], y[m:, 1] = s.hi, s.lo
        return DF(y[:, 0], y[:, 1])

    def _dot(self, a: DF, b: DF) -> DF:
        """⟨a, b⟩ in double-float over the whole vector: the arc partials
        df-folded across ranks plus the replicated node block's part."""
        m = self.m_d
        arc = df_dot(_planes(a, 0, m), _planes(b, 0, m))
        arc = df_gather_fold(arc.hi, arc.lo, self.mesh)
        return df_add(arc, df_dot(_planes(a, m), _planes(b, m)))

    # -- passes -----------------------------------------------------------
    def pass_one(self, b_rep, k: int,
                 state: Optional[torch.Tensor] = None) -> Coeffs:
        """Pass one over the mesh: ``(αh, αl, βh, βl, bnorm2, steps)``, as
        ``DFFusedKKTSolver.pass_one``. A ``(2, 2, m_d + p)`` ``state``
        receives this rank's final (v_prev, v_curr) pairs."""
        if k < 1:
            raise ValueError("k must be >= 1")
        b2 = self.pack(b_rep)
        dec, _, (vp, vc) = _pass_one_df(self, DF(b2[0], b2[1]), k, False,
                                        dot=self._dot)
        if state is not None:
            state.copy_(torch.stack([torch.stack(vp), torch.stack(vc)]))
        return (dec.alphas.hi, dec.alphas.lo, dec.betas.hi, dec.betas.lo,
                torch.stack([dec.b_norm.hi, dec.b_norm.lo]),
                dec.steps_taken.reshape(1))

    def pass_two(self, b_rep, coeffs: Coeffs, y_h, y_l,
                 state: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Pass two over the mesh: this rank's local x as a (2, m_d + p)
        pair for the (k,) y planes ``y_h``, ``y_l`` (zero beyond
        ``steps_taken``, scaled by ‖b‖)."""
        b2 = self.pack(b_rep)
        y2 = torch.stack([torch.as_tensor(y_h), torch.as_tensor(y_l)]).to(
            device=self.device, dtype=torch.float32)
        ah, al, bh, bl, bnorm2, steps = coeffs
        dec = DFDecomposition(alphas=DF(ah, al), betas=DF(bh, bl),
                              steps_taken=steps.reshape(()),
                              b_norm=DF(bnorm2[0], bnorm2[1]))
        x, _, (vp, vc) = _pass_two_df(self, DF(b2[0], b2[1]), dec,
                                      DF(y2[0], y2[1]), False)
        if state is not None:
            state.copy_(torch.stack([torch.stack(vp), torch.stack(vc)]))
        return torch.stack([x.hi, x.lo])

    # -- solve ------------------------------------------------------------
    def solve(self, b, *, k: int, f="inv", raw: bool = False):
        """Distributed df two-pass f(A)·b. Returns ``(x, (alphas_f64,
        betas_f64, steps))``: x the full NumPy f64 (n,) array on every rank
        (one all-gather of the arc shards), or with ``raw=True`` this rank's
        ``(x_a (2, m_d), x_n (2, p))`` device pairs, with no collective.

        One readback of the packed coefficients, f(T_k)e₁ on the host in
        f64, one upload of the (2, k) y."""
        b2 = self.pack(b)
        coeffs = self.pass_one(b2, k)
        ah, al, bh, bl, bn2, st = coeffs
        pk = torch.cat([ah, al, bh, bl, bn2, st.to(torch.float32)]).cpu()
        pk = pk.numpy().astype(np.float64)  # the one device-to-host copy
        a64 = pk[:k] + pk[k:2 * k]
        b64 = pk[2 * k:3 * k] + pk[3 * k:4 * k]
        steps = int(pk[4 * k + 2])
        if steps == 0:
            x2 = torch.zeros_like(b2)
        else:
            y_full = np.zeros(k)
            y_full[:steps] = (host_f_tk_solve(a64[:steps], b64[:steps - 1], f)
                              * (pk[4 * k] + pk[4 * k + 1]))
            y_h = y_full.astype(np.float32)
            y_l = (y_full - y_h.astype(np.float64)).astype(np.float32)
            y2 = torch.from_numpy(np.stack([y_h, y_l])).to(self.device)
            x2 = self.pass_two(b2, coeffs, y2[0], y2[1])
        coeffs64 = (a64[:steps], b64[:max(steps - 1, 0)], steps)
        m = self.m_d
        if raw:
            return (x2[:, :m], x2[:, m:]), coeffs64
        return self.unpack64(x2[:, :m], x2[:, m:]), coeffs64
