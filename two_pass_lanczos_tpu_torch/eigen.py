"""Thick-restart Lanczos eigensolver: extreme eigenpairs in bounded memory.

Counterpart of ``two_pass_lanczos_tpu/eigen.py`` (Wu & Simon, SIAM J.
Matrix Anal. 2000):

* the expansion keeps the full (ncv+1, n) basis on the operator's device
  and orthogonalises every new vector against all of it with CGS2: two
  GEMV sweeps per step (``torch.mv``, which cuBLAS never runs in TF32);
* the projected matrix H (ncv × ncv) is kept dense and eigendecomposed by
  ``torch.linalg.eigh`` on the operator's device, in its dtype;
* the restart contraction ``V_new = S_keepᵀ·V`` and the Ritz vectors are
  ``algorithms.core.basis_product``: one GEMV a row, full f32 whatever the
  caller's TF32 setting (the JAX package asks for ``Precision.HIGHEST``).

Residual bounds come from the Arnoldi relation ``A·V_k = V_k·H +
β·v_{k+1}·e_kᵀ``: ‖A·u_i − θ_i·u_i‖ = β·|S_{k,i}|.

Happy breakdown (an invariant subspace) injects a random vector
orthogonalised against the basis, drawn from ``key`` (a CPU
``torch.Generator`` or an ``int`` seed; ``None`` is seed 0), so the method
keeps hunting for further eigenpairs. The port decides it on the host, one
read of β a step; the JAX package's random bits are not reproduced.

Works with any :class:`~two_pass_lanczos_tpu_torch.operators.LinearOperator`
(real symmetric or complex Hermitian): f64 on the CPU, f32 or f64 on a
card, where a KKT operator's matvec is K8.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.algorithms.core import (
    basis_product,
    breakdown_tolerance,
    inner,
    l2_norm,
)
from two_pass_lanczos_tpu_torch.devices import cpu_generator

__all__ = ["EigshResult", "eigsh"]

_WHICH = ("LA", "SA", "LM", "SM")


class EigshResult(NamedTuple):
    """Converged (or best-effort) extreme eigenpairs.

    * ``eigenvalues`` — shape ``(nev,)``, ascending.
    * ``eigenvectors`` — shape ``(nev, n)``, **rows** are unit Ritz vectors
      matching ``eigenvalues``.
    * ``residual_norms`` — rigorous ‖A·u_i − θ_i·u_i‖₂ per pair.
    * ``restarts`` — number of restart cycles executed.
    * ``converged`` — True iff every returned pair met the tolerance.
    """

    eigenvalues: np.ndarray
    eigenvectors: np.ndarray
    residual_norms: np.ndarray
    restarts: int
    converged: bool


def _project(v: torch.Tensor, w: torch.Tensor, mask: torch.Tensor,
             reduce_sum=None) -> torch.Tensor:
    # ⟨v_i, w⟩ = Σ conj(v_i)·w, one GEMV; conj is a no-op on real dtypes
    c = torch.mv(v.conj(), w)
    if reduce_sum is not None:
        c = reduce_sum(c)
    return c * mask


def _norm(x: torch.Tensor, reduce_sum=None) -> torch.Tensor:
    """‖x‖, its square reduced by ``reduce_sum`` when given."""
    sq = inner(x, x)
    return torch.sqrt(sq if reduce_sum is None else reduce_sum(sq))


def _expand_and_ritz(matvec, v_basis: torch.Tensor, h_proj: torch.Tensor,
                     start: int, gen: torch.Generator, *, reduce_sum=None,
                     inject_mask: Optional[torch.Tensor] = None,
                     inject_fold=None):
    """One restart cycle: grow the basis from ``start`` to ``ncv`` columns
    (CGS2 full orthogonalisation), then Rayleigh–Ritz on the projected H.

    ``v_basis`` is (ncv+1, n) with rows [0, start] valid (row ``start`` is
    the next unit vector to expand with); ``h_proj`` is (ncv, ncv) with the
    leading (start, start) block valid. Both are updated in place. Returns
    ``(theta, S, resid)`` of H on its device.

    The sharding hooks (JAX ``eigen.py:78-79``): with the basis split by
    rows over ranks, ``reduce_sum`` folds the ``(ncv+1,)`` projection
    partials and the squared norms in rank order, ``inject_mask`` (this
    rank's rows, 1 or 0) keeps random injections off the padded rows, and
    ``inject_fold(gen)`` returns the generator this rank draws them from,
    so every rank has its own stream."""
    ncv = h_proj.shape[0]
    rdt = v_basis.dtype
    dev = v_basis.device
    brk = breakdown_tolerance(rdt)
    rows = torch.arange(ncv + 1, device=dev)
    beta_last = 0.0
    for j in range(start, ncv):
        v = v_basis
        w = matvec(v[j])
        mask = (rows <= j).to(rdt)
        c1 = _project(v, w, mask, reduce_sum)
        w = w - torch.mv(v.t(), c1)
        c2 = _project(v, w, mask, reduce_sum)
        w = w - torch.mv(v.t(), c2)
        h_col = (c1 + c2)[:ncv]
        h_proj[:, j] = h_col
        # keep H Hermitian (row j = conj of column j)
        h_proj[j, :] = h_col.conj()
        beta = float(_norm(w, reduce_sum))
        if beta > brk:
            v_basis[j + 1] = w / beta
            coupled = beta
        else:
            # invariant subspace: inject a fresh random direction, CGS2 it
            # against the basis (Wu–Simon §4.2); the coupling is zero, the
            # invariant block decouples exactly
            g = gen if inject_fold is None else inject_fold(gen)
            r = torch.randn(w.shape, generator=g, dtype=rdt).to(dev)
            if inject_mask is not None:
                r = r * inject_mask
            r = r - torch.mv(v.t(), _project(v, r, mask, reduce_sum))
            r = r - torch.mv(v.t(), _project(v, r, mask, reduce_sum))
            nrm = float(_norm(r, reduce_sum))
            v_basis[j + 1] = r / (nrm if nrm > brk else 1.0)
            coupled = 0.0
        if j + 1 < ncv:
            h_proj[j + 1, j] = coupled
            h_proj[j, j + 1] = coupled
        beta_last = coupled
    # beta_last = the j = ncv-1 coupling: ‖remainder‖ of the final column,
    # i.e. A·V[:ncv] = V[:ncv]·H + β_last·v_ncv·e_lastᵀ
    theta, s_vecs = torch.linalg.eigh(h_proj)
    resid = beta_last * s_vecs[ncv - 1, :].abs()
    return theta, s_vecs, resid


def _thick_restart(v_basis: torch.Tensor, theta: torch.Tensor,
                   s_vecs: torch.Tensor, keep_idx: torch.Tensor):
    """Contract the basis to the kept Ritz vectors + the residual direction.

    Returns (V', H') with V'[:ℓ] = S_keepᵀ·V[:ncv], V'[ℓ] = v_{ncv+1},
    H' = diag(θ_keep) in the leading block. The couplings H'[i, ℓ] are not
    written: the next expansion's full orthogonalisation recomputes them
    as ⟨u_i, A·v_ℓ⟩."""
    ncv = v_basis.shape[0] - 1
    ell = keep_idx.shape[0]
    v_new = torch.zeros_like(v_basis)
    v_new[:ell] = _ritz_vectors(v_basis, s_vecs, keep_idx)
    v_new[ell] = v_basis[ncv]
    h_new = torch.zeros((ncv, ncv), dtype=v_basis.dtype,
                        device=v_basis.device)
    idx = torch.arange(ell, device=v_basis.device)
    h_new[idx, idx] = theta[keep_idx].to(v_basis.dtype)
    return v_new, h_new


def _ritz_vectors(v_basis: torch.Tensor, s_vecs: torch.Tensor,
                  sel_idx: torch.Tensor) -> torch.Tensor:
    ncv = v_basis.shape[0] - 1
    return basis_product(s_vecs[:, sel_idx].t(), v_basis[:ncv])


def _select(theta: np.ndarray, count: int, which: str) -> np.ndarray:
    """Indices (into ascending θ) of the ``count`` wanted Ritz values,
    returned in ascending-θ order."""
    if which == "LA":
        idx = np.arange(theta.size - count, theta.size)
    elif which == "SA":
        idx = np.arange(count)
    elif which == "LM":
        idx = np.sort(np.argsort(np.abs(theta))[-count:])
    else:  # SM
        idx = np.sort(np.argsort(np.abs(theta))[:count])
    return idx


def eigsh(operator, nev: int = 6, *, which: str = "LA",
          ncv: Optional[int] = None, tol: float = 1e-8, maxiter: int = 100,
          v0=None, key=None) -> EigshResult:
    """Compute ``nev`` extreme eigenpairs of a self-adjoint operator by
    thick-restart Lanczos in O(ncv·n) memory on its device.

    ``which`` ∈ {"LA", "SA", "LM", "SM"} (largest/smallest algebraic,
    largest/smallest magnitude). ``ncv`` is the restart basis size
    (default ``min(n, max(2·nev + 1, 20))``); each cycle costs ``ncv − ℓ``
    matvecs plus the CGS2 sweeps. Convergence: every wanted pair's
    rigorous residual ``‖A·u − θ·u‖ ≤ tol·max(|θ|_max, 1)``.

    ``v0`` seeds the Krylov space (default: Gaussian from ``key``);
    ``key`` also drives the injections past an invariant subspace
    (default seed 0, so the solve is deterministic for fixed inputs).
    """
    n = operator.shape[0]
    ncv = validate_eigsh_params(n, nev, ncv, which, maxiter)
    # thickness: the standard Wu–Simon midpoint between nev and ncv
    ell = eigsh_thickness(nev, ncv)
    rdt = operator.dtype
    dev = operator.device
    gen = cpu_generator(0 if key is None else key)
    if v0 is None:
        v0 = torch.randn(n, generator=gen, dtype=rdt)
    v0 = torch.as_tensor(v0).to(device=dev, dtype=rdt)
    nrm = float(l2_norm(v0))
    if nrm == 0.0:
        raise ValueError("v0 must be nonzero")

    v_basis = torch.zeros((ncv + 1, n), dtype=rdt, device=dev)
    v_basis[0] = v0 / nrm
    h_proj = torch.zeros((ncv, ncv), dtype=rdt, device=dev)

    def cycle(v, h, start):
        return _expand_and_ritz(operator.matvec, v, h, start, gen)

    theta, vectors, resid, restarts, converged = _eigsh_driver(
        cycle, v_basis, h_proj, nev=nev, ell=ell, which=which, tol=tol,
        maxiter=maxiter)
    return EigshResult(
        eigenvalues=theta,
        eigenvectors=vectors.cpu().numpy(),
        residual_norms=resid,
        restarts=restarts,
        converged=converged,
    )


def _eigsh_driver(cycle, v_basis, h_proj, *, nev, ell, which, tol, maxiter):
    """The restart loop: ``cycle(v, h, start)`` expands in place and
    returns H's ``(theta, S, resid)``; everything host-side here is
    O(ncv) bookkeeping. Returns ``(theta[want], vectors on the device,
    resid[want], restarts, converged)``."""
    start = 0
    restarts = 0
    converged = False
    for it in range(maxiter):
        theta_d, s_d, resid_d = cycle(v_basis, h_proj, start)
        restarts = it + 1
        theta = theta_d.cpu().numpy()
        resid = resid_d.cpu().numpy()
        scale = max(float(np.max(np.abs(theta))), 1.0)
        want = _select(theta, nev, which)
        if np.all(resid[want] <= tol * scale):
            converged = True
            break
        if it < maxiter - 1:
            # want ⊆ keep by construction: both select extremes of the same
            # ordering and ell >= nev
            keep = _select(theta, ell, which)
            v_basis, h_proj = _thick_restart(
                v_basis, theta_d, s_d,
                torch.as_tensor(keep, device=v_basis.device))
            start = ell

    vectors = _ritz_vectors(v_basis, s_d,
                            torch.as_tensor(want, device=v_basis.device))
    return theta[want], vectors, resid[want], restarts, converged


def default_ncv(n: int, nev: int) -> int:
    """The default restart basis size."""
    return min(n, max(2 * nev + 1, 20))


def eigsh_thickness(nev: int, ncv: int) -> int:
    """The Wu–Simon restart thickness ℓ."""
    return min(nev + (ncv - nev) // 2, ncv - 1)


def validate_eigsh_params(n: int, nev: int, ncv: Optional[int],
                          which: str, maxiter: int) -> int:
    """Shared parameter validation; returns the resolved ``ncv``."""
    if which not in _WHICH:
        raise ValueError(f"which must be one of {_WHICH}, got {which!r}")
    if nev < 1:
        raise ValueError("nev must be >= 1")
    if maxiter < 1:
        raise ValueError("maxiter must be >= 1")
    if nev > n:
        raise ValueError(f"nev={nev} exceeds the operator dimension {n}")
    if ncv is None:
        ncv = default_ncv(n, nev)
    if ncv > n:
        raise ValueError(f"ncv={ncv} exceeds the operator dimension {n}")
    if ncv < nev + 1:
        raise ValueError(f"need ncv >= nev + 1 (got ncv={ncv}, nev={nev})")
    return ncv
