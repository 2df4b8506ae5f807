"""Stochastic Lanczos quadrature (SLQ): tr f(A) and the spectral density.

Counterpart of ``two_pass_lanczos_tpu/slq.py``. Hutchinson probing with
Gauss quadrature (Ubaru–Chen–Saad):

    tr f(A) = E_z[ zᵀ f(A) z ]  ≈  (1/m) Σ_i ‖z_i‖²·e₁ᵀ f(T_k^{(i)}) e₁

with z_i Rademacher (or Gaussian) probes and T_k^{(i)} the Lanczos
tridiagonal of (A, z_i). The m probes run pass one one after another on
the operator's device (:func:`lanczos_pass_one_batched`, each row exactly
a solo ``pass_one_scan``; JAX vmaps the same scan), and the m quadratures
are one batched ``torch.linalg.eigh`` of the padded (m, k, k)
tridiagonals on that device. The fused solver runs the probes' pass one
in its kernel (``FusedKKTSolver.slq_trace``) and shares the rest.

Randomness: where the JAX package takes a ``jax.random`` key, the port
takes ``key``, a CPU ``torch.Generator`` or an ``int`` seed
(``devices.cpu_generator``). Probes are drawn on the CPU and uploaded
once, so the CPU and the card see the same probes for the same seed.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from two_pass_lanczos_tpu_torch.algorithms.core import (
    LanczosDecomposition,
    pass_one_scan,
)
from two_pass_lanczos_tpu_torch.devices import cpu_generator

__all__ = [
    "SLQResult",
    "lanczos_pass_one_batched",
    "batched_quadratic_form",
    "batched_ritz_weights",
    "slq_trace",
    "slq_trace_adaptive",
    "slq_logdet",
    "slq_spectral_density",
]

FSpec = Union[str, Callable[[torch.Tensor], torch.Tensor]]

#: Diagonal value used to pad T beyond ``steps_taken``. The padded block is
#: exactly decoupled (its couplings are zero), so its eigenpairs carry zero
#: e₁-weight; any finite positive value keeps f ∈ {inv, log} NaN-free on
#: the padding. A valid Ritz value equal to it is harmless: the weights of
#: a degenerate eigenvalue sum to the same total whatever basis eigh picks.
_PAD_DIAG = 1.0


def _f_of_theta(theta: torch.Tensor, f: FSpec) -> torch.Tensor:
    if f == "inv":
        return 1.0 / theta
    if f == "exp":
        return torch.exp(theta)
    if f == "log":
        return torch.log(theta)
    if callable(f):
        return f(theta)
    raise ValueError(f"unknown function spec {f!r} (expected 'inv', 'exp', 'log' or a callable)")


def stack_decompositions(decs: Sequence[LanczosDecomposition]
                         ) -> LanczosDecomposition:
    """m decompositions as one with a leading batch axis: ``alphas`` and
    ``betas`` (m, k), ``steps_taken`` and ``b_norm`` (m,)."""
    return LanczosDecomposition(
        alphas=torch.stack([d.alphas for d in decs]),
        betas=torch.stack([d.betas for d in decs]),
        steps_taken=torch.stack([d.steps_taken for d in decs]),
        b_norm=torch.stack([d.b_norm for d in decs]))


def lanczos_pass_one_batched(operator, bs, k: int) -> LanczosDecomposition:
    """Pass one over a batch of right-hand sides: ``bs`` is ``(m, n)``, row
    i one RHS, moved to the operator's device and dtype. Returns a
    :class:`LanczosDecomposition` with a leading batch axis (``alphas`` and
    ``betas`` (m, k), ``steps_taken`` and ``b_norm`` (m,)); row i is
    ``pass_one_scan`` run alone on row i, so it is bitwise that solo run."""
    if bs.ndim != 2:
        raise ValueError(f"bs must be (m, n), got shape {tuple(bs.shape)}")
    bs = torch.as_tensor(bs).to(device=operator.device, dtype=operator.dtype)
    return stack_decompositions(
        [pass_one_scan(operator.matvec, b, k)[0] for b in bs])


def batched_ritz_weights(decomp: LanczosDecomposition):
    """``(theta, w)`` per batch row: Ritz values (ascending, (m, k)) and
    the Gauss quadrature weights ``w_j = S[0, j]²`` (rows sum to 1 for a
    nonzero RHS), from one batched ``eigh`` on the decomposition's device.

    Rows that broke down early are padded with an exactly decoupled
    diagonal block (its couplings are the zero-padded β entries), so the
    padded eigenpairs carry zero e₁-weight and never enter a quadrature.
    """
    alphas, betas = decomp.alphas, decomp.betas
    steps = torch.atleast_1d(decomp.steps_taken)
    if alphas.dim() == 1:
        alphas, betas = alphas[None], betas[None]
    k = alphas.shape[-1]
    i = torch.arange(k, device=alphas.device)
    diag = torch.where(i[None, :] < steps[:, None], alphas,
                       torch.full((), _PAD_DIAG, dtype=alphas.dtype,
                                  device=alphas.device))
    # betas[j] = β_{j+1}; the valid off-diagonals of T_s are j + 1 < s
    off = torch.where((i[None, :k - 1] + 1) < steps[:, None],
                      betas[:, :k - 1], torch.zeros_like(betas[:, :k - 1]))
    t = torch.diag_embed(diag)
    if k > 1:
        t = t + torch.diag_embed(off, 1) + torch.diag_embed(off, -1)
    theta, s_vecs = torch.linalg.eigh(t)
    return theta, s_vecs[:, 0, :] ** 2


def batched_quadratic_form(decomp: LanczosDecomposition,
                           f: FSpec = "inv") -> torch.Tensor:
    """``‖b‖²·e₁ᵀ f(T_s) e₁`` for every row of a batched decomposition,
    the s-point Gauss quadrature of ``bᵀ f(A) b``, on its device. A solo
    decomposition gives a 0-d tensor. Early breakdown and zero-b rows are
    handled (:func:`batched_ritz_weights`). Host analogue:
    :func:`spectrum.quadratic_form`."""
    solo = decomp.alphas.dim() == 1
    theta, w = batched_ritz_weights(decomp)
    b_norm = torch.atleast_1d(decomp.b_norm)
    quad = (b_norm ** 2) * torch.sum(_f_of_theta(theta, f) * w, dim=-1)
    return quad[0] if solo else quad


class SLQResult(NamedTuple):
    """Trace estimate with its sampling uncertainty.

    * ``estimate`` — mean of the per-probe quadratic forms.
    * ``stderr`` — sample standard error across probes (0 when m == 1):
      the Hutchinson Monte-Carlo uncertainty, not the quadrature bias.
    * ``samples`` — the (m,) per-probe ``‖z_i‖²·e₁ᵀf(T^{(i)})e₁``.
    """

    estimate: torch.Tensor
    stderr: torch.Tensor
    samples: torch.Tensor


def slq_stats(samples: torch.Tensor) -> SLQResult:
    """Fold per-probe estimates into the Hutchinson mean ± standard error."""
    m = samples.shape[0]
    estimate = torch.mean(samples)
    if m > 1:
        var = torch.sum((samples - estimate) ** 2) / (m - 1)
        stderr = torch.sqrt(var / m)
    else:
        stderr = torch.zeros((), dtype=samples.dtype, device=samples.device)
    return SLQResult(estimate=estimate, stderr=stderr, samples=samples)


def _slq_run(operator, probes: torch.Tensor, k: int, f) -> SLQResult:
    decomp = lanczos_pass_one_batched(operator, probes, k)
    return slq_stats(batched_quadratic_form(decomp, f))


def _draw_probes(key, num_probes: int, n: int, dtype: torch.dtype,
                 probe: str) -> torch.Tensor:
    """(num_probes, n) probes of ``dtype`` on the CPU, from ``key``."""
    if probe not in ("rademacher", "gaussian"):
        raise ValueError(f"unknown probe kind {probe!r} (expected 'rademacher' or 'gaussian')")
    gen = cpu_generator(key)
    if probe == "rademacher":
        z = torch.randint(0, 2, (num_probes, n), generator=gen,
                          dtype=torch.int8)
        return z.to(dtype).mul_(2).sub_(1)
    return torch.randn((num_probes, n), generator=gen, dtype=dtype)


def slq_trace(operator, f: FSpec = "inv", *, k: int = 50,
              num_probes: int = 16, key, probe: str = "rademacher"
              ) -> SLQResult:
    """Estimate ``tr f(A)`` by stochastic Lanczos quadrature: ``num_probes``
    pass ones of ``k`` steps on the operator's device, then one batched
    ``eigh`` for all quadratures. ``f`` ∈ {"inv", "exp", "log"} or an
    elementwise callable on a tensor of Ritz values. Rademacher probes
    (default) have the lower variance for nearly diagonal A. ``key`` (a CPU
    ``torch.Generator`` or an ``int`` seed) is required: trace estimates
    are Monte-Carlo, and reproducibility needs caller-owned randomness."""
    if num_probes < 1:
        raise ValueError("num_probes must be >= 1")
    probes = _draw_probes(key, num_probes, operator.shape[0], operator.dtype,
                          probe)
    if not callable(f):
        _f_of_theta(torch.ones(1), f)  # reject unknown strings before the run
    return _slq_run(operator, probes.to(operator.device), k, f)


def slq_trace_adaptive(operator, f: FSpec = "inv", *, k: int = 50, key,
                       probe: str = "rademacher",
                       target_rel_stderr: float = 0.01, batch: int = 8,
                       max_probes: int = 512) -> SLQResult:
    """:func:`slq_trace` with the probe count chosen adaptively: ``batch``
    probes a round until the sample standard error falls below
    ``target_rel_stderr·|estimate|`` or ``max_probes`` is reached. Controls
    the Monte-Carlo error only; the quadrature bias is set by ``k``."""
    n = operator.shape[0]
    if not callable(f):
        _f_of_theta(torch.ones(1), f)

    def run_batch(gen, take):
        probes = _draw_probes(gen, take, n, operator.dtype, probe)
        return _slq_run(operator, probes.to(operator.device), k, f).samples

    return adaptive_probe_loop(
        run_batch, key, batch=batch, max_probes=max_probes,
        target_rel_stderr=target_rel_stderr)


def adaptive_probe_loop(run_batch, key, *, batch: int, max_probes: int,
                        target_rel_stderr: float) -> SLQResult:
    """The adaptive Hutchinson driver of every SLQ tier: call
    ``run_batch(generator, take)`` → per-probe samples, each round with the
    same generator (JAX splits its key instead), until the sample standard
    error certifies ``target_rel_stderr`` (two batches at least: one
    batch's variance estimate is too noisy) or ``max_probes`` is hit.
    The result's tensors are on the CPU."""
    if batch < 2:
        raise ValueError("batch must be >= 2 (variance needs >= 2 samples)")
    if not 0.0 < target_rel_stderr:
        raise ValueError("target_rel_stderr must be > 0")
    if max_probes < 2:
        raise ValueError("max_probes must be >= 2")
    gen = cpu_generator(key)
    samples = []
    m = 0
    while True:
        take = min(batch, max_probes - m)  # never overspend the cap
        samples.append(run_batch(gen, take).detach().cpu().numpy())
        all_s = np.concatenate(samples)
        m = all_s.shape[0]
        est = float(np.mean(all_s))
        stderr = float(np.std(all_s, ddof=1) / np.sqrt(m))
        if m >= min(2 * batch, max_probes) and (
                stderr <= target_rel_stderr * max(abs(est), 1e-300)):
            break
        if m >= max_probes:
            break
    dt = all_s.dtype
    return SLQResult(estimate=torch.from_numpy(np.asarray(est, dt)),
                     stderr=torch.from_numpy(np.asarray(stderr, dt)),
                     samples=torch.from_numpy(all_s))


def dos_from_decomposition(decomp: LanczosDecomposition, grid,
                           sigma) -> torch.Tensor:
    """Smoothed DOS on ``grid`` from a batched (per-probe) decomposition:
    the average of the Gaussian-smoothed k-node spectral measures, the
    Lin–Saad–Yang estimator's second half (the first is any batched pass
    one over unit probes). Runs on the decomposition's device in its
    dtype."""
    theta, w = batched_ritz_weights(decomp)
    grid = torch.as_tensor(grid).to(device=theta.device, dtype=theta.dtype)
    sigma = torch.as_tensor(sigma, dtype=theta.dtype, device=theta.device)
    m = theta.shape[0]
    g = torch.exp(-0.5 * ((grid[None, None, :] - theta[:, :, None])
                          / sigma) ** 2)
    g = g / (sigma * math.sqrt(2.0 * math.pi))
    return torch.sum(w[:, :, None] * g, dim=(0, 1)) / m


def validate_dos_params(grid, sigma, num_probes: int):
    """Shared parameter validation of the DOS estimators; returns the grid
    as a tensor and the resolved ``sigma`` (twice the grid spacing by
    default)."""
    if num_probes < 1:
        raise ValueError("num_probes must be >= 1")
    grid = torch.as_tensor(grid)
    if grid.dim() != 1 or grid.shape[0] < 2:
        raise ValueError("grid must be a 1-D array with at least 2 points")
    if sigma is None:
        sigma = 2.0 * float(grid[1] - grid[0])
    if sigma <= 0.0:
        raise ValueError("sigma must be > 0")
    return grid, float(sigma)


def _dos_run(operator, probes: torch.Tensor, grid, sigma: float, k: int):
    decomp = lanczos_pass_one_batched(operator, probes, k)
    return dos_from_decomposition(decomp, grid, sigma)


def slq_spectral_density(operator, grid, *, sigma: Optional[float] = None,
                         k: int = 50, num_probes: int = 16, key,
                         probe: str = "gaussian") -> torch.Tensor:
    """Smoothed spectral density (density of states) on ``grid``:
    φ_σ(t) ≈ (1/n)·Σ_i N(t; λ_i, σ²), by SLQ with unit-norm probes
    (Lin–Saad–Yang, SIAM Review 2016). Integrates to 1 by construction
    (each probe's weights sum to 1). ``sigma`` defaults to twice the grid
    spacing; k nodes resolve at most k spectral clusters. Returns a tensor
    on the operator's device."""
    grid, sigma = validate_dos_params(grid, sigma, num_probes)
    probes = _draw_probes(key, num_probes, operator.shape[0], operator.dtype,
                          probe).to(operator.device)
    probes = probes / torch.linalg.norm(probes, dim=1, keepdim=True)
    return _dos_run(operator, probes, grid, sigma, k)


def slq_logdet(operator, *, k: int = 50, num_probes: int = 16, key,
               probe: str = "rademacher") -> SLQResult:
    """``log det A = tr log A`` for SPD ``A``."""
    return slq_trace(operator, "log", k=k, num_probes=num_probes, key=key,
                     probe=probe)
