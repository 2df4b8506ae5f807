"""Plain reference of x = f(A)·b for the KKT matrix A = [[D, Eᵀ], [E, 0]].

Plain PyTorch and NumPy, written from the mathematics and not from the
program: it imports nothing of ``two_pass_lanczos_tpu_torch``. It takes the
instance's arrays and the right-hand side, builds its own matvec, runs its
own Lanczos recurrence, forms f(T_k)·e₁ and replays the recurrence in a
second pass to accumulate x:

* ``w = A·v_j − β_{j−1}·v_{j−1}``, ``α_j = ⟨v_j, w⟩``, ``w −= α_j·v_j``,
  ``β_j = ‖w‖``; the run stops after step j when ``β_j ≤ tol`` (it then
  took j + 1 steps), else ``v_{j+1} = w / β_j``;
* ``y = f(T_k)·e₁·‖b‖`` over the steps taken, ``x = Σ_j y_j·v_j``.

``E`` is the node–arc incidence (``E[u_j, j] = +1``, ``E[v_j, j] = −1``).
The node block sums each node's incident arcs from a padded table of
indices, one row a node, so every sum has a fixed order and no atomics.

:class:`Precision` names the arithmetic: ``REFERENCE`` is float64
throughout; ``TF32`` is the control (float32 storage and sums, the
operands of every product rounded to TF32's 10-bit mantissa, as a tensor
core takes them; f(T_k)·e₁ in float32).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


class Precision(enum.Enum):
    REFERENCE = "f64"
    TF32 = "tf32"


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Float32 ``t`` rounded to the nearest TF32 value (ties to even)."""
    i = t.contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(i, 13), 1)
    i = torch.bitwise_and(i + (0x0FFF + lsb), -0x2000)
    return i.view(torch.float32)


@dataclasses.dataclass
class Result:
    """One solve of the reference (all on the host, float64)."""

    x: np.ndarray
    alphas: np.ndarray  # (k,), zero beyond steps
    betas: np.ndarray  # (k,), zero beyond the last step that advanced
    b_norm: float
    steps: int


class KKTMatrix:
    """A = [[D, Eᵀ], [E, 0]] from the arrays, on ``device``."""

    def __init__(self, quad_costs, arc_u, arc_v, num_nodes: int, device,
                 precision: Precision = Precision.REFERENCE):
        self.precision = precision
        self.dtype = (torch.float64 if precision is Precision.REFERENCE
                      else torch.float32)
        u = np.asarray(arc_u, np.int64)
        v = np.asarray(arc_v, np.int64)
        self.m, self.p = len(u), int(num_nodes)
        self.n = self.m + self.p
        # the node rows: each node's incident arcs as indices into
        # [x_a, -x_a, 0], padded with the index of the 0
        ends = np.concatenate([u, v])
        signed = np.concatenate([np.arange(self.m), self.m + np.arange(self.m)])
        order = np.argsort(ends, kind="stable")
        deg = np.bincount(ends, minlength=self.p)
        start = np.concatenate([[0], np.cumsum(deg)[:-1]])
        col = np.arange(2 * self.m) - np.repeat(start, deg)
        table = np.full((self.p, max(int(deg.max()), 1)), 2 * self.m, np.int64)
        table[ends[order], col] = signed[order]
        dev = torch.device(device)
        self.d = self._operand(torch.as_tensor(
            np.asarray(quad_costs, np.float64), device=dev).to(self.dtype))
        self.u = torch.as_tensor(u, device=dev)
        self.v = torch.as_tensor(v, device=dev)
        self.table = torch.as_tensor(table, device=dev)

    def _operand(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as an operand of a product in this precision."""
        return round_tf32(t) if self.precision is Precision.TF32 else t

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        x_a, x_n = x[:self.m], x[self.m:]
        y_a = self.d * self._operand(x_a) + (x_n[self.u] - x_n[self.v])
        ext = torch.cat([x_a, -x_a, x_a.new_zeros(1)])
        y_n = ext[self.table].sum(dim=1)
        return torch.cat([y_a, y_n])

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.dot(self._operand(a), self._operand(b))

    def axpy(self, y: torch.Tensor, s: torch.Tensor, x: torch.Tensor
             ) -> torch.Tensor:
        """``y + s·x``."""
        return y + self._operand(s) * self._operand(x)


def f_e1(alphas: np.ndarray, betas: np.ndarray, f: str, dtype) -> np.ndarray:
    """f(T)·e₁ for the tridiagonal T of ``alphas`` and ``betas[:-1]``."""
    k = len(alphas)
    t = (np.diag(alphas) + np.diag(betas[:k - 1], 1)
         + np.diag(betas[:k - 1], -1)).astype(dtype)
    e1 = np.zeros(k, dtype)
    e1[0] = 1
    if f == "inv":
        return np.linalg.solve(t, e1)
    if f == "exp":
        lam, q = np.linalg.eigh(t)
        return q @ (np.exp(lam) * q[0])
    raise ValueError(f"unknown matrix function {f!r}")


def _step(a: KKTMatrix, v: torch.Tensor, v_prev: torch.Tensor,
          beta_prev: torch.Tensor):
    w = a.axpy(a.matvec(v), -beta_prev, v_prev)
    alpha = a.dot(v, w)
    w = a.axpy(w, -alpha, v)
    return alpha, w


def solve(a: KKTMatrix, b, k: int, f: str = "inv",
          tol: float = 0.0) -> Result:
    """x = f(A)·b by k Lanczos steps, two passes, in ``a``'s precision."""
    b = torch.as_tensor(b).to(device=a.d.device, dtype=a.dtype)
    b_norm = torch.sqrt(a.dot(b, b))
    zero = b.new_zeros(())
    alphas = np.zeros(k)
    betas = np.zeros(k)
    steps = 0
    if float(b_norm) > 0:
        v_prev, v, beta_prev = torch.zeros_like(b), b / b_norm, zero
        for j in range(k):
            alpha, w = _step(a, v, v_prev, beta_prev)
            beta = torch.sqrt(a.dot(w, w))
            alphas[j] = float(alpha)
            steps = j + 1
            if float(beta) <= tol:
                break
            betas[j] = float(beta)
            v_prev, v, beta_prev = v, w / beta, beta
    host = np.float64 if a.precision is Precision.REFERENCE else np.float32
    y = np.zeros(k)
    if steps:
        y[:steps] = f_e1(alphas[:steps], betas[:steps], f, host)
    y *= float(b_norm)
    x = pass_two(a, b, b_norm, alphas, betas, y, steps)
    return Result(x=x.cpu().numpy().astype(np.float64), alphas=alphas,
                  betas=betas, b_norm=float(b_norm), steps=steps)


def pass_two(a: KKTMatrix, b: torch.Tensor, b_norm: torch.Tensor,
             alphas: np.ndarray, betas: np.ndarray, y: np.ndarray,
             steps: int) -> torch.Tensor:
    """Replay the recurrence from the stored α and β: x = Σ y_j·v_j."""
    x = torch.zeros_like(b)
    if steps == 0:
        return x
    as_t = lambda s: torch.tensor(s, dtype=a.dtype, device=b.device)  # noqa: E731
    v_prev, v, beta_prev = torch.zeros_like(b), b / b_norm, b.new_zeros(())
    for j in range(steps):
        x = a.axpy(x, as_t(y[j]), v)
        if j + 1 == steps:
            break
        w = a.axpy(a.matvec(v), -beta_prev, v_prev)
        w = a.axpy(w, -as_t(alphas[j]), v)
        beta = as_t(betas[j])
        v_prev, v, beta_prev = v, w / beta, beta
    return x
