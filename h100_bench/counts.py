"""Frozen operation and byte counts of the measured kernels.

Every count follows one rule: each input byte is read once and each output
byte written once, whatever the kernel reads again; operations are the
float32 operations the mathematics needs for the steps taken. An instance
has m arcs and p nodes, n = m + p; a value is 4 bytes (f32), an index 4
bytes (int32 holds every index of these sizes).

The KKT matrix is given by its arrays d (m values), u and v (m indices
each): 12·m bytes. One product y = A·x reads them and x (4·n) and writes y
(4·n): 20·m + 8·p bytes; y_a = d·x_a + x_n[u] − x_n[v] is 3·m operations
and y_n, each arc added at one end and subtracted at the other, 2·m.
"""

from __future__ import annotations


def kkt_matvec(m: int, p: int) -> tuple:
    """(operations, bytes) of y = A·x."""
    n = m + p
    return 5 * m, 12 * m + 8 * n


def pass_one(m: int, p: int, steps: int, basis: bool = False) -> tuple:
    """(operations, bytes) of pass one: ‖b‖ and v₁ (3·n), then per step
    the product (5·m), w −= β·v_prev, α = ⟨v, w⟩, w −= α·v and ‖w‖ (2·n
    each) and v = w·(1/β) (n). Reads the matrix and b; writes α, β, ‖b‖
    and the step count, and with ``basis`` the steps' rows of V (4·n
    each)."""
    n = m + p
    ops = 3 * n + steps * (5 * m + 9 * n)
    nbytes = 12 * m + 4 * n + 8 * steps + 8
    if basis:
        nbytes += 4 * n * steps
    return ops, nbytes


def pass_two(m: int, p: int, steps: int) -> tuple:
    """(operations, bytes) of pass two: v₁ from b (n), x += y_j·v_j at
    every step (2·n), and between steps the product and w −= β·v_prev,
    w −= α·v (2·n each), v = w·(1/β) (n). Reads the matrix, b, α, β and
    y; writes x."""
    n = m + p
    ops = n + 2 * n * steps + max(steps - 1, 0) * (5 * m + 5 * n)
    nbytes = 12 * m + 4 * n + 12 * steps + 4 * n
    return ops, nbytes


def basis_product(n: int, k: int) -> tuple:
    """(operations, bytes) of x = Vᵀ·y for a (k, n) basis."""
    return 2 * k * n, 4 * k * n + 4 * k + 4 * n


def coo_spmv(n: int, nnz: int) -> tuple:
    """(operations, bytes) of y = A·x over a sparse matrix of ``nnz``
    nonzeros: a value and a column index each, n + 1 row pointers, x, y."""
    return 2 * nnz, 8 * nnz + 4 * (n + 1) + 8 * n


def kkt_nnz(m: int) -> int:
    """Nonzeros of the assembled KKT matrix: D's m, E's and Eᵀ's 2·m each."""
    return 5 * m


def least_seconds(ops: float, nbytes: float, peak: dict) -> float:
    """The least time the chip could take: the larger of the operations at
    the f32 peak and the bytes at the memory bandwidth."""
    return max(ops / peak["f32_flops"], nbytes / peak["hbm_bytes_per_s"])
