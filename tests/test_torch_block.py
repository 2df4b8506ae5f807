"""The port's block Lanczos (``algorithms/block.py``) against the JAX
package's.

The same seeded arrays go through both packages: in f64 (and c128) the
decomposition (``a_blocks``, ``b_blocks``, ``r0``, ``steps_taken``), the
basis and x agree at 1e-10, and JAX's pass-one output, carried across by
``convert.block_decomposition_from_jax``, drives the port's
``block_pass_two`` and ``block_padded_f_e1`` to JAX's own results. The
port is also held to the contracts and thresholds of
``tests/test_block.py``: analytic truths, per-column agreement, multiplicity
resolved in few steps, orthonormality, zero and rank-deficient B, complex
Hermitian A, the relative rank test on a small-norm f32 block, the replay
within 1e-12 and the fixed-shape solver. The row-sharded form is in
``tests/test_torch_sharded_capability.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import two_pass_lanczos_tpu as jtpl
from two_pass_lanczos_tpu.algorithms import block as jblock

from torch_cases import CPU
import two_pass_lanczos_tpu_torch as tpl
from two_pass_lanczos_tpu_torch.algorithms.block import (
    block_padded_f_e1,
    block_pass_one,
    block_pass_two,
    solve_fAb_block,
    solve_fAb_block_jit,
)
from two_pass_lanczos_tpu_torch.convert import block_decomposition_from_jax

T = torch.from_numpy


def _diag_op(d):
    return tpl.DiagonalOperator(np.asarray(d, np.float64), device=CPU)


def _jdiag(d):
    return jtpl.DiagonalOperator(jnp.asarray(d, jnp.float64))


def _rel(x, ref):
    return float(np.linalg.norm(np.asarray(x) - ref) / np.linalg.norm(ref))


def _hermitian_pair(n, d, seed):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    q, _ = np.linalg.qr(m)
    a_np = (q * d) @ q.conj().T
    return (a_np + a_np.conj().T) / 2, q


def _cblock(n, p, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, p)) + 1j * rng.standard_normal((n, p))


# --- against the JAX package -------------------------------------------------

def _real_case():
    n, p, k = 200, 3, 25
    d = np.linspace(0.5, 30.0, n)
    b = np.random.default_rng(11).standard_normal((n, p))
    return _diag_op(d), _jdiag(d), b, k


def _complex_case():
    n, p, k = 48, 2, 24
    d = np.concatenate([[1.0, 1.0, 2.5], np.linspace(3.0, 9.0, n - 3)])
    a_np, _ = _hermitian_pair(n, d, 11)
    return (tpl.DenseOperator(a_np, device=CPU),
            jtpl.DenseOperator(jnp.asarray(a_np)), _cblock(n, p, 12), k)


CASES = {"real": _real_case, "complex": _complex_case}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pass_one_matches_jax(case):
    """At half the solves' k: the complex case's 24 steps of width 2 span
    all of its n = 48, where the last blocks are rounding noise."""
    op, jop, b, k = CASES[case]()
    k //= 2
    dec, basis = block_pass_one(op.matvec, T(b), k)
    jdec, jbasis = jblock.block_pass_one(jop.matvec, jnp.asarray(b), k)
    assert int(dec.steps_taken) == int(jdec.steps_taken) == k
    for field in ("a_blocks", "b_blocks", "r0"):
        np.testing.assert_allclose(getattr(dec, field).numpy(),
                                   np.asarray(getattr(jdec, field)),
                                   rtol=0, atol=1e-10, err_msg=field)
    np.testing.assert_allclose(basis.numpy(), np.asarray(jbasis), atol=1e-10)


@pytest.mark.parametrize("f", ["inv", "exp"])
@pytest.mark.parametrize("method", ["one_pass", "two_pass"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_solvers_match_jax(case, method, f):
    op, jop, b, k = CASES[case]()
    for port, ref in ((solve_fAb_block(op, b, k, f, method=method),
                       jblock.solve_fAb_block(jop, jnp.asarray(b), k, f,
                                              method=method)),
                      (solve_fAb_block_jit(op, b, k=k, f=f, method=method),
                       jblock.solve_fAb_block_jit(jop, jnp.asarray(b), k=k,
                                                  f=f, method=method))):
        assert _rel(port.numpy(), np.asarray(ref)) < 1e-10


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_decomposition_drives_the_port_pass_two(case):
    """JAX's pass one, carried across at the array seam, through the
    port's ``block_padded_f_e1`` and ``block_pass_two``."""
    op, jop, b, k = CASES[case]()
    jdec, _ = jblock.block_pass_one(jop.matvec, jnp.asarray(b), k,
                                    emit_basis=False)
    dec = block_decomposition_from_jax(jdec, device=CPU)
    y = block_padded_f_e1(dec, "inv")
    jy = jblock.block_padded_f_e1(jdec, "inv")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(jy)).max())
    x = block_pass_two(op.matvec, T(b), dec, y)
    jx = jblock.block_pass_two(jop.matvec, jnp.asarray(b), jdec, jy)
    assert _rel(x.numpy(), np.asarray(jx)) < 1e-10


# --- the contracts of tests/test_block.py ------------------------------------

def test_p1_matches_single_vector_recurrence():
    n, k = 200, 30
    d = np.linspace(1.0, 9.0, n)
    b = np.random.default_rng(0).standard_normal(n)
    op = _diag_op(d)
    dec1 = tpl.lanczos_pass_one(op, T(b), k)
    decb, _ = block_pass_one(op.matvec, T(b)[:, None], k)
    assert int(decb.steps_taken) == dec1.steps()
    np.testing.assert_allclose(decb.a_blocks[:, 0, 0].numpy(),
                               dec1.alphas.numpy(), rtol=1e-12)
    np.testing.assert_allclose(decb.b_blocks[:k - 1, 0, 0].numpy(),
                               dec1.betas[:k - 1].numpy(), rtol=1e-11)
    assert float(decb.r0[0, 0]) == pytest.approx(float(dec1.b_norm),
                                                 rel=1e-14)


def test_block_fAB_matches_analytic_exp_and_inv():
    n, p, k = 300, 4, 40
    d = np.linspace(0.5, 6.0, n)
    B = np.random.default_rng(1).standard_normal((n, p))
    for f, truth in (("exp", np.exp(d)[:, None] * B), ("inv", B / d[:, None])):
        x = solve_fAb_block(_diag_op(d), B, k, f)
        assert _rel(x.numpy(), truth) < 1e-10, f


def test_block_matches_per_column_single_solves():
    n, p, k = 250, 3, 50
    d = np.linspace(1.0, 12.0, n)
    B = np.random.default_rng(2).standard_normal((n, p))
    op = _diag_op(d)
    x_blk = solve_fAb_block(op, B, k, "inv").numpy()
    for j in range(p):
        x_col = tpl.solve_fAb(op, T(B[:, j]), k=k, f="inv",
                              method="one_pass").numpy()
        assert _rel(x_blk[:, j], x_col) < 1e-9, j


def test_block_resolves_multiplicity_in_few_steps():
    d = np.array([1.0, 1.0, 2.0, 2.0, 5.0, 5.0] * 20)
    B = np.random.default_rng(3).standard_normal((d.size, 2))
    decomp, _ = block_pass_one(_diag_op(d).matvec, T(B), 10)
    assert 3 <= int(decomp.steps_taken) <= 6
    x = solve_fAb_block(_diag_op(d), B, 10, "inv")
    np.testing.assert_allclose(x.numpy(), B / d[:, None], rtol=1e-10)


def test_basis_block_orthonormality():
    n, p, k = 300, 3, 30
    d = np.linspace(0.1, 40.0, n)
    B = np.random.default_rng(4).standard_normal((n, p))
    decomp, basis = block_pass_one(_diag_op(d).matvec, T(B), k)
    s = int(decomp.steps_taken)
    v = basis.numpy()[:s].transpose(1, 0, 2).reshape(n, s * p)
    assert np.max(np.abs(v.T @ v - np.eye(s * p))) < 1e-8


def test_zero_and_rank_deficient_b():
    op = _diag_op(np.linspace(1.0, 2.0, 16))
    x0 = solve_fAb_block(op, np.zeros((16, 2)), 4, "inv")
    np.testing.assert_array_equal(x0.numpy(), np.zeros((16, 2)))
    col = np.random.default_rng(5).standard_normal(16)
    b_def = np.stack([col, 2.0 * col], axis=1)
    decomp, _ = block_pass_one(op.matvec, T(b_def), 4)
    assert int(decomp.steps_taken) == 0
    np.testing.assert_array_equal(
        solve_fAb_block(op, b_def, 4, "inv", method="two_pass").numpy(), 0.0)


def test_validation():
    op = _diag_op(np.ones(8))
    with pytest.raises(ValueError, match="k must be"):
        block_pass_one(op.matvec, torch.ones(8, 2, dtype=torch.float64), 0)
    with pytest.raises(ValueError, match="must be \\(n, p\\)"):
        block_pass_one(op.matvec, torch.ones(8, dtype=torch.float64), 4)
    with pytest.raises(ValueError, match="block width"):
        block_pass_one(op.matvec, torch.ones(8, 0, dtype=torch.float64), 4)
    with pytest.raises(ValueError, match="unknown function"):
        solve_fAb_block(op, np.ones((8, 2)), 4, "huh")
    with pytest.raises(ValueError, match="unknown method"):
        solve_fAb_block_jit(op, np.ones((8, 2)), k=4, method="three_pass")


def test_complex_hermitian_block():
    n, p, k = 48, 2, 24
    d = np.concatenate([[1.0, 1.0, 2.5], np.linspace(3.0, 9.0, n - 3)])
    a_np, q = _hermitian_pair(n, d, 11)
    B = _cblock(n, p, 12)
    op = tpl.DenseOperator(a_np, device=CPU)
    truth = (q * (1.0 / d)) @ (q.conj().T @ B)
    for method in ("one_pass", "two_pass"):
        x = solve_fAb_block(op, B, k, "inv", method=method).numpy()
        assert _rel(x, truth) < 1e-9, method


def test_complex_block_breakdown_truncates():
    d = np.array([1.0, 1.0, 2.0, 2.0, 5.0, 5.0] * 8)
    a_np, _ = _hermitian_pair(d.size, d, 13)
    B = _cblock(d.size, 2, 14)
    op = tpl.DenseOperator(a_np, device=CPU)
    decomp, _ = block_pass_one(op.matvec, T(B), 10)
    assert int(decomp.steps_taken) == 3
    x = solve_fAb_block(op, B, 10, "inv").numpy()
    lam, q = np.linalg.eigh(a_np)
    truth = (q * (1.0 / lam)) @ (q.conj().T @ B)
    assert _rel(x, truth) < 1e-9


def test_small_norm_f32_block_is_valid_input():
    n, p = 64, 2
    d = np.linspace(1.0, 4.0, n)
    B = (1e-5 * np.random.default_rng(9).standard_normal((n, p))).astype(
        np.float32)
    op = tpl.DiagonalOperator(d.astype(np.float32), device=CPU)
    decomp, _ = block_pass_one(op.matvec, T(B), 20)
    assert int(decomp.steps_taken) > 0
    x = solve_fAb_block(op, B, 20, "inv").double().numpy()
    assert _rel(x, B.astype(np.float64) / d[:, None]) < 1e-4


def test_pass_two_replay_matches_pass_one():
    """The replay regenerates pass one's basis within JAX's 1e-12 bound
    (both passes issue the same calls; the drift is not promised 0)."""
    n, p, k = 200, 3, 25
    d = np.linspace(0.5, 30.0, n)
    B = T(np.random.default_rng(11).standard_normal((n, p)))
    op = _diag_op(d)
    decomp, basis1 = block_pass_one(op.matvec, B, k)
    _, basis2 = block_pass_two(op.matvec, B, decomp,
                               torch.zeros(k, p, p, dtype=B.dtype),
                               emit_basis=True)
    assert float((basis1 - basis2).abs().max()) < 1e-12


def test_two_pass_matches_one_pass_solution():
    n, p, k = 260, 3, 40
    d = np.linspace(0.8, 9.0, n)
    B = np.random.default_rng(12).standard_normal((n, p))
    op = _diag_op(d)
    for f in ("inv", "exp"):
        x1 = solve_fAb_block(op, B, k, f, method="one_pass").numpy()
        x2 = solve_fAb_block(op, B, k, f, method="two_pass").numpy()
        assert _rel(x2, x1) < 1e-12, f
    with pytest.raises(ValueError, match="unknown method"):
        solve_fAb_block(op, B, k, "inv", method="three_pass")


def test_two_pass_after_breakdown():
    d = np.array([1.0, 1.0, 2.0, 2.0, 5.0, 5.0] * 20)
    B = np.random.default_rng(13).standard_normal((d.size, 2))
    x = solve_fAb_block(_diag_op(d), B, 10, "inv", method="two_pass")
    np.testing.assert_allclose(x.numpy(), B / d[:, None], rtol=1e-10)


def test_pass_one_no_basis_mode():
    op = _diag_op(np.linspace(1.0, 5.0, 50))
    B = T(np.random.default_rng(14).standard_normal((50, 2)))
    decomp, basis = block_pass_one(op.matvec, B, 8, emit_basis=False)
    assert basis is None and int(decomp.steps_taken) == 8


class TestFixedShapeBlockSolve:
    def test_matches_host_solver(self):
        n, p, k = 200, 3, 30
        d = np.linspace(0.5, 10.0, n)
        B = np.random.default_rng(61).standard_normal((n, p))
        op = _diag_op(d)
        for f in ("inv", "exp"):
            for method in ("one_pass", "two_pass"):
                x_j = solve_fAb_block_jit(op, B, k=k, f=f, method=method)
                x_h = solve_fAb_block(op, B, k, f, method=method)
                assert _rel(x_j.numpy(), x_h.numpy()) < 1e-10, (f, method)

    def test_breakdown(self):
        d = np.array([1.0, 1.0, 2.0, 2.0, 5.0, 5.0] * 20)
        B = np.random.default_rng(62).standard_normal((d.size, 2))
        x = solve_fAb_block_jit(_diag_op(d), B, k=10, f="inv")
        np.testing.assert_allclose(x.numpy(), B / d[:, None], rtol=1e-9)

    def test_complex_hermitian(self):
        n, p, k = 40, 2, 20
        d = np.linspace(1.0, 6.0, n)
        a_np, q = _hermitian_pair(n, d, 63)
        B = _cblock(n, p, 64)
        x = solve_fAb_block_jit(tpl.DenseOperator(a_np, device=CPU), B, k=k,
                                f="inv", method="two_pass")
        truth = (q * (1.0 / d)) @ (q.conj().T @ B)
        assert _rel(x.numpy(), truth) < 1e-9

    def test_zero_b(self):
        x = solve_fAb_block_jit(_diag_op(np.linspace(1.0, 2.0, 16)),
                                np.zeros((16, 2)), k=4, f="inv")
        np.testing.assert_array_equal(x.numpy(), np.zeros((16, 2)))


def test_package_exports_the_block_names():
    for name in ("BlockDecomposition", "block_pass_one", "block_pass_two",
                 "block_padded_f_e1", "solve_fAb_block",
                 "solve_fAb_block_jit"):
        assert getattr(tpl, name) is getattr(tpl.algorithms, name)
