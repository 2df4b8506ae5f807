"""The port's reorthogonalised one-pass Lanczos (``algorithms/reorth.py``
and ``reorth=`` of the generic solvers) against the JAX package's.

The same seeded arrays go through both packages: in f64 α, β and every
basis row agree at 1e-10 (full and selective, real and complex Hermitian),
and the selective run fires its sweeps on the same steps. The port is also
held to the contracts and thresholds of ``tests/test_reorth.py``: the f32
defect below 5e-6 at k = 150 where the plain basis has collapsed, the
selective defect below 2√ε₃₂ with 0 < ``reorth_steps`` < k/2, the benign
selective run bitwise the plain one-pass run, polynomial exactness, the
analytic accuracy, breakdown and zero b, and the API guards. The sharded
form is in ``tests/test_torch_sharded_capability.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import two_pass_lanczos_tpu as jtpl
from two_pass_lanczos_tpu.algorithms.reorth import (
    pass_one_scan_reorth as j_reorth,
    pass_one_scan_selective as j_selective,
)
from two_pass_lanczos_tpu.models.synthetic import (
    create_diagonal_problem as j_diagonal_problem,
)

from torch_cases import CPU
import two_pass_lanczos_tpu_torch as tpl
from two_pass_lanczos_tpu_torch.algorithms.core import pass_one_scan
from two_pass_lanczos_tpu_torch.algorithms.reorth import (
    make_pass_one_step_reorth,
    pass_one_scan_reorth,
    pass_one_scan_selective,
)
from two_pass_lanczos_tpu_torch.errors import InputError
from two_pass_lanczos_tpu_torch.models.synthetic import (
    create_diagonal_problem,
)

T = torch.from_numpy


def _ortho_defect(basis, steps: int) -> float:
    v = np.asarray(basis)[:steps].astype(np.complex128 if np.iscomplexobj(
        np.asarray(basis)) else np.float64)
    g = v.conj() @ v.T
    return float(np.max(np.abs(g - np.eye(steps))))


def _problem(scenario, func, n=500, dtype=torch.float64, seed=0):
    op, eigs = create_diagonal_problem(n, scenario, func, dtype=dtype,
                                       device=CPU)
    b = torch.from_numpy(np.random.default_rng(seed).standard_normal(n)).to(
        dtype)
    return op, np.asarray(eigs), b


def _jax_problem(scenario, func, n=500, dtype=jnp.float64, seed=0):
    op, _ = j_diagonal_problem(n, scenario, func, dtype=dtype)
    b = jnp.asarray(np.random.default_rng(seed).standard_normal(n), dtype)
    return op, b


def _hermitian(n, seed):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    q, _ = np.linalg.qr(m)
    a = (q * np.linspace(-3.0, 5.0, n)) @ q.conj().T
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return (a + a.conj().T) / 2, b


# --- against the JAX package -------------------------------------------------

@pytest.mark.parametrize("mode", ["full", "selective"])
@pytest.mark.parametrize("scenario", ["ill-conditioned", "well-conditioned"])
def test_matches_jax_f64(mode, scenario):
    """α, β, steps and the whole basis at 1e-10 in f64, the ω-recurrence
    firing on the same number of steps."""
    k = 80
    op, _, b = _problem(scenario, "inv")
    jop, jb = _jax_problem(scenario, "inv")
    if mode == "full":
        dec, basis = pass_one_scan_reorth(op.matvec, b, k)
        jdec, jbasis = j_reorth(jop.matvec, jb, k)
    else:
        dec, basis, nre = pass_one_scan_selective(op.matvec, b, k)
        jdec, jbasis, jnre = j_selective(jop.matvec, jb, k)
        assert int(nre) == int(jnre)
    assert dec.steps() == int(jdec.steps_taken) == k
    np.testing.assert_allclose(dec.alphas.numpy(), np.asarray(jdec.alphas),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(dec.betas.numpy(), np.asarray(jdec.betas),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(basis.numpy(), np.asarray(jbasis), rtol=0,
                               atol=1e-10)
    assert float(dec.b_norm) == pytest.approx(float(jdec.b_norm), rel=1e-14)


@pytest.mark.parametrize("mode", ["full", "selective"])
def test_complex_hermitian_matches_jax(mode):
    """Self-adjoint genericity: conjugated projections, real α, β."""
    a, b = _hermitian(64, 7)
    k = 40
    op = tpl.DenseOperator(a, device=CPU)
    jop = jtpl.DenseOperator(jnp.asarray(a))
    if mode == "full":
        dec, basis = pass_one_scan_reorth(op.matvec, T(b), k)
        jdec, jbasis = j_reorth(jop.matvec, jnp.asarray(b), k)
    else:
        dec, basis, _ = pass_one_scan_selective(op.matvec, T(b), k)
        jdec, jbasis, _ = j_selective(jop.matvec, jnp.asarray(b), k)
    assert dec.alphas.dtype == torch.float64
    np.testing.assert_allclose(dec.alphas.numpy(), np.asarray(jdec.alphas),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(dec.betas.numpy(), np.asarray(jdec.betas),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(basis.numpy(), np.asarray(jbasis), atol=1e-10)
    # full: working precision; selective: semi-orthogonality, √ε
    bound = 1e-12 if mode == "full" else 2 * np.sqrt(np.finfo(float).eps)
    assert _ortho_defect(basis, dec.steps()) < bound


@pytest.mark.parametrize("method", ["lanczos", "solve_fAb"])
def test_solvers_match_jax(method):
    op, _, b = _problem("ill-conditioned", "inv")
    jop, jb = _jax_problem("ill-conditioned", "inv")
    if method == "lanczos":
        x = tpl.lanczos(op, b, 60, tpl.make_inv_solver(), reorth=True)
        xj = jtpl.lanczos(jop, jb, 60, jtpl.make_inv_solver(), reorth=True)
    else:
        x = tpl.solve_fAb(op, b, k=60, f="inv", method="one_pass",
                          reorth="selective")
        xj = jtpl.solve_fAb(jop, jb, k=60, f="inv", method="one_pass",
                            reorth="selective")
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(xj)).max())


# --- the contracts of tests/test_reorth.py -----------------------------------

class TestOrthogonality:
    def test_restored_at_large_k_f32(self):
        op, _, b = _problem("ill-conditioned", "inv", dtype=torch.float32)
        k = 150
        d0, v0 = pass_one_scan(op.matvec, b, k, emit_basis=True)
        d1, v1 = pass_one_scan_reorth(op.matvec, b, k)
        assert d0.steps() == k and d1.steps() == k
        plain = _ortho_defect(v0, k)
        reorth = _ortho_defect(v1, k)
        assert plain > 1e-2, f"plain basis unexpectedly orthogonal: {plain}"
        assert reorth < 5e-6, f"reorth defect {reorth:.2e}"

    def test_extra_sweeps_accepted(self):
        op, _, b = _problem("ill-conditioned", "inv", dtype=torch.float32)
        _, v = pass_one_scan_reorth(op.matvec, b, 60, sweeps=3)
        assert _ortho_defect(v, 60) < 5e-6

    def test_step_factory_is_the_scan(self):
        op, _, b = _problem("ill-conditioned", "inv")
        dec, basis = pass_one_scan_reorth(op.matvec, b, 12)
        from two_pass_lanczos_tpu_torch.algorithms.core import _start
        step = make_pass_one_step_reorth(op.matvec, b.dtype)
        state = (_start(b, torch.dot), torch.zeros(12, b.shape[0],
                                                   dtype=b.dtype))
        for j in range(12):
            state, (a, bt) = step(state, j)
            assert torch.equal(a, dec.alphas[j]) and torch.equal(
                bt, dec.betas[j])
        assert torch.equal(state[1], basis)


class TestAgreementWithPlain:
    def test_f64_small_k_coefficients_match(self):
        op, _, b = _problem("well-conditioned", "inv")
        d0, _ = pass_one_scan(op.matvec, b, 20, emit_basis=True)
        d1, _ = pass_one_scan_reorth(op.matvec, b, 20)
        np.testing.assert_allclose(d1.alphas.numpy(), d0.alphas.numpy(),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(d1.betas.numpy(), d0.betas.numpy(),
                                   rtol=1e-10, atol=1e-12)

    def test_f32_stability_at_large_k(self):
        """The plain f32 error jumps between nearby k past stagnation; the
        reorthogonalised one is a stable function of k."""
        op, eigs, b = _problem("ill-conditioned", "inv", dtype=torch.float32)
        x_true = (1.0 / eigs) * b.double().numpy()
        nrm = np.linalg.norm(x_true)

        def err(k, reorth):
            x = tpl.solve_fAb(op, b, k=k, f="inv", method="one_pass",
                              reorth=reorth)
            return np.linalg.norm(x.double().numpy() - x_true) / nrm

        ks = [240, 280, 320, 360]
        errs_p = [err(k, False) for k in ks]
        errs_r = [err(k, True) for k in ks]
        assert max(errs_r) < 0.5, f"reorth errors {errs_r}"
        assert max(errs_r) / min(errs_r) < 1.5, f"not stable: {errs_r}"
        assert max(errs_p) / min(errs_p) > 3.0, (
            f"plain f32 unexpectedly stable ({errs_p})")


class TestAccuracyContracts:
    def test_polynomial_exactness(self):
        op, eigs, b = _problem("well-conditioned", "inv", n=200)
        coeffs = [0.3, -1.2, 0.5, 0.01]
        x = tpl.lanczos(op, b, 8, tpl.make_poly_solver(coeffs), reorth=True)
        f_lam = sum(c * eigs ** i for i, c in enumerate(coeffs))
        x_true = f_lam * b.numpy()
        assert np.linalg.norm(x.numpy() - x_true) / np.linalg.norm(
            x_true) < 1e-12

    @pytest.mark.parametrize("func", ["inv", "exp"])
    def test_analytic_accuracy(self, func):
        n = 100
        eigs = np.arange(1.0, n + 1.0)
        b = np.random.default_rng(12345).standard_normal(n)
        op = tpl.DiagonalOperator(eigs, device=CPU)
        solver = (tpl.make_inv_solver() if func == "inv"
                  else tpl.make_exp_solver())
        x = tpl.lanczos(op, b, 30, solver, reorth=True)
        x_true = (1.0 / eigs if func == "inv" else np.exp(eigs)) * b
        assert np.linalg.norm(x.numpy() - x_true) / np.linalg.norm(
            x_true) < 1e-3

    def test_solve_fAb_matches_host_path(self):
        op, _, b = _problem("well-conditioned", "inv")
        x_host = tpl.lanczos(op, b, 30, tpl.make_inv_solver(), reorth=True)
        x_fast = tpl.solve_fAb(op, b, k=30, f="inv", method="one_pass",
                               reorth=True)
        np.testing.assert_allclose(x_fast.numpy(), x_host.numpy(), rtol=0,
                                   atol=1e-12 * x_host.abs().max().item())

    def test_multi_f_through_reorth(self):
        op, _, b = _problem("well-conditioned", "inv")
        x_pair = tpl.solve_fAb(op, b, k=30, f=("inv", "exp"),
                               method="one_pass", reorth=True)
        assert tuple(x_pair.shape) == (2,) + tuple(b.shape)
        for i, f in enumerate(("inv", "exp")):
            x_one = tpl.solve_fAb(op, b, k=30, f=f, method="one_pass",
                                  reorth=True)
            np.testing.assert_allclose(
                x_pair[i].numpy(), x_one.numpy(), rtol=0,
                atol=1e-13 * x_one.abs().max().item())


class TestDegenerateInputs:
    def test_breakdown_invariant_subspace(self):
        n, d, k = 64, 5, 12
        eigs = np.linspace(1.0, 2.0, n)
        op = tpl.DiagonalOperator(eigs, device=CPU)
        b = np.zeros(n)
        b[:d] = [1.0, -2.0, 0.5, 3.0, -1.5]
        decomp, basis = pass_one_scan_reorth(op.matvec, T(b), k)
        assert decomp.steps() == d
        np.testing.assert_array_equal(basis.numpy()[d:], 0.0)
        x = tpl.solve_fAb(op, b, k=k, f="inv", method="one_pass",
                          reorth=True)
        np.testing.assert_allclose(x.numpy(), b / eigs, rtol=0, atol=1e-12)

    def test_zero_b(self):
        op = tpl.DiagonalOperator(np.ones(16), device=CPU)
        x = tpl.solve_fAb(op, np.zeros(16), k=4, f="inv", method="one_pass",
                          reorth=True)
        np.testing.assert_array_equal(x.numpy(), 0.0)


class TestApiGuards:
    def test_reorth_requires_one_pass(self):
        op, _, b = _problem("well-conditioned", "inv", n=32)
        with pytest.raises(ValueError, match="one_pass"):
            tpl.solve_fAb(op, b, k=4, f="inv", method="two_pass",
                          reorth=True)

    def test_reorth_rejects_callback(self):
        op, _, b = _problem("well-conditioned", "inv", n=32)
        with pytest.raises(InputError, match="callback"):
            tpl.lanczos(op, b, 4, tpl.make_inv_solver(), reorth=True,
                        callback=lambda *a: True)

    def test_bad_params(self):
        op = tpl.DiagonalOperator(np.ones(8), device=CPU)
        b = torch.ones(8, dtype=torch.float64)
        with pytest.raises(ValueError):
            pass_one_scan_reorth(op.matvec, b, 0)
        with pytest.raises(ValueError):
            pass_one_scan_reorth(op.matvec, b, 4, sweeps=0)
        with pytest.raises(ValueError):
            pass_one_scan_selective(op.matvec, b, 4, sweeps=0)


class TestSelective:
    def test_benign_spectrum_bit_identical_to_plain(self):
        op, _, b = _problem("well-conditioned", "inv")
        dec_p, bas_p = pass_one_scan(op.matvec, b, 40, emit_basis=True)
        dec_s, bas_s, nre = pass_one_scan_selective(op.matvec, b, 40)
        assert int(nre) == 0
        assert torch.equal(dec_p.alphas, dec_s.alphas)
        assert torch.equal(dec_p.betas, dec_s.betas)
        assert torch.equal(bas_p, bas_s)

    def test_semi_orthogonality_at_fraction_of_sweeps_f32(self):
        n, k = 500, 300
        d = np.concatenate([np.linspace(-1.0, -1e-4, n // 2),
                            np.linspace(1e-4, 1.0, n - n // 2)])
        op = tpl.DiagonalOperator(d.astype(np.float32), device=CPU)
        b = T(np.random.default_rng(1).standard_normal(n).astype(np.float32))
        dec_p, bas_p = pass_one_scan(op.matvec, b, k, emit_basis=True)
        dec_s, bas_s, nre = pass_one_scan_selective(op.matvec, b, k)
        defect_plain = _ortho_defect(bas_p, dec_p.steps())
        defect_sel = _ortho_defect(bas_s, dec_s.steps())
        sqrt_eps32 = float(np.sqrt(np.finfo(np.float32).eps))
        assert defect_plain > 0.01
        assert defect_sel < 2 * sqrt_eps32, defect_sel
        assert 0 < int(nre) < k // 2, int(nre)

    def test_solve_fAb_selective_accuracy(self):
        n, k = 400, 120
        d = np.linspace(0.5, 20.0, n)
        op = tpl.DiagonalOperator(d, device=CPU)
        b = np.random.default_rng(2).standard_normal(n)
        x = tpl.solve_fAb(op, b, k=k, f="inv", method="one_pass",
                          reorth="selective")
        np.testing.assert_allclose(x.numpy(), b / d, rtol=1e-9)

    def test_lanczos_api_accepts_selective(self):
        op, _, b = _problem("well-conditioned", "inv")
        x_sel = tpl.lanczos(op, b, 40, tpl.make_inv_solver(),
                            reorth="selective")
        x_plain = tpl.lanczos(op, b, 40, tpl.make_inv_solver())
        assert torch.equal(x_sel, x_plain)

    def test_reorth_mode_validation(self):
        op, _, b = _problem("well-conditioned", "inv")
        with pytest.raises(ValueError, match="reorth must be"):
            tpl.lanczos(op, b, 20, tpl.make_inv_solver(), reorth="maybe")
        with pytest.raises(ValueError, match="reorth must be"):
            tpl.solve_fAb(op, b, k=20, method="one_pass", reorth="maybe")

    def test_breakdown_and_zero_b(self):
        op = tpl.DiagonalOperator(np.array([2.0, 3.0]), device=CPU)
        dec, _, nre = pass_one_scan_selective(
            op.matvec, torch.tensor([1.0, 0.0], dtype=torch.float64), 2)
        assert dec.steps() == 1 and int(nre) == 0
        dec0, _, _ = pass_one_scan_selective(
            op.matvec, torch.zeros(2, dtype=torch.float64), 2)
        assert dec0.steps() == 0
