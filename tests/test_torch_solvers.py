"""The port's generic tier (``solvers.py``, ``algorithms/{one_pass,
two_pass,chunked}.py``, the ``functions.py`` closures) against the JAX
package on the CPU, on the same seeded NumPy inputs.

Thresholds are the JAX package's own: α and β at rtol 1e-12 in f64 with
``steps_taken`` and ‖b‖ equal; x at the thresholds of
``tests/test_correctness.py`` (1e-3 for analytic functions, 1e-12 where the
answer is exact); the slice as a whole, ``solve_fAb`` on the KKT operator,
at rel 1e-5 in f32 against the Pallas kernel in the interpreter (two f32
implementations whose node sums round in different orders) and at rel 1e-12
in f64 against the JAX f64 operator.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import two_pass_lanczos_tpu as jtpl
import two_pass_lanczos_tpu_torch as tpl
from tests.torch_cases import CPU, random_kkt
from two_pass_lanczos_tpu_torch.algorithms.core import pass_one_scan
from two_pass_lanczos_tpu_torch.utils.data_loader import load_kkt_arrays

N = 100
K = 30
TOL_ANALYTIC = 1e-3
TOL_POLY = 1e-12
REPO = Path(__file__).resolve().parents[1]


def _rel(x, ref):
    return float(np.linalg.norm(np.asarray(x) - ref) / np.linalg.norm(ref))


def _problem():
    """The analytic problem of tests/test_correctness.py."""
    eigs = np.arange(1.0, N + 1.0)
    b = np.random.default_rng(12345).standard_normal(N)
    return tpl.DiagonalOperator(eigs, device=CPU), b, eigs


CASES = [
    ("inv", tpl.make_inv_solver(), lambda lam: 1.0 / lam, TOL_ANALYTIC),
    ("exp", tpl.make_exp_solver(), np.exp, TOL_ANALYTIC),
    ("poly2", tpl.make_poly_solver([0.0, 0.0, 1.0]), lambda lam: lam ** 2,
     TOL_POLY),
]


@pytest.mark.parametrize("name,solver,f_scalar,tol", CASES,
                         ids=[c[0] for c in CASES])
@pytest.mark.parametrize("method", ["one_pass", "two_pass"])
def test_correctness_vs_analytic(name, solver, f_scalar, tol, method):
    op, b, eigs = _problem()
    x_true = f_scalar(eigs) * b
    run = tpl.lanczos if method == "one_pass" else tpl.lanczos_two_pass
    x = run(op, b, K, solver)
    assert x.dtype == torch.float64 and x.device == CPU
    assert _rel(x.numpy(), x_true) < tol


@pytest.mark.parametrize("f", ["exp", "inv"])
@pytest.mark.parametrize("method", ["one_pass", "two_pass"])
def test_fast_path_matches_host_path(f, method):
    op, b, _ = _problem()
    solver = tpl.make_exp_solver() if f == "exp" else tpl.make_inv_solver()
    run = tpl.lanczos if method == "one_pass" else tpl.lanczos_two_pass
    host = run(op, b, K, solver).numpy()
    fast = tpl.solve_fAb(op, b, k=K, f=f, method=method).numpy()
    assert _rel(fast, host) < 1e-12
    # and the JAX package's fast path on the same inputs
    jop = jtpl.DiagonalOperator(jnp.asarray(np.arange(1.0, N + 1.0)))
    ref = np.asarray(jtpl.solve_fAb(jop, jnp.asarray(b), k=K, f=f,
                                    method=method))
    assert _rel(fast, ref) < 1e-12


def test_one_pass_vs_two_pass_deviation_machine_eps():
    op, b, _ = _problem()
    solver = tpl.make_exp_solver()
    x1 = tpl.lanczos(op, b, K, solver).numpy()
    x2 = tpl.lanczos_two_pass(op, b, K, solver).numpy()
    assert _rel(x1, x2) < 1e-13


def test_doctest_example_4x4():
    a = np.array([[2.0, 1, 0, 0], [1, 3, 1, 0], [0, 1, 4, 1], [0, 0, 1, 5]])
    b = np.array([1.0, 2.0, 3.0, 4.0])
    op = tpl.as_operator(a, device=CPU)
    solver = tpl.make_inv_solver()
    x1 = tpl.lanczos(op, b, 4, solver).numpy()
    x2 = tpl.lanczos_two_pass(op, b, 4, solver).numpy()
    np.testing.assert_allclose(x1, np.linalg.solve(a, b), atol=1e-12)
    np.testing.assert_allclose(x1, x2, atol=1e-12)


def test_breakdown_truncates_solution_gracefully():
    diag = np.array([2.0, 2.0, 5.0, 5.0, 7.0])
    b = np.array([1.0, 0.0, 1.0, 0.0, 0.0])
    op = tpl.DiagonalOperator(diag, device=CPU)
    x = tpl.lanczos_two_pass(op, b, 5, tpl.make_inv_solver())
    np.testing.assert_allclose(x.numpy(), b / diag, atol=1e-12)
    assert tpl.lanczos_pass_one(op, torch.from_numpy(b), 5).steps() == 2
    with pytest.raises(tpl.BreakdownError):
        tpl.lanczos_two_pass(op, b, 5, tpl.make_inv_solver(),
                             strict_breakdown=True)
    x1, basis = tpl.lanczos_two_pass(op, b, 5, tpl.make_inv_solver(),
                                     return_basis=True)
    assert tuple(basis.shape) == (5, 5)
    assert bool((basis[2:] == 0).all())
    assert torch.equal(x1, x)


def test_complex_hermitian_support():
    rng = np.random.default_rng(7)
    n, k = 40, 40
    m = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    a = (m + m.conj().T) / 2
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    lam, q = np.linalg.eigh(a)
    x_true = q @ (np.exp(lam) * (q.conj().T @ b))
    op = tpl.DenseOperator(a, device=CPU)
    x = tpl.lanczos_two_pass(op, b, k, tpl.make_exp_solver())
    assert x.dtype == torch.complex128
    assert _rel(x.numpy(), x_true) < 1e-10
    # α, β real, and the JAX package's at rtol 1e-12
    dec = tpl.lanczos_pass_one(op, torch.from_numpy(b), 12)
    ref = jtpl.lanczos_pass_one(jtpl.DenseOperator(jnp.asarray(a)),
                                jnp.asarray(b), 12)
    assert dec.alphas.dtype == torch.float64
    np.testing.assert_allclose(dec.alphas_valid(), ref.alphas_valid(),
                               rtol=1e-12)
    np.testing.assert_allclose(dec.betas_valid(), ref.betas_valid(),
                               rtol=1e-12)
    np.testing.assert_allclose(float(dec.b_norm), float(ref.b_norm),
                               rtol=1e-15)


def test_baseline_config1_exp_on_vendored_kkt():
    """BASELINE config 1: exp(A)b one-pass on a vendored netgen KKT pair,
    k = 100, f64, against a dense eigendecomposition oracle."""
    dmx = sorted((REPO / "data" / "1000").glob("*.dmx"))[0]
    arrays = load_kkt_arrays(dmx, dmx.with_suffix(".qfc"))
    m, p, n = arrays.num_arcs, arrays.num_nodes, arrays.n
    dsc = arrays.quad_costs / float(np.max(arrays.quad_costs))
    op = tpl.make_kkt_operator(dsc, arrays.arc_u, arrays.arc_v, p,
                               dtype=torch.float64, device=CPU)
    b = np.random.default_rng(7).standard_normal(n)
    x = tpl.solve_fAb(op, b, k=100, f="exp", method="one_pass").numpy()
    a = np.zeros((n, n))
    a[np.arange(m), np.arange(m)] = dsc
    a[arrays.arc_u + m, np.arange(m)] += 1.0
    a[arrays.arc_v + m, np.arange(m)] -= 1.0
    a[np.arange(m), arrays.arc_u + m] += 1.0
    a[np.arange(m), arrays.arc_v + m] -= 1.0
    lam, q = np.linalg.eigh(a)
    assert _rel(x, q @ (np.exp(lam) * (q.T @ b))) < 1e-6


def test_errors_of_the_reference_taxonomy():
    op = tpl.DiagonalOperator(np.ones(4), device=CPU)
    with pytest.raises(tpl.DimensionMismatchError):
        tpl.lanczos(op, np.ones(5), 3, tpl.make_inv_solver())
    with pytest.raises(tpl.InputError):
        tpl.lanczos_two_pass(op, np.ones(4), 0, tpl.make_inv_solver())
    op8 = tpl.DiagonalOperator(np.arange(1.0, 9.0), device=CPU)
    with pytest.raises(tpl.ParameterMismatchError):
        tpl.lanczos(op8, np.ones(8), 4, lambda a, bb: np.ones(99))
    with pytest.raises(tpl.SolverError):
        tpl.lanczos(op8, np.ones(8), 4, lambda a, bb: 1 / 0)
    for run in (tpl.lanczos, tpl.lanczos_two_pass):
        with pytest.raises(tpl.InputError, match="zero vector"):
            run(op8, np.zeros(8), 4, tpl.make_inv_solver())
    # the fast path degrades a zero b to a zero x
    np.testing.assert_array_equal(
        tpl.solve_fAb(op8, np.zeros(8), k=4, f="inv").numpy(), 0.0)
    with pytest.raises(ValueError, match="method"):
        tpl.solve_fAb(op8, np.ones(8), k=4, method="three_pass")


def test_small_norm_b_is_not_rejected():
    diag = np.arange(1.0, 65.0, dtype=np.float32)
    op = tpl.DiagonalOperator(diag, device=CPU)
    b = (np.arange(64) % 3 + 1).astype(np.float32) * np.float32(1e-6)
    x = tpl.solve_fAb(op, b, k=40, f="inv", method="two_pass")
    assert x.dtype == torch.float32
    assert _rel(x.numpy(), b / diag) < 1e-3
    with pytest.raises(tpl.InputError):
        tpl.lanczos_two_pass(op, np.zeros(64, np.float32), 5,
                             tpl.make_inv_solver())


def test_pass_two_small_norm_f32_direct():
    n, k = 64, 40
    diag32 = np.linspace(1.0, 5.0, n).astype(np.float32)
    op = tpl.DiagonalOperator(diag32, device=CPU)
    b = (np.random.default_rng(7).standard_normal(n).astype(np.float32)
         * np.float32(2e-6))
    bt = torch.from_numpy(b)
    b_norm = float(np.linalg.norm(b))
    assert 1e-6 < b_norm < 1.2e-4
    dec = tpl.lanczos_pass_one(op, bt, k)
    assert dec.steps() == k
    y = tpl.make_inv_solver()(dec.alphas_valid(), dec.betas_valid()).numpy()
    y = np.pad(y * b_norm, (0, k - y.shape[0])).astype(np.float32)
    x = tpl.lanczos_pass_two(op, bt, dec, torch.from_numpy(y))
    assert x.dtype == torch.float32 and float(x.norm()) > 0.0
    assert _rel(x.numpy(), b / diag32) < 1e-3


def test_pass_two_basis_zero_beyond_steps():
    op = tpl.DiagonalOperator(np.array([2.0, 3.0]), device=CPU)
    b = torch.tensor([1.0, 0.0], dtype=torch.float64)
    k = 6
    dec, basis1 = pass_one_scan(op.matvec, b, k, emit_basis=True)
    assert dec.steps() == 1
    _, basis2 = tpl.lanczos_pass_two_with_basis(op, b, dec,
                                                torch.zeros(k))
    np.testing.assert_array_equal(basis1[1:].numpy(), 0.0)
    np.testing.assert_array_equal(basis2[1:].numpy(), 0.0)


def _kkt_pair(rng, dtype):
    d, u, v, p = random_kkt(rng, m=300, p=120)
    d = d.astype(dtype)
    ours = tpl.make_kkt_operator(d, u, v, p, device=CPU)
    ref = jtpl.KKTOperator(d=jnp.asarray(d), arc_u=jnp.asarray(u),
                           arc_v=jnp.asarray(v), num_nodes=p)
    return ours, ref, (d, u, v, p)


@pytest.mark.parametrize("operator", ["diagonal", "dense", "kkt"])
def test_coefficients_match_jax_f64(operator):
    rng = np.random.default_rng(11)
    if operator == "diagonal":
        diag = rng.uniform(-3.0, 5.0, 200)
        ours = tpl.DiagonalOperator(diag, device=CPU)
        ref = jtpl.DiagonalOperator(jnp.asarray(diag))
    elif operator == "dense":
        m = rng.standard_normal((80, 80))
        ours = tpl.DenseOperator(m + m.T, device=CPU)
        ref = jtpl.DenseOperator(jnp.asarray(m + m.T))
    else:
        ours, ref, _ = _kkt_pair(rng, np.float64)
    b = rng.standard_normal(ours.shape[0])
    k = 15
    dec = tpl.lanczos_pass_one(ours, torch.from_numpy(b), k)
    jdec = jtpl.lanczos_pass_one(ref, jnp.asarray(b), k)
    assert dec.steps() == jdec.steps() == k
    # ‖b‖ to the last bits: torch.dot and XLA's sum add in other orders
    np.testing.assert_allclose(float(dec.b_norm), float(jdec.b_norm),
                               rtol=1e-15)
    np.testing.assert_allclose(dec.alphas.numpy(), np.asarray(jdec.alphas),
                               rtol=1e-12)
    np.testing.assert_allclose(dec.betas.numpy(), np.asarray(jdec.betas),
                               rtol=1e-12)
    # one-pass and chunked variants: the same coefficients, bitwise
    dec1, _ = tpl.lanczos_standard(ours, torch.from_numpy(b), k)
    dec2 = tpl.lanczos_pass_one_chunked(ours, torch.from_numpy(b), k,
                                        chunk=4)
    for other in (dec1, dec2):
        assert torch.equal(other.alphas, dec.alphas)
        assert torch.equal(other.betas, dec.betas)


def test_multi_function_stacks():
    op, b, eigs = _problem()
    fs = [tpl.make_inv_solver(), tpl.make_exp_solver()]
    x2 = tpl.lanczos_two_pass(op, b, K, fs)
    assert tuple(x2.shape) == (2, N)
    for i, f in enumerate(fs):
        assert torch.equal(x2[i], tpl.lanczos_two_pass(op, b, K, f))
    x1 = tpl.lanczos(op, b, K, fs)
    fast = tpl.solve_fAb(op, b, k=K, f=("inv", "exp"))
    assert tuple(fast.shape) == (2, N)
    for i in range(2):  # exp spans e^1..e^100: compare each row's norm
        assert _rel(x1[i].numpy(), x2[i].numpy()) < 1e-12
        assert _rel(fast[i].numpy(), x2[i].numpy()) < 1e-12
    ref = np.asarray(jtpl.solve_fAb(
        jtpl.DiagonalOperator(jnp.asarray(eigs)), jnp.asarray(b), k=K,
        f=("inv", "exp")))
    for i in range(2):
        assert _rel(fast[i].numpy(), ref[i]) < 1e-12


def test_callback_stop_matches_jax_chunked():
    rng = np.random.default_rng(3)
    ours, ref, _ = _kkt_pair(rng, np.float64)
    b = rng.standard_normal(ours.shape[0])
    seen = []

    def cb(s, v, ab):
        seen.append((s, v is None, len(ab[0]), len(ab[1])))
        return s < 11

    dec = tpl.lanczos_pass_one_chunked(ours, torch.from_numpy(b), 40, cb,
                                       chunk=4)
    jdec = jtpl.lanczos_pass_one_chunked(ref, jnp.asarray(b), 40,
                                         lambda s, v, ab: s < 11, chunk=4)
    assert dec.steps() == jdec.steps() == 11
    assert seen[-1] == (11, True, 11, 10)
    np.testing.assert_allclose(dec.alphas.numpy(), np.asarray(jdec.alphas),
                               rtol=1e-12)
    np.testing.assert_allclose(dec.betas.numpy(), np.asarray(jdec.betas),
                               rtol=1e-12)
    views = []
    dec1, basis = tpl.lanczos_standard_chunked(
        ours, torch.from_numpy(b), 40,
        lambda s, v, ab: views.append(v.shape) or s < 11, chunk=4)
    assert dec1.steps() == 11 and views[-1] == (11, ours.shape[0])
    assert bool((basis[11:] == 0).all())
    x_cb = tpl.lanczos_two_pass(ours, b, 40, tpl.make_inv_solver(),
                                callback=lambda s, v, ab: s < 11,
                                callback_chunk=4)
    x_11 = tpl.lanczos_two_pass(ours, b, 11, tpl.make_inv_solver())
    np.testing.assert_allclose(x_cb.numpy(), x_11.numpy(), rtol=1e-12)
    x_one = tpl.lanczos(ours, b, 40, tpl.make_inv_solver(),
                        callback=lambda s, v, ab: s < 11, callback_chunk=4)
    np.testing.assert_allclose(x_one.numpy(), x_11.numpy(), rtol=1e-10)


def test_slice_solve_fAb_kkt_f32_vs_pallas_interpret():
    rng = np.random.default_rng(42)
    d, u, v, p = random_kkt(rng, m=300, p=40)
    b = rng.standard_normal(len(d) + p).astype(np.float32)
    op = tpl.make_kkt_operator(d, u, v, p, device=CPU)
    x = tpl.solve_fAb(op, b, k=12, f="inv")
    assert x.dtype == torch.float32
    pal = jtpl.PallasKKTOperator.build(d, u, v, p, interpret=True)
    ref = np.asarray(jtpl.solve_fAb(pal, jnp.asarray(b), k=12, f="inv"))
    assert _rel(x.numpy(), ref) < 1e-5


def test_slice_solve_fAb_kkt_f64_vs_jax():
    rng = np.random.default_rng(42)
    ours, ref, _ = _kkt_pair(rng, np.float64)
    b = rng.standard_normal(ours.shape[0])
    for method in ("two_pass", "one_pass"):
        x = tpl.solve_fAb(ours, b, k=12, f="inv", method=method).numpy()
        want = np.asarray(jtpl.solve_fAb(ref, jnp.asarray(b), k=12, f="inv",
                                         method=method))
        assert _rel(x, want) < 1e-12
    x_host = tpl.lanczos_two_pass(ours, b, 12, tpl.make_inv_solver())
    want = np.asarray(jtpl.lanczos_two_pass(ref, jnp.asarray(b), 12,
                                            jtpl.make_inv_solver()))
    assert _rel(x_host.numpy(), want) < 1e-12
