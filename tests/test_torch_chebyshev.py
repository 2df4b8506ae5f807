"""The port's Chebyshev expansion (``algorithms/chebyshev.py``) against the
JAX package's on the same arrays (coefficients and ``chebyshev_scan`` in
f64 at 1e-10, f32 KKT expansions at 2e-5), and held to the truths of
``tests/test_chebyshev.py``: polynomial exactness, analytic diagonal
answers, agreement with the Lanczos solvers, the interval estimate's
enclosure and the validation messages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import two_pass_lanczos_tpu as jtpl
import two_pass_lanczos_tpu_torch as tpl
from tests.torch_cases import CPU
from two_pass_lanczos_tpu.algorithms import chebyshev as jcheb
from two_pass_lanczos_tpu_torch.algorithms.chebyshev import (
    chebyshev_coefficients,
    chebyshev_fAb,
    chebyshev_scan,
    estimate_interval,
)


def _problem(n=300, lo=1.0, hi=10.0, seed=0):
    d = np.linspace(lo, hi, n)
    b = np.random.default_rng(seed).standard_normal(n)
    return tpl.DiagonalOperator(d, device=CPU), torch.from_numpy(b), d, b


def _rel(x, ref):
    return np.linalg.norm(np.asarray(x) - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("f,interval", [
    ("inv", (1.0, 10.0)), ("exp", (-1.0, 3.0)), ("log", (0.5, 8.0)),
    (np.sin, (-2.0, 2.0))], ids=["inv", "exp", "log", "callable"])
def test_coefficients_match_jax(f, interval):
    np.testing.assert_allclose(
        chebyshev_coefficients(f, interval, 40),
        jcheb.chebyshev_coefficients(f, interval, 40), rtol=1e-10,
        atol=1e-15)


def test_coefficients_polynomial_exact():
    c = chebyshev_coefficients(lambda x: x ** 2, (0.0, 2.0), 4)
    np.testing.assert_allclose(c, [1.5, 2.0, 0.5, 0.0, 0.0], atol=1e-13)


@pytest.mark.parametrize("degree", [0, 1, 2, 30])
def test_scan_same_inputs_as_jax(degree):
    # the seam that takes arrays: one coefficient vector, one scale, one b
    _, b, d, b_np = _problem()
    cs = chebyshev_coefficients("exp", (0.5, 11.0), degree)
    scale = [2.0 / 10.5, 11.5 / 10.5]
    y = chebyshev_scan(lambda x: torch.from_numpy(d) * x, b,
                       torch.from_numpy(cs), torch.tensor(scale,
                                                          dtype=torch.float64))
    ref = jcheb.chebyshev_scan(lambda x: jnp.asarray(d) * x,
                               jnp.asarray(b_np), jnp.asarray(cs),
                               jnp.asarray(scale))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-12)


def test_polynomial_fAb_exact():
    op, b, d, b_np = _problem()
    x = chebyshev_fAb(op, b, lambda t: t ** 2, degree=2,
                      interval=(0.5, 11.0))
    np.testing.assert_allclose(x.numpy(), d ** 2 * b_np, rtol=1e-12)


def test_exp_matches_analytic_and_lanczos():
    op, b, d, b_np = _problem(lo=-1.0, hi=3.0)
    truth = np.exp(d) * b_np
    x = chebyshev_fAb(op, b, "exp", degree=40, interval=(-1.0, 3.0)).numpy()
    assert _rel(x, truth) < 1e-12
    x_lan = tpl.solve_fAb(op, b, k=60, f="exp", method="two_pass").numpy()
    assert np.linalg.norm(x - x_lan) / np.linalg.norm(truth) < 1e-10


def test_inv_geometric_convergence_in_degree():
    op, b, d, b_np = _problem(lo=1.0, hi=16.0)
    truth = b_np / d
    errs = [_rel(chebyshev_fAb(op, b, "inv", degree=deg,
                               interval=(1.0, 16.0)).numpy(), truth)
            for deg in (20, 40, 80)]
    assert errs[1] < 0.1 * errs[0] and errs[2] < 0.1 * errs[1]
    assert errs[2] < 1e-10


def test_auto_interval_via_eigsh():
    op, b, d, b_np = _problem(lo=0.5, hi=8.0, n=200)
    x = chebyshev_fAb(op, b, "inv", degree=120, key=2)
    assert _rel(x.numpy(), b_np / d) < 1e-8


def test_auto_interval_inv_stays_positive_at_high_kappa():
    op, b, d, b_np = _problem(lo=0.1, hi=10.0, n=200)
    a, hi = estimate_interval(op)
    assert 0.0 < a <= d.min() and hi >= d.max()
    x = chebyshev_fAb(op, b, "inv", degree=400, key=0)
    assert _rel(x.numpy(), b_np / d) < 1e-6


def test_inv_on_negative_definite_interval():
    d = np.linspace(-10.5, -0.5, 200)
    b = np.random.default_rng(3).standard_normal(200)
    x = chebyshev_fAb(tpl.DiagonalOperator(d, device=CPU), b, "inv",
                      degree=120, interval=(-10.5, -0.5))
    np.testing.assert_allclose(x.numpy(), b / d, rtol=1e-9, atol=1e-12)


def test_estimate_interval_encloses_spectrum():
    op, _, d, _ = _problem(lo=0.5, hi=8.0, n=200)
    a, b = estimate_interval(op)
    assert a <= d.min() and b >= d.max()
    assert a > 0.0
    # the JAX estimate of the same operator, from another random start,
    # lands within the margin of ours
    ja, jb = jcheb.estimate_interval(jtpl.DiagonalOperator(jnp.asarray(d)))
    assert a == pytest.approx(ja, rel=0.05) and b == pytest.approx(jb,
                                                                  rel=0.05)


@pytest.mark.parametrize("call,match", [
    (lambda op, b: chebyshev_fAb(op, b, "inv", degree=10,
                                 interval=(-1.0, 10.0)), "sign-definite"),
    (lambda op, b: chebyshev_fAb(op, b, "log", degree=10,
                                 interval=(-1.0, 10.0)),
     "positive spectral interval"),
    (lambda op, b: chebyshev_coefficients("exp", (2.0, 2.0), 5), "a < b"),
    (lambda op, b: chebyshev_coefficients("exp", (0.0, 1.0), -1), "degree"),
    (lambda op, b: chebyshev_coefficients("sinh?", (0.0, 1.0), 5),
     "unknown function"),
    (lambda op, b: chebyshev_coefficients("exp", (0.0, 1e6), 10),
     "not finite"),
    (lambda op, b: chebyshev_coefficients("log", (-1.0, 1.0), 10),
     "not finite"),
])
def test_validation_errors(call, match):
    op, b, _, _ = _problem()
    with pytest.raises(ValueError, match=match):
        call(op, b)


def test_degree_zero_and_one():
    op, b, d, b_np = _problem()
    x0 = chebyshev_fAb(op, b, lambda t: 0.0 * t + 3.0, degree=0,
                       interval=(1.0, 10.0))
    np.testing.assert_allclose(x0.numpy(), 3.0 * b_np, rtol=1e-13)
    x1 = chebyshev_fAb(op, b, lambda t: 2.0 * t, degree=1,
                       interval=(1.0, 10.0))
    np.testing.assert_allclose(x1.numpy(), 2.0 * d * b_np, rtol=1e-12)


def _kkt(seed, m, p, lo, hi):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, p, m).astype(np.int32)
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    return rng, rng.uniform(lo, hi, m), u, v


def test_sparse_kkt_exp_against_lanczos():
    rng, dq, u, v = _kkt(4, 800, 50, 1.0, 3.0)
    p = 50
    op = tpl.make_kkt_operator(dq / 10.0, u, v, p, dtype=torch.float64,
                               device=CPU)
    b = torch.from_numpy(rng.standard_normal(800 + p))
    a_lo, a_hi = estimate_interval(op)
    x_ch = chebyshev_fAb(op, b, "exp", degree=80, interval=(a_lo, a_hi))
    x_ln = tpl.solve_fAb(op, b, k=150, f="exp", method="two_pass")
    assert _rel(x_ch.numpy(), x_ln.numpy()) < 1e-9


def test_f32_kkt_operator_matches_jax():
    # the f32 expansion on the KKT operator (K8's plain version here) and
    # the JAX package's XLA operator, same b and interval
    rng, dq, u, v = _kkt(8, 300, 30, 0.1, 0.5)
    p = 30
    b = rng.standard_normal(300 + p).astype(np.float32)
    iv = (-3.0, 3.0)
    op = tpl.make_kkt_operator(dq, u, v, p, dtype=torch.float32, device=CPU)
    x = chebyshev_fAb(op, b, "exp", degree=30, interval=iv).numpy()
    assert x.dtype == np.float32
    jop = jtpl.make_kkt_operator(dq, u, v, p, backend="xla",
                                 dtype=jnp.float32)
    ref = np.asarray(jcheb.chebyshev_fAb(jop, jnp.asarray(b), "exp",
                                         degree=30, interval=iv))
    np.testing.assert_allclose(x, ref, rtol=2e-5, atol=2e-5)
