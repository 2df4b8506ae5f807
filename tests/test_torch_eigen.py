"""The port's thick-restart eigensolver (``eigen.eigsh``) against the JAX
package's from the same ``v0`` (f64 at 1e-10), and held to the analytic
truths of ``tests/test_eigen.py``: diagonal spectra, a dense SPD matrix, a
sparse KKT operator, invariant-subspace injections, degenerate copies and
a complex Hermitian A. Every returned residual is checked against a real
matvec. Past a random injection the two packages' iterates differ by
design (their random streams differ), so those cases are held to the
contracts only."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import two_pass_lanczos_tpu as jtpl
import two_pass_lanczos_tpu_torch as tpl
from tests.torch_cases import CPU
from two_pass_lanczos_tpu.eigen import eigsh as jax_eigsh
from two_pass_lanczos_tpu_torch.eigen import eigsh


def _diag_op(d):
    return tpl.DiagonalOperator(np.asarray(d, np.float64), device=CPU)


def _check_pairs(res, a_apply):
    """Returned residual norms against real matvecs, and unit norms."""
    for theta, u, r in zip(res.eigenvalues, res.eigenvectors,
                           res.residual_norms):
        assert np.linalg.norm(u) == pytest.approx(1.0, abs=1e-10)
        true_resid = np.linalg.norm(a_apply(u) - theta * u)
        assert true_resid == pytest.approx(r, rel=1e-4, abs=1e-9)


@pytest.mark.parametrize("which,nev,d,maxiter", [
    ("LA", 5, np.linspace(0.1, 100.0, 500), 100),
    ("SA", 4, np.linspace(1.0, 50.0, 400), 300),
    ("LM", 4, np.concatenate([np.linspace(-99.0, -1.0, 150),
                              np.linspace(1.0, 100.0, 150)]), 100),
], ids=["LA", "SA", "LM"])
def test_extreme_pairs_diagonal_match_jax(which, nev, d, maxiter):
    v0 = np.random.default_rng(1).standard_normal(d.size)
    res = eigsh(_diag_op(d), nev=nev, which=which, tol=1e-10,
                maxiter=maxiter, v0=v0)
    assert res.converged
    if which == "LM":
        truth = np.sort(d[np.argsort(np.abs(d))[-nev:]])
        assert res.eigenvalues[0] < 0 < res.eigenvalues[-1]
    else:
        truth = np.sort(d)[-nev:] if which == "LA" else np.sort(d)[:nev]
    np.testing.assert_allclose(res.eigenvalues, truth, rtol=1e-8)
    assert np.all(np.diff(res.eigenvalues) > 0)
    _check_pairs(res, lambda u: d * u)
    ref = jax_eigsh(jtpl.DiagonalOperator(jnp.asarray(d)), nev=nev,
                    which=which, tol=1e-10, maxiter=maxiter,
                    v0=jnp.asarray(v0))
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues, rtol=1e-10)
    # the same iterates: the same number of restarts and the same vectors
    assert res.restarts == ref.restarts
    np.testing.assert_allclose(np.abs(res.eigenvectors),
                               np.abs(ref.eigenvectors), atol=1e-7)


def test_eigenvectors_match_analytic():
    n = 300
    d = np.linspace(1.0, 30.0, n)
    res = eigsh(_diag_op(d), nev=3, which="LA", tol=1e-11)
    assert res.converged
    for j, u in enumerate(res.eigenvectors):
        assert abs(u[n - 3 + j]) == pytest.approx(1.0, abs=1e-7)


def test_dense_spd_against_numpy_and_jax():
    n = 200
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.linspace(0.5, 60.0, n)
    a = (q * lam) @ q.T
    v0 = rng.standard_normal(n)
    res = eigsh(tpl.DenseOperator(a, device=CPU), nev=6, which="LA",
                tol=1e-10, v0=v0)
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, lam[-6:], rtol=1e-8)
    _check_pairs(res, lambda u: a @ u)
    for j, u in enumerate(res.eigenvectors):
        assert abs(u @ q[:, n - 6 + j]) == pytest.approx(1.0, abs=1e-6)
    ref = jax_eigsh(jtpl.DenseOperator(jnp.asarray(a)), nev=6, which="LA",
                    tol=1e-10, v0=jnp.asarray(v0))
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues, rtol=1e-10)


def test_kkt_operator_extreme_pairs():
    rng = np.random.default_rng(3)
    m, p = 600, 40
    u = rng.integers(0, p, m).astype(np.int32)
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    dq = rng.uniform(1.0, 3.0, m)
    op = tpl.make_kkt_operator(dq, u, v, p, dtype=torch.float64, device=CPU)
    n = m + p
    a = np.zeros((n, n))
    a[np.arange(m), np.arange(m)] = dq
    np.add.at(a, (u + m, np.arange(m)), 1.0)
    np.add.at(a, (v + m, np.arange(m)), -1.0)
    a[:m, m:] = a[m:, :m].T
    lam = np.linalg.eigvalsh(a)
    res = eigsh(op, nev=3, which="LA", tol=1e-9, maxiter=300)
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, lam[-3:], rtol=1e-7)
    _check_pairs(res, lambda x: a @ x)


def test_invariant_subspace_random_injection():
    # v0 an exact eigenvector: only the injections leave its 1-D subspace
    d = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    v0 = np.zeros(6)
    v0[5] = 1.0
    res = eigsh(_diag_op(d), nev=3, which="LA", ncv=5, v0=v0, tol=1e-10)
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, [4.0, 5.0, 6.0], rtol=1e-9)
    _check_pairs(res, lambda u: d * u)


def test_degenerate_eigenvalue_copies_found():
    d = np.array([1.0, 2.0, 3.0] * 40)
    res = eigsh(_diag_op(d), nev=3, which="LA", ncv=12, tol=1e-10)
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, [3.0, 3.0, 3.0], rtol=1e-9)
    gram = res.eigenvectors @ res.eigenvectors.T
    np.testing.assert_allclose(gram, np.eye(3), atol=1e-8)
    _check_pairs(res, lambda u: d * u)


def test_full_dimension_ncv_equals_n():
    d = np.array([3.0, 1.0, 4.0, 1.5, 9.0, 2.6, 5.3, 5.8])
    res = eigsh(_diag_op(d), nev=2, ncv=8, which="SA", tol=1e-12)
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, np.sort(d)[:2], rtol=1e-10)


def test_deterministic_given_key():
    d = np.linspace(1.0, 20.0, 100)
    r1 = eigsh(_diag_op(d), nev=3, key=torch.Generator().manual_seed(5))
    r2 = eigsh(_diag_op(d), nev=3, key=5)
    np.testing.assert_array_equal(r1.eigenvalues, r2.eigenvalues)
    np.testing.assert_array_equal(r1.eigenvectors, r2.eigenvectors)
    # key=None is seed 0, and no global random state is touched
    state = torch.random.get_rng_state()
    r3 = eigsh(_diag_op(d), nev=3)
    r4 = eigsh(_diag_op(d), nev=3, key=0)
    np.testing.assert_array_equal(r3.eigenvectors, r4.eigenvectors)
    assert torch.equal(torch.random.get_rng_state(), state)


@pytest.mark.parametrize("kw,match", [
    (dict(v0=np.zeros(50)), "nonzero"),
    (dict(which="BE"), "which"),
    (dict(nev=0), "nev"),
    (dict(ncv=2), "ncv"),
    (dict(nev=51), "exceeds"),
    (dict(maxiter=0), "maxiter"),
])
def test_validation(kw, match):
    kw = dict(dict(nev=2), **kw)
    with pytest.raises(ValueError, match=match):
        eigsh(_diag_op(np.linspace(1.0, 10.0, 50)), **kw)


def test_v0_seeding():
    d = np.linspace(1.0, 10.0, 50)
    res = eigsh(_diag_op(d), nev=2, v0=np.ones(50), tol=1e-10)
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, d[-2:], rtol=1e-9)


def test_unconverged_reports_honestly():
    n = 2000
    d = np.linspace(1.0, 2.0, n)
    v0 = np.random.default_rng(2).standard_normal(n)
    res = eigsh(_diag_op(d), nev=4, which="LA", ncv=12, maxiter=1, tol=1e-14,
                v0=v0)
    assert not res.converged
    assert res.restarts == 1
    _check_pairs(res, lambda u: d * u)
    # one cycle from the same v0 without a breakdown: JAX's Ritz pairs
    ref = jax_eigsh(jtpl.DiagonalOperator(jnp.asarray(d)), nev=4,
                    which="LA", ncv=12, maxiter=1, tol=1e-14,
                    v0=jnp.asarray(v0))
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues, rtol=1e-10)
    np.testing.assert_allclose(res.residual_norms, ref.residual_norms,
                               rtol=1e-6)


def test_complex_hermitian_eigsh():
    n = 60
    d = np.concatenate([np.linspace(1.0, 8.0, n - 2), [11.0, 12.0]])
    rng = np.random.default_rng(77)
    q, _ = np.linalg.qr(rng.standard_normal((n, n))
                        + 1j * rng.standard_normal((n, n)))
    a = (q * d) @ q.conj().T
    a = (a + a.conj().T) / 2
    res = eigsh(tpl.DenseOperator(a, device=CPU), nev=2, which="LA",
                tol=1e-10, maxiter=200)
    assert res.converged
    np.testing.assert_allclose(res.eigenvalues, [11.0, 12.0], rtol=1e-8)
    assert np.iscomplexobj(res.eigenvectors)
    assert not np.iscomplexobj(res.residual_norms)
    _check_pairs(res, lambda u: a @ u)
