"""The port's one-pass solve (``FusedKKTSolver.solve(method="one_pass")``,
``pass_one_with_basis``) on the CPU held against the JAX fused solver in
interpret mode at ``tests/test_fused.py``'s and ``tests/test_multi_f.py``'s
tolerances, plus the basis invariants: α and β bitwise those of pass one,
row s-1 = v_s, rows past a breakdown zero. The kernel K4 is held to the
plain version in ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from tests.torch_cases import CPU, breakdown_kkt, random_kkt
from two_pass_lanczos_tpu.ops.kkt_fused import FusedKKTSolver as JaxFused
from two_pass_lanczos_tpu_torch.algorithms.core import (
    basis_product,
    pass_one_last_vector,
)
from two_pass_lanczos_tpu_torch.ops.kkt_fused import FusedKKTSolver


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(42)
    d, u, v, p = random_kkt(rng)
    b = rng.standard_normal(len(d) + p).astype(np.float32)
    return d, u, v, p, b


def _rel(x, ref):
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("f", ["inv", "exp"])
def test_one_pass_solve(problem, f):
    d, u, v, p, b = problem
    k = 25
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    x1, dec = s.solve(b, k=k, f=f, method="one_pass")
    x_ref, dec_ref = JaxFused(d, u, v, p, interpret=True).solve(
        b, k=k, f=f, method="one_pass")
    assert dec.steps() == int(dec_ref.steps_taken) == k
    assert _rel(x1, x_ref) < 1e-4, _rel(x1, x_ref)
    # one-pass and two-pass share pass-one arithmetic: tight agreement
    x2, _ = s.solve(b, k=k, f=f, method="two_pass")
    assert _rel(x1, x2) < 1e-5, _rel(x1, x2)


def test_basis_matches_jax(problem):
    d, u, v, p, b = problem
    k = 12
    js = JaxFused(d, u, v, p, interpret=True)
    _, bu, bn = js.pass_one_with_basis(js.pack(b), k)
    bu, bn = np.asarray(bu), np.asarray(bn)
    ref = np.stack([js.layout.unpack(bu[j], bn[j]) for j in range(k)])
    _, basis = FusedKKTSolver(d, u, v, p, device=CPU).pass_one_with_basis(b, k)
    assert basis.shape == (k, len(d) + p)
    assert _rel(basis.numpy(), ref) < 1e-5, _rel(basis.numpy(), ref)


@pytest.mark.parametrize("breakdown", [False, True], ids=["full", "breakdown"])
def test_basis_invariants(problem, breakdown):
    d, u, v, p, b = breakdown_kkt() if breakdown else problem
    k = 20
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    st = torch.empty(2, s.n)
    dec1 = s.pass_one(b, k, state=st)
    dec, basis = s.pass_one_with_basis(b, k)
    steps = dec.steps()
    assert (steps < k) == breakdown
    assert torch.equal(dec.alphas, dec1.alphas)
    assert torch.equal(dec.betas, dec1.betas)
    assert torch.equal(basis[steps - 1], pass_one_last_vector(dec1, st))
    assert bool((basis[steps:] == 0).all())
    assert bool(torch.isfinite(basis).all())


def test_one_pass_breakdown_and_zero_b():
    d, u, v, p, b = breakdown_kkt()
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    x1, dec = s.solve(b, k=12, f="inv", method="one_pass")
    x2, _ = s.solve(b, k=12, f="inv")
    assert dec.steps() < 12 and np.all(np.isfinite(x1))
    np.testing.assert_allclose(x1, x2, rtol=0, atol=1e-6)
    x0, dec0 = s.solve(np.zeros_like(b), k=8, method="one_pass")
    assert dec0.steps() == 0
    np.testing.assert_array_equal(x0, 0.0)


@pytest.mark.parametrize("method", ["one_pass", "two_pass"])
def test_fused_multi_matches_singles(method):
    rng = np.random.default_rng(3)
    d, u, v, p = random_kkt(rng, m=400, p=150)
    b = rng.standard_normal(len(d) + p).astype(np.float32)
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    fs = ("inv", "exp")
    x_multi, dec = s.solve(b, k=16, f=fs, method=method)
    assert x_multi.shape == (2, len(d) + p)
    x_ref, _ = JaxFused(d, u, v, p, interpret=True).solve(
        b, k=16, f=fs, method=method)
    for i, f in enumerate(fs):
        x_single, dec_s = s.solve(b, k=16, f=f, method=method)
        np.testing.assert_array_equal(dec.alphas.numpy(), dec_s.alphas.numpy())
        np.testing.assert_allclose(x_multi[i], x_single, rtol=0,
                                   atol=1e-6 * np.abs(x_single).max())
        assert _rel(x_multi[i], x_ref[i]) < 1e-4


@pytest.mark.parametrize("nf", [1, 3])
def test_basis_product_is_full_f32(nf):
    # x = y @ V as nf GEMVs: the f32 product of the f64 one, and each row of
    # a multi-f product bitwise the single product of that row
    rng = np.random.default_rng(11)
    basis = torch.from_numpy(rng.standard_normal((30, 2000)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((nf, 30)).astype(np.float32))
    got = basis_product(y if nf > 1 else y[0], basis)
    assert got.shape == ((nf, 2000) if nf > 1 else (2000,))
    ref = y.double() @ basis.double()
    assert _rel(got.reshape(nf, -1).double().numpy(), ref.numpy()) < 1e-6
    for i in range(nf):
        assert torch.equal(got.reshape(nf, -1)[i], basis_product(y[i], basis))
