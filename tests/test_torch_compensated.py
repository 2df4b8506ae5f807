"""Compensated α/β reductions of the port (``FusedKKTSolver(compensated=
True)``; on the CPU the plain f64-accumulated ``dot_f64``) held to
``tests/test_fused.py::TestCompensatedReduction``, and the torch twin of the
error-free transformations (``ops/eft.py``) held to the exact values of
``tests/test_fused_df.py::test_kernel_eft_helpers_exact_in_interpret_mode``.
The kernels K6 and K13 are held to these plain versions in
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from tests.torch_cases import CPU, random_kkt
from two_pass_lanczos_tpu.ops.kkt_fused import FusedKKTSolver as JaxFused
from two_pass_lanczos_tpu_torch.algorithms.core import dot_f64, pass_one_scan
from two_pass_lanczos_tpu_torch.convert import solver_from_jax
from two_pass_lanczos_tpu_torch.ops.eft import (
    df_add2,
    eft_check_plain,
    two_prod,
    two_sum,
)
from two_pass_lanczos_tpu_torch.ops.kkt_fused import FusedKKTSolver
from two_pass_lanczos_tpu_torch.ops.spmv import kkt_matvec


def _problem(m, p, seed=42):
    rng = np.random.default_rng(seed)
    d, u, v, p = random_kkt(rng, m=m, p=p)
    b = rng.standard_normal(len(d) + p).astype(np.float32)
    return d, u, v, p, b


def test_compensated_solver_matches_plain():
    d, u, v, p, b = _problem(900, 200)
    k = 12
    x0, dec0 = FusedKKTSolver(d, u, v, p, device=CPU).solve(b, k=k, f="inv")
    x1, dec1 = FusedKKTSolver(d, u, v, p, compensated=True, device=CPU).solve(
        b, k=k, f="inv")
    assert dec0.steps() == dec1.steps() == k
    np.testing.assert_allclose(dec1.alphas.numpy(), dec0.alphas.numpy(),
                               rtol=2e-5)
    np.testing.assert_allclose(x1, x0, rtol=0, atol=1e-4 * np.abs(x0).max())


def test_compensated_matches_jax_compensated():
    d, u, v, p, b = _problem(900, 200)
    k = 12
    js = JaxFused(d, u, v, p, interpret=True, compensated=True)
    ref = js.pass_one(js.pack(b), k)
    s = solver_from_jax(js, device=CPU)
    assert s.compensated
    dec = s.pass_one(b, k)
    np.testing.assert_allclose(dec.alphas.numpy(), np.asarray(ref.alphas),
                               rtol=2e-5)
    np.testing.assert_allclose(dec.betas.numpy(), np.asarray(ref.betas),
                               rtol=2e-5)


def test_compensated_alphas_closer_to_f64():
    d, u, v, p, b = _problem(1200, 300)
    k = 6
    t = torch.from_numpy
    o64, _ = pass_one_scan(
        lambda x: kkt_matvec(t(d.astype(np.float64)), t(u), t(v), p, x),
        t(b.astype(np.float64)), k)
    a64 = o64.alphas.numpy()
    a_p = FusedKKTSolver(d, u, v, p, device=CPU).pass_one(b, k).alphas.numpy()
    a_c = FusedKKTSolver(d, u, v, p, compensated=True, device=CPU).pass_one(
        b, k).alphas.numpy()
    err_p = np.abs(a_p.astype(np.float64) - a64).max()
    err_c = np.abs(a_c.astype(np.float64) - a64).max()
    assert err_c <= err_p * 1.5, (err_c, err_p)


def test_dot_f64_beats_plain_on_cancellation():
    # the plain twin of the compensated reductions recovers the f64 dot to
    # f32 rounding where a plain f32 fold loses digits
    rng = np.random.default_rng(42)
    base = rng.standard_normal(128 * 128)
    x = np.concatenate([base, -base * (1 + 1e-7 * rng.standard_normal(
        base.size))]).astype(np.float32)
    y = np.ones_like(x)
    truth = float(np.sum(x.astype(np.float64)))
    comp = float(dot_f64(torch.from_numpy(x), torch.from_numpy(y)))
    plain = float(np.float32(0) + np.cumsum(x, dtype=np.float32)[-1])
    assert abs(comp - truth) <= abs(plain - truth)
    assert abs(comp - truth) < 1e-4 * np.abs(x).sum() * 1.2e-7


@pytest.mark.parametrize("chunk", [4, 23])
def test_compensated_paths_bitwise(chunk):
    # one step routine: monolithic, chunked and one-pass agree bit for bit
    d, u, v, p, b = _problem(900, 120)
    s = FusedKKTSolver(d, u, v, p, compensated=True, device=CPU)
    k = 23
    ref = s.pass_one(b, k)
    for dec in (s.pass_one_chunked(b, k, chunk=chunk),
                s.pass_one_with_basis(b, k)[0]):
        assert torch.equal(dec.alphas, ref.alphas)
        assert torch.equal(dec.betas, ref.betas)


def test_eft_twin_exact_values():
    a = torch.full((1, 128), 1.0 + 2.0 ** -12)
    b = torch.full((1, 128), 2.0 ** -30)
    s, e = two_sum(a, b)
    # two_sum(1 + 2^-12, 2^-30): s rounds to 1 + 2^-12, e is 2^-30 exactly
    assert torch.equal(s, a) and torch.equal(e, b)
    # two_prod(1 + 2^-12, 1 + 2^-12) = 1 + 2^-11 + 2^-24 exactly: the f32
    # head is 1 + 2^-11 (round to even on the half-ulp tie), tail 2^-24
    ph, pe = two_prod(a, a)
    assert torch.equal(ph, torch.full_like(a, 1.0 + 2.0 ** -11))
    assert torch.equal(pe, torch.full_like(a, 2.0 ** -24))
    # df_add2 renormalisation keeps the tail exactly
    dh, dl = df_add2(a, torch.zeros_like(a), b, torch.zeros_like(b))
    assert torch.equal(dh, a) and torch.equal(dl, b)
    out = eft_check_plain(a[0], b[0])
    assert out.shape == (6, 128)
    assert torch.equal(out, torch.stack([s, e, ph, pe, dh, dl])[:, 0])


def test_eft_twin_errors_exact_on_random_inputs():
    rng = np.random.default_rng(1)
    a = rng.standard_normal(4096).astype(np.float32)
    b = (rng.standard_normal(4096) * 1e-4).astype(np.float32)
    s, e = two_sum(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(
        s.numpy().astype(np.float64) + e.numpy().astype(np.float64),
        a.astype(np.float64) + b.astype(np.float64))
    p_, pe = two_prod(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(
        p_.numpy().astype(np.float64) + pe.numpy().astype(np.float64),
        a.astype(np.float64) * b.astype(np.float64))
