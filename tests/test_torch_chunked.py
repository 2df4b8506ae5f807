"""In-run early stopping in the port (``FusedKKTSolver.pass_one_chunked``,
``solve(callback=...)``, the plain ``pass_one_chunk_scan``; the kernel K5 is
held to it in ``tests/test_torch_cuda.py``) held to
``tests/test_fused.py::TestFusedChunked``,
``test_solve_with_callback_early_stop``, ``tests/test_convergence.py`` and
``tests/test_multi_f.py``: chunked α and β bitwise equal to the monolithic
pass, the reference's callback view contract, a stop at s after at most
``ceil(s/chunk)·chunk`` steps, and the JAX package's truncation."""

import numpy as np
import pytest
import torch

from tests.torch_cases import CPU, random_kkt
from two_pass_lanczos_tpu.ops.kkt_fused import FusedKKTSolver as JaxFused
from two_pass_lanczos_tpu_torch import make_convergence_callback, padded_f_e1
from two_pass_lanczos_tpu_torch.algorithms.core import (
    dot_f64,
    pass_one_chunk_scan,
    pass_one_scan,
)
from two_pass_lanczos_tpu_torch.ops.kkt_fused import FusedKKTSolver
from two_pass_lanczos_tpu_torch.ops.spmv import kkt_matvec


def _problem(m=900, p=120, seed=42):
    rng = np.random.default_rng(seed)
    d, u, v, p = random_kkt(rng, m=m, p=p)
    b = rng.standard_normal(len(d) + p).astype(np.float32)
    return d, u, v, p, b


@pytest.mark.parametrize("compensated", [False, True], ids=["plain", "comp"])
def test_bit_identical_to_monolithic(compensated):
    d, u, v, p, b = _problem()
    s = FusedKKTSolver(d, u, v, p, compensated=compensated, device=CPU)
    k = 23  # not a multiple of the chunk: the last chunk is clamped
    ref = s.pass_one(b, k)
    got = s.pass_one_chunked(b, k, chunk=8)
    assert torch.equal(got.alphas, ref.alphas)
    assert torch.equal(got.betas, ref.betas)
    assert got.steps() == ref.steps() == k
    assert float(got.b_norm) == float(ref.b_norm)
    # the JAX package's chunked pass, at its own cross-implementation rtol
    js = JaxFused(d, u, v, p, interpret=True, compensated=compensated)
    jref = js.pass_one_chunked(js.pack(b), k, chunk=8)
    np.testing.assert_allclose(got.alphas.numpy(), np.asarray(jref.alphas),
                               rtol=1e-4)


@pytest.mark.parametrize("chunk", [1, 5, 8, 30])
def test_plain_chunk_scan_chains_bitwise(chunk):
    # chained chunks of the plain twin of K5, with the step limit inside a
    # chunk (no host clamp), give one pass_one_scan bitwise
    d, u, v, p, b = _problem(m=300, p=60, seed=5)
    t = torch.from_numpy
    lay_d, lay_u, lay_v = t(d), t(u), t(v)

    def mv(x):
        return kkt_matvec(lay_d, lay_u, lay_v, p, x)

    k = 17
    bt = t(b)
    ref, _ = pass_one_scan(mv, bt, k, dot=dot_f64)
    carry, alphas, betas = None, [], []
    for _ in range(-(-k // chunk)):
        a, bb, carry = pass_one_chunk_scan(mv, bt, chunk, carry, k,
                                           dot=dot_f64)
        alphas.append(a)
        betas.append(bb)
    assert int(carry.steps) == k
    assert torch.equal(torch.cat(alphas)[:k], ref.alphas)
    assert torch.equal(torch.cat(betas)[:k], ref.betas)
    assert bool((torch.cat(alphas)[k:] == 0).all())


def test_callback_early_stop_and_view_contract():
    d, u, v, p, b = _problem()
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    k, stop_at = 30, 11
    seen = []

    def cb(step, basis, scalars):
        alphas, betas = scalars
        assert basis is None  # the two-pass path stores no basis
        assert isinstance(alphas, np.ndarray)
        assert len(alphas) == step and len(betas) == step - 1
        seen.append(step)
        return step < stop_at

    dec = s.pass_one_chunked(b, k, callback=cb, chunk=8)
    assert seen == list(range(1, stop_at + 1))
    assert dec.steps() == stop_at
    a = dec.alphas.numpy()
    assert np.all(a[stop_at:] == 0.0) and np.all(a[:stop_at] != 0.0)
    # a callback stop zeroes beta from s-1 (JAX kkt_fused.py:1527-1532)
    bt = dec.betas.numpy()
    assert np.all(bt[stop_at - 1:] == 0.0) and np.all(bt[:stop_at - 1] != 0.0)
    ref = s.pass_one(b, k)
    assert torch.equal(dec.alphas[:stop_at], ref.alphas[:stop_at])
    # the truncated decomposition drives pass two end to end
    y = padded_f_e1(dec, "inv")
    y_full = torch.where(torch.arange(k) < dec.steps_taken, y * dec.b_norm,
                         torch.zeros(()))
    assert np.isfinite(s.pass_two(b, dec, y_full).numpy()).all()


def test_breakdown_inside_chunk():
    d = np.array([2.0, 3.0], np.float32)
    u = np.array([0, 1], np.int32)
    v = np.array([1, 0], np.int32)
    s = FusedKKTSolver(d, u, v, 2, device=CPU)
    e1 = np.eye(4, dtype=np.float32)[0]
    ref = s.pass_one(e1, 6)
    got = s.pass_one_chunked(e1, 6, chunk=4)
    assert got.steps() == ref.steps() < 6
    assert torch.equal(got.alphas, ref.alphas)
    # a breakdown keeps beta_steps (0) like the monolithic kernel
    assert torch.equal(got.betas, ref.betas)
    jref = JaxFused(d, u, v, 2, interpret=True)
    assert got.steps() == int(jref.pass_one(jref.pack(e1), 6).steps_taken)


def test_zero_b():
    d, u, v, p, _ = _problem()
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    dec = s.pass_one_chunked(np.zeros(s.n, np.float32), 8, chunk=4)
    assert dec.steps() == 0
    np.testing.assert_array_equal(dec.alphas.numpy(), 0.0)


def test_full_run_keeps_last_beta():
    d, u, v, p, b = _problem()
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    dec = s.pass_one_chunked(b, 10, callback=lambda *a: True, chunk=4)
    assert dec.steps() == 10 and dec.beta_last() > 0.0
    assert dec.beta_last() == s.pass_one(b, 10).beta_last()


def test_solve_with_callback_early_stop():
    rng = np.random.default_rng(42)
    d, u, v, p = random_kkt(rng, m=800, p=110)
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    b = rng.standard_normal(len(d) + p).astype(np.float32)
    stop_at = 9
    x_cb, dec = s.solve(b, k=20, f="inv",
                        callback=lambda st, V, sc: st < stop_at,
                        callback_chunk=4)
    assert dec.steps() == stop_at
    x_ref, dec_ref = s.solve(b, k=stop_at, f="inv")
    np.testing.assert_array_equal(dec.alphas.numpy()[:stop_at],
                                  dec_ref.alphas.numpy())
    np.testing.assert_allclose(x_cb, x_ref, rtol=0,
                               atol=1e-6 * np.abs(x_ref).max())
    x_jax, _ = JaxFused(d, u, v, p, interpret=True).solve(
        b, k=20, f="inv", callback=lambda st, V, sc: st < stop_at,
        callback_chunk=4)
    rel = np.linalg.norm(x_cb - x_jax) / np.linalg.norm(x_jax)
    assert rel < 1e-4, rel
    with pytest.raises(ValueError, match="two_pass"):
        s.solve(b, k=8, f="inv", method="one_pass", callback=lambda *a: True)


def test_convergence_callback_on_fused_path():
    rng = np.random.default_rng(2)
    m, p = 300, 120
    u = rng.integers(0, p, m).astype(np.int32)
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    d = rng.uniform(1.0, 3.0, m).astype(np.float32)
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    b = rng.standard_normal(m + p).astype(np.float32)
    # tol=inf fires at the first evaluated step (lag+1)
    cb = make_convergence_callback("inv", tol=np.inf, lag=5, stride=1)
    x, dec = s.solve(b, k=32, f="inv", callback=cb, callback_chunk=8)
    assert cb.stopped_at == 6
    assert dec.steps() == 6
    assert np.all(np.isfinite(x))


def test_fused_multi_with_callback():
    rng = np.random.default_rng(4)
    d, u, v, p = random_kkt(rng, m=400, p=150)
    b = rng.standard_normal(len(d) + p).astype(np.float32)
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    stop = 9
    x_multi, dec = s.solve(b, k=24, f=("inv", "exp"),
                           callback=lambda s_, v_, t: s_ < stop,
                           callback_chunk=4)
    assert dec.steps() == stop
    x_single, _ = s.solve(b, k=24, f="inv",
                          callback=lambda s_, v_, t: s_ < stop,
                          callback_chunk=4)
    np.testing.assert_allclose(x_multi[0], x_single, rtol=0,
                               atol=1e-6 * np.abs(x_single).max())
