"""The port's slice as a whole: ``FusedKKTSolver.solve`` (two-pass, f32)
against the JAX fused solver in interpret mode at rel 1e-4, the plain
recurrence in f64 against JAX x64 ``solve_fAb`` at rel 1e-10, and
``padded_f_e1`` against JAX with breakdown padding. Cross-implementation x
is compared only at small k (the f32 recurrence is forward-unstable)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import two_pass_lanczos_tpu as tpl
from tests.torch_cases import CPU, random_kkt
from two_pass_lanczos_tpu.algorithms.core import (
    LanczosDecomposition as JaxDecomposition,
)
from two_pass_lanczos_tpu.functions import padded_f_e1 as jax_padded_f_e1
from two_pass_lanczos_tpu.ops.kkt_fused import FusedKKTSolver as JaxFused
from two_pass_lanczos_tpu_torch import (
    FusedKKTSolver,
    LanczosDecomposition,
    padded_f_e1,
)
from two_pass_lanczos_tpu_torch.algorithms.core import (
    pass_one_scan,
    pass_two_scan,
)
from two_pass_lanczos_tpu_torch.functions import host_f_tk_solve
from two_pass_lanczos_tpu_torch.ops.spmv import kkt_matvec


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(42)
    d, u, v, p = random_kkt(rng)
    b = rng.standard_normal(len(d) + p).astype(np.float32)
    return d, u, v, p, b


def _rel(x, ref):
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("f", ["inv", "exp"])
def test_solve_matches_jax_fused(problem, f):
    d, u, v, p, b = problem
    k = 25
    x_ref, dec_ref = JaxFused(d, u, v, p, interpret=True).solve(b, k=k, f=f)
    x, dec = FusedKKTSolver(d, u, v, p, device=CPU).solve(b, k=k, f=f)
    assert dec.steps() == int(dec_ref.steps_taken) == k
    assert x.shape == x_ref.shape and x.dtype == np.float32
    assert _rel(x, x_ref) < 1e-4, _rel(x, x_ref)


def test_solve_function_tuple(problem):
    d, u, v, p, b = problem
    k = 25
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    x, _ = s.solve(b, k=k, f=("inv", "exp"))
    x_ref, _ = JaxFused(d, u, v, p, interpret=True).solve(
        b, k=k, f=("inv", "exp"))
    assert x.shape == (2, s.n)
    for i, f in enumerate(("inv", "exp")):
        assert _rel(x[i], x_ref[i]) < 1e-4
        # the replay does not depend on y: each slice is its single solve
        np.testing.assert_array_equal(x[i], s.solve(b, k=k, f=f)[0])


def test_solve_raw_and_device_rhs(problem):
    d, u, v, p, b = problem
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    x_np, _ = s.solve(b, k=12)
    bt = torch.from_numpy(b)
    x_raw, dec = s.solve(bt, k=12, raw=True)
    assert isinstance(x_raw, torch.Tensor) and x_raw.shape == (s.n,)
    np.testing.assert_array_equal(x_raw.numpy(), x_np)
    assert isinstance(dec, LanczosDecomposition) and dec.k_max == 12


def test_unported_options_raise(problem):
    # what the fused solver does not take, as in the JAX package: f64
    # kernels, a callback with the one-pass method, an unknown method
    d, u, v, p, b = problem
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    with pytest.raises(ValueError, match="two_pass"):
        s.solve(b, k=5, method="one_pass", callback=lambda *a: True)
    with pytest.raises(ValueError, match="unknown method"):
        s.solve(b, k=5, method="three_pass")
    with pytest.raises(ValueError, match="f32"):
        FusedKKTSolver(d, u, v, p, dtype=torch.float64, device=CPU)


@pytest.mark.parametrize("f", ["inv", "exp"])
def test_plain_f64_matches_jax_x64(problem, f):
    d, u, v, p, b = problem
    d64 = d.astype(np.float64) / 3.0  # keep exp(A) in range
    b64 = b.astype(np.float64)
    k = 25
    op = tpl.make_kkt_operator(d64, u, v, p, backend="xla", dtype=jnp.float64)
    x_ref = np.asarray(tpl.solve_fAb(op, jnp.asarray(b64), k=k, f=f,
                                     method="two_pass"))
    t = torch.from_numpy

    def mv(x):
        return kkt_matvec(t(d64), t(u), t(v), p, x)

    bt = t(b64)
    dec, _ = pass_one_scan(mv, bt, k)
    y = padded_f_e1(dec, f) * dec.b_norm
    x, _ = pass_two_scan(mv, bt, dec, y)
    assert _rel(x.numpy(), x_ref) < 1e-10, _rel(x.numpy(), x_ref)


@pytest.mark.parametrize("f", ["inv", "exp", "callable"])
@pytest.mark.parametrize("steps", [8, 5, 1])
def test_padded_f_e1_matches_jax(f, steps):
    rng = np.random.default_rng(steps)
    k = 8
    alphas = rng.uniform(1.0, 3.0, k)
    betas = rng.uniform(0.1, 0.5, k)
    alphas[steps:] = 0.0
    betas[steps - 1:] = 0.0
    tf, jf = (torch.sin, jnp.sin) if f == "callable" else (f, f)
    ours = padded_f_e1(LanczosDecomposition(
        torch.from_numpy(alphas), torch.from_numpy(betas),
        torch.tensor(steps, dtype=torch.int32), torch.tensor(1.0)), tf)
    ref = jax_padded_f_e1(JaxDecomposition(
        jnp.asarray(alphas), jnp.asarray(betas), jnp.asarray(steps, jnp.int32),
        jnp.asarray(1.0)), jf)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)
    assert np.all(ours.numpy()[steps:] == 0.0)
    # the valid block is the host solve on the unpadded T_s
    host = host_f_tk_solve(alphas[:steps], betas[:steps - 1],
                           np.sin if f == "callable" else f)
    np.testing.assert_allclose(ours.numpy()[:steps], host, atol=1e-12)
