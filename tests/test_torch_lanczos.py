"""Pass one and pass two of the port (``ops/kkt_fused.FusedKKTSolver`` on
the CPU, i.e. the plain ``pass_one_scan`` / ``pass_two_scan``) held against
the JAX fused solver in interpret mode, at ``tests/test_fused.py``'s
tolerances, plus the replay invariants. The kernels K2 and K3 are held to
the plain versions in ``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_cases import CPU, random_kkt
from two_pass_lanczos_tpu.ops.kkt_fused import FusedKKTSolver as JaxFused
from two_pass_lanczos_tpu_torch.algorithms.core import (
    pass_one_last_vector,
    pass_one_scan,
    pass_two_scan,
)
from two_pass_lanczos_tpu_torch.convert import (
    decomposition_from_jax,
    solver_from_jax,
)
from two_pass_lanczos_tpu_torch.ops.kkt_fused import FusedKKTSolver
from two_pass_lanczos_tpu_torch.ops.spmv import kkt_matvec


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(42)
    d, u, v, p = random_kkt(rng)
    b = rng.standard_normal(len(d) + p).astype(np.float32)
    jax_solver = JaxFused(d, u, v, p, interpret=True)
    return d, u, v, p, b, jax_solver


def _y_full(dec, nf, seed):
    k = dec.k_max
    y = np.random.default_rng(seed).standard_normal((nf, k)).astype(np.float32)
    y[:, int(dec.steps_taken):] = 0.0
    return y


def test_pass_one_matches_jax(problem):
    d, u, v, p, b, js = problem
    k = 20
    ref = js.pass_one(js.pack(b), k)
    dec = solver_from_jax(js, device=CPU).pass_one(b, k)
    assert dec.steps() == int(ref.steps_taken) == k
    np.testing.assert_allclose(dec.alphas.numpy(), np.asarray(ref.alphas),
                               rtol=1e-4)
    np.testing.assert_allclose(dec.betas.numpy(), np.asarray(ref.betas),
                               rtol=1e-4)
    np.testing.assert_allclose(float(dec.b_norm), float(ref.b_norm), rtol=1e-6)


@pytest.mark.parametrize("nf", [None, 2], ids=["single", "stack2"])
def test_pass_two_on_jax_decomposition(problem, nf):
    d, u, v, p, b, js = problem
    k = 20
    b_rep = js.pack(b)
    ref_dec = js.pass_one(b_rep, k)
    y = _y_full(ref_dec, nf or 1, seed=3)
    y = y if nf else y[0]
    xu, xn = js.pass_two(b_rep, ref_dec, jnp.asarray(y))
    xu, xn = np.asarray(xu), np.asarray(xn)
    if nf:
        x_ref = np.stack([js.layout.unpack(xu[i], xn[i]) for i in range(nf)])
    else:
        x_ref = js.layout.unpack(xu, xn)
    x = solver_from_jax(js, device=CPU).pass_two(
        b, decomposition_from_jax(ref_dec, device=CPU),
        torch.from_numpy(y)).numpy()
    assert x.shape == x_ref.shape
    rel = np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)
    assert rel < 1e-5, rel


def test_breakdown_truncates():
    # all arcs share their endpoints, so the Krylov space is tiny
    m, p = 130, 130
    u = np.zeros(m, np.int32)
    v = np.ones(m, np.int32)
    d = np.full(m, 2.0, np.float32)
    b = np.zeros(m + p, np.float32)
    b[0] = 1.0
    x, dec = FusedKKTSolver(d, u, v, p, device=CPU).solve(b, k=12, f="inv")
    x_ref, dec_ref = JaxFused(d, u, v, p, interpret=True).solve(b, k=12, f="inv")
    assert dec.steps() == int(dec_ref.steps_taken) < 12
    assert float(dec.betas[dec.steps() - 1]) == 0.0
    assert np.all(dec.alphas.numpy()[dec.steps():] == 0.0)
    assert np.all(np.isfinite(x))
    np.testing.assert_allclose(x, x_ref, atol=1e-5)


def test_zero_b_gives_zero():
    d, u, v, p = random_kkt(np.random.default_rng(7), m=300, p=64)
    x, dec = FusedKKTSolver(d, u, v, p, device=CPU).solve(
        np.zeros(len(d) + p, np.float32), k=8, f="inv")
    assert dec.steps() == 0
    np.testing.assert_array_equal(x, 0.0)


@pytest.mark.parametrize("breakdown", [False, True], ids=["full", "breakdown"])
def test_replay_is_bitwise(problem, breakdown):
    # pass two regenerates pass one's basis bit for bit: every row of the
    # emitted bases, and the final v_s through the solver's state tensors
    d, u, v, p, b, _ = problem
    if breakdown:
        m, p = 130, 130
        u, v = np.zeros(m, np.int32), np.ones(m, np.int32)
        d = np.full(m, 2.0, np.float32)
        b = np.zeros(m + p, np.float32)
        b[0] = 1.0
    k = 30
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    bt = torch.from_numpy(b)
    lay = s.layout

    def mv(x):
        return kkt_matvec(lay.d, lay.u, lay.v, lay.p, x)

    dec, basis1 = pass_one_scan(mv, bt, k, emit_basis=True)
    assert (dec.steps() < k) == breakdown
    y = torch.from_numpy(_y_full(dec, 1, seed=5)[0])
    _, basis2 = pass_two_scan(mv, bt, dec, y, emit_basis=True)
    assert torch.equal(basis1, basis2)

    st1 = torch.empty(2, s.n)
    st2 = torch.empty(2, s.n)
    dec_s = s.pass_one(b, k, state=st1)
    s.pass_two(b, dec_s, y, state=st2)
    v_s = basis1[dec.steps() - 1]
    assert torch.equal(pass_one_last_vector(dec_s, st1), v_s)
    assert torch.equal(st2[1], v_s)
