"""The port's ``DFFusedKKTSolver`` (on the CPU: the plain df passes over the
plain df matvec) against the JAX package's ``DFFusedKKTSolver`` in
interpret mode and against the f64 oracle, on the non-power-of-two shapes
of ``tests/test_fused_df.py``.

The JAX interpret kernel takes several seconds per call, so each JAX result
is computed once in a module-scoped fixture (four kernel calls in all).
"""

import numpy as np
import pytest
import torch

from tests.torch_cases import CPU
from two_pass_lanczos_tpu.algorithms import df as jdf_alg
from two_pass_lanczos_tpu.ops.kkt_fused_df import (
    DFFusedKKTSolver as JaxDFFused,
)
from two_pass_lanczos_tpu_torch import DFFusedKKTSolver, lanczos_pass_one_df
from two_pass_lanczos_tpu_torch.algorithms.core import (
    pass_one_scan,
    pass_two_scan,
)
from two_pass_lanczos_tpu_torch.algorithms.df import DFKKTOperator
from two_pass_lanczos_tpu_torch.convert import df_solver_from_jax
from two_pass_lanczos_tpu_torch.functions import padded_f_e1
from two_pass_lanczos_tpu_torch.ops.df import DF
from two_pass_lanczos_tpu_torch.ops.kkt_fused_df import (
    DF_BREAKDOWN_TOL,
    df_kkt_matvec,
)
from two_pass_lanczos_tpu_torch.ops.spmv import kkt_matvec


def _kkt(rng, m, p):
    u = rng.integers(0, p, m).astype(np.int32)
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    d = rng.uniform(0.5, 5.0, m)
    return d, u, v


def _truth_matvec(d, u, v, p, x):
    m = len(d)
    y = np.zeros(m + p)
    y[:m] = d * x[:m] + x[m + u] - x[m + v]
    np.add.at(y, m + u, x[:m])
    np.add.at(y, m + v, -x[:m])
    return y


def _f64_mv(d, u, v, p):
    t = torch.from_numpy
    return lambda x: kkt_matvec(t(np.asarray(d, np.float64)), t(u), t(v), p, x)


def _f64_solve(d, u, v, p, b, k):
    """The f64 generic two-pass solve (the CPU oracle, itself held to the
    JAX package's x64 solve in ``tests/test_torch_solve.py``)."""
    mv = _f64_mv(d, u, v, p)
    bt = torch.from_numpy(b)
    dec, _ = pass_one_scan(mv, bt, k)
    x, _ = pass_two_scan(mv, bt, dec, padded_f_e1(dec, "inv") * dec.b_norm)
    return x.numpy()


def _f64(h, lo):
    return h.double().numpy() + lo.double().numpy()


@pytest.fixture(scope="module")
def tracks():
    """m = 5000, p = 300, k = 25: the JAX kernel's pass one."""
    rng = np.random.default_rng(11)
    m, p = 5000, 300
    d, u, v = _kkt(rng, m, p)
    b = rng.standard_normal(m + p)
    js = JaxDFFused(d, u, v, p, interpret=True)
    out = [np.asarray(a) for a in js.pass_one(js.pack(b), 25)]
    return d, u, v, p, b, js, out


@pytest.fixture(scope="module")
def solve_inv():
    """m = 3000, p = 260: the JAX kernels' inv solve at k = 60."""
    rng = np.random.default_rng(11)
    m, p = 3000, 260
    d, u, v = _kkt(rng, m, p)
    n = m + p
    x_true = np.full(n, 1.0 / np.sqrt(n))
    b = _truth_matvec(d, u, v, p, x_true)
    x_jax, (a_jax, _, s_jax) = JaxDFFused(d, u, v, p, interpret=True).solve(
        b, k=60, f="inv")
    return d, u, v, p, b, x_true, x_jax, a_jax, s_jax


def test_df_fused_pass_one_tracks_f64_and_jax(tracks):
    d, u, v, p, b, _, (jah, jal, jbh, jbl, jbn, jst) = tracks
    k = 25
    s = DFFusedKKTSolver(d, u, v, p, device=CPU)
    ah, al, bh, bl, bn2, st = s.pass_one(s.pack(b), k)
    assert int(st[0]) == int(jst[0]) == k
    a64, b64 = _f64(ah, al), _f64(bh, bl)
    dref, _ = pass_one_scan(_f64_mv(d, u, v, p), torch.from_numpy(b), k)
    np.testing.assert_allclose(a64, dref.alphas.numpy(), rtol=0, atol=1e-11)
    np.testing.assert_allclose(b64[:k - 1], dref.betas.numpy()[:k - 1],
                               rtol=0, atol=1e-11)
    ja = jah.astype(np.float64) + jal.astype(np.float64)
    jb = jbh.astype(np.float64) + jbl.astype(np.float64)
    np.testing.assert_allclose(a64, ja, rtol=0, atol=1e-11)
    np.testing.assert_allclose(b64[:k - 1], jb[:k - 1], rtol=0, atol=1e-11)
    bn = float(bn2[0]) + float(bn2[1])
    assert abs(bn - np.linalg.norm(b)) < 1e-12 * np.linalg.norm(b)
    assert abs(bn - (float(jbn[0]) + float(jbn[1]))) < 1e-12 * bn


def test_df_solver_from_jax_computes_with_the_same_pair(tracks):
    d, u, v, p, b, js, (jah, jal, *_) = tracks
    conv = df_solver_from_jax(js, device=CPU)
    ours = DFFusedKKTSolver(d, u, v, p, device=CPU)
    assert conv.n == ours.n == len(d) + p
    assert torch.equal(conv.d2, ours.d2)
    assert torch.equal(conv.layout.u, ours.layout.u)
    assert torch.equal(conv.layout.v, ours.layout.v)
    k = 6
    got = conv.pass_one(b, k)
    want = ours.pass_one(b, k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    ja = jah[:k].astype(np.float64) + jal[:k].astype(np.float64)
    np.testing.assert_allclose(_f64(got[0], got[1]), ja, rtol=0, atol=1e-11)


def test_df_fused_solve_inv(solve_inv):
    d, u, v, p, b, x_true, x_jax, a_jax, s_jax = solve_inv
    s = DFFusedKKTSolver(d, u, v, p, device=CPU)
    x, (a64, b64, steps) = s.solve(b, k=60, f="inv")
    assert isinstance(x, torch.Tensor) and x.dtype == torch.float64
    assert steps == s_jax == 60 and a64.dtype == np.float64
    x = x.numpy()
    rel = np.linalg.norm(x - x_true) / np.linalg.norm(x_true)
    x64 = _f64_solve(d, u, v, p, b, 60)
    rel64 = np.linalg.norm(x64 - x_true) / np.linalg.norm(x_true)
    assert rel < max(2.0 * rel64, 1e-12), (rel, rel64)
    rel_jax = np.linalg.norm(x_jax - x_true) / np.linalg.norm(x_true)
    assert rel_jax < max(2.0 * rel64, 1e-12), (rel_jax, rel64)
    np.testing.assert_allclose(a64, a_jax, rtol=0, atol=1e-10)


def test_df_fused_matches_generic_df_trajectory():
    """Same working precision: the fused solver's trajectory, the generic
    df pass one's, and the JAX fused kernel's agree at 1e-11."""
    rng = np.random.default_rng(11)
    m, p, k = 2500, 200, 20
    d, u, v = _kkt(rng, m, p)
    b = rng.standard_normal(m + p)
    s = DFFusedKKTSolver(d, u, v, p, device=CPU)
    ah, al, *_ = s.pass_one(s.pack(b), k)
    a_fused = _f64(ah, al)
    ddf = lanczos_pass_one_df(DFKKTOperator.from_f64(d, u, v, p, device=CPU),
                              b, k)
    np.testing.assert_allclose(a_fused, ddf.alphas_f64(), rtol=0, atol=1e-11)
    js = JaxDFFused(d, u, v, p, interpret=True)
    jah, jal, *_ = js.pass_one(js.pack(b), k)
    ja = np.asarray(jah, np.float64) + np.asarray(jal, np.float64)
    np.testing.assert_allclose(a_fused, ja, rtol=0, atol=1e-11)
    jop = jdf_alg.DFKKTOperator.from_f64(d, u, v, p)
    jg = jdf_alg.lanczos_pass_one_df(jop, b, k)
    np.testing.assert_allclose(a_fused, jg.alphas_f64(), rtol=0, atol=1e-11)


def test_df_fused_breakdown_and_zero_b():
    rng = np.random.default_rng(11)
    m, p = 600, 100
    d, u, v = _kkt(rng, m, p)
    s = DFFusedKKTSolver(d, u, v, p, device=CPU)
    x, (a64, b64, steps) = s.solve(np.zeros(m + p), k=5, f="inv")
    assert steps == 0 and len(a64) == 0 and not x.any()
    # a breakdown inside the run: all arcs share their endpoints, so the
    # Krylov space of b = e_1 is tiny
    dd = np.full(130, 2.0)
    bb = np.zeros(260)
    bb[0] = 1.0
    sb = DFFusedKKTSolver(dd, np.zeros(130), np.ones(130), 130, device=CPU)
    coeffs = sb.pass_one(bb, 12)
    st = int(coeffs[5][0])
    assert 0 < st < 12
    assert float(coeffs[2][st - 1]) == 0.0 and float(coeffs[0][st - 1]) != 0
    assert DF_BREAKDOWN_TOL == 1000.0 * 2.0 ** -49
    x, (_, _, st2) = sb.solve(bb, k=12)
    assert st2 == st and bool(torch.isfinite(x).all())


def test_df_fused_exp():
    rng = np.random.default_rng(11)
    m, p = 1500, 130
    d, u, v = _kkt(rng, m, p)
    n = m + p
    b = rng.standard_normal(n)
    x, _ = DFFusedKKTSolver(d, u, v, p, device=CPU).solve(b, k=40, f="exp")
    x = x.numpy()
    assert np.all(np.isfinite(x))
    a_dense = np.zeros((n, n))
    a_dense[np.arange(m), np.arange(m)] = d
    a_dense[np.arange(m), m + u] += 1
    a_dense[np.arange(m), m + v] -= 1
    a_dense[m + u, np.arange(m)] += 1
    a_dense[m + v, np.arange(m)] -= 1
    lam, q = np.linalg.eigh(a_dense)
    x_true = q @ (np.exp(lam) * (q.T @ b))
    assert np.linalg.norm(x - x_true) / np.linalg.norm(x_true) < 1e-2


def test_df_pass_two_direct_subnormal_b_yields_zeros():
    rng = np.random.default_rng(11)
    d, u, v = _kkt(rng, 900, 80)
    s = DFFusedKKTSolver(d, u, v, 80, device=CPU)
    b_rep = s.pack(np.full(900 + 80, 1e-42))
    coeffs = s.pass_one(b_rep, 4)
    assert int(coeffs[5][0]) == 0
    y = torch.zeros(4)
    x2 = s.pass_two(b_rep, coeffs, y, y)
    assert bool(torch.isfinite(x2).all()) and not x2.any()


def test_df_fused_pack_forms():
    rng = np.random.default_rng(5)
    d, u, v = _kkt(rng, 300, 40)
    s = DFFusedKKTSolver(d, u, v, 40, device=CPU)
    b = rng.standard_normal(340)
    b2 = s.pack(b)
    assert b2.shape == (2, 340) and b2.dtype == torch.float32
    np.testing.assert_array_equal(b2[0].numpy(), b.astype(np.float32))
    np.testing.assert_array_equal(
        b2[0].double().numpy() + b2[1].double().numpy(),
        b.astype(np.float32).astype(np.float64)
        + (b - b.astype(np.float32)).astype(np.float32))
    assert torch.equal(s.pack(torch.from_numpy(b)), b2)
    assert s.pack(b2).data_ptr() == b2.data_ptr()  # a packed pair in place
    assert torch.equal(s.unpack64(b2), b2[0].double() + b2[1].double())
    with pytest.raises(ValueError, match="shape"):
        s.pack(b[:-1])
    # the f64 costs are split once, never through f32 first
    assert torch.equal(s.d2[1], torch.from_numpy(
        (d - d.astype(np.float32).astype(np.float64)).astype(np.float32)))
    # df_kkt_matvec on CPU tensors is the plain table fold
    y2 = df_kkt_matvec(s.op, b2)
    y = s.op.plain_matvec_df(DF(b2[0], b2[1]))
    assert torch.equal(y2[0], y.hi) and torch.equal(y2[1], y.lo)


@pytest.mark.parametrize("case", [
    ("tiny", 3, 2),
    ("single_arc", 1, 2),
    ("p_lane_aligned", 300, 256),
    ("p_one_segment", 200, 100),
    ("all_arcs_one_pair", 400, 50),
    ("hub_and_spokes", 600, 130),
    ("m_less_than_p", 64, 500),
], ids=lambda c: c[0])
def test_df_fused_matvec_fuzz(case):
    """Degenerate topologies: one pass-one step of the df matvec and dots
    against the f64 truth (``tests/test_fused_df.py``'s fuzz)."""
    rng = np.random.default_rng(11)
    name, m, p = case
    if name == "all_arcs_one_pair":
        u = np.zeros(m, np.int32)
        v = np.ones(m, np.int32)
    elif name == "hub_and_spokes":
        u = np.zeros(m, np.int32)
        v = (1 + rng.integers(0, p - 1, m)).astype(np.int32)
    else:
        u = rng.integers(0, p, m).astype(np.int32)
        v = ((u + 1 + rng.integers(0, max(p - 1, 1), m)) % p).astype(np.int32)
    d = rng.uniform(0.5, 5.0, m)
    b = rng.standard_normal(m + p)
    s = DFFusedKKTSolver(d, u, v, p, device=CPU)
    ah, al, *_ = s.pass_one(s.pack(b), 2)
    v1 = b / np.linalg.norm(b)
    a1_true = v1 @ _truth_matvec(d, u, v, p, v1)
    a1 = float(ah[0]) + float(al[0])
    assert abs(a1 - a1_true) < 1e-11 * max(abs(a1_true), 1.0), (a1, a1_true)
