"""The port's double-float tier (``ops/df.py``, ``algorithms/df.py``) against
the JAX package's, on the CPU, at ``tests/test_df.py``'s thresholds: the
error-free transformations, the df operations and reductions, the df KKT
matvec, the df passes and solves, and the four properties with the hi and
lo basis bitwise across the passes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import two_pass_lanczos_tpu as jtpl
from tests.torch_cases import CPU
from two_pass_lanczos_tpu.algorithms import df as jdf_alg
from two_pass_lanczos_tpu.ops import df as jdf
from two_pass_lanczos_tpu_torch import (
    DFDiagonalOperator,
    DFKKTOperator,
    lanczos_pass_one_df,
    solve_fAb_df,
)
from two_pass_lanczos_tpu_torch.algorithms.core import pass_one_scan
from two_pass_lanczos_tpu_torch.algorithms.df import (
    df_breakdown_tolerance,
    lanczos_pass_two_with_basis_df,
    lanczos_standard_df,
)
from two_pass_lanczos_tpu_torch.convert import df_operator_from_jax
from two_pass_lanczos_tpu_torch.models.generator import generate_mcf_instance
from two_pass_lanczos_tpu_torch.models.synthetic import create_diagonal_problem
from two_pass_lanczos_tpu_torch.ops import df as tdf
from two_pass_lanczos_tpu_torch.ops.spmv import kkt_matvec


@pytest.fixture(scope="module")
def ab64():
    rng = np.random.default_rng(0)
    a64 = rng.standard_normal(4096) * 10.0 ** rng.integers(-3, 4, 4096)
    b64 = rng.standard_normal(4096) * 10.0 ** rng.integers(-3, 4, 4096)
    return a64, b64


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _truth_matvec(d, u, v, p, x):
    m = len(d)
    y = np.zeros(m + p)
    y[:m] = d * x[:m] + x[m + u] - x[m + v]
    np.add.at(y, m + u, x[:m])
    np.add.at(y, m + v, -x[:m])
    return y


# --- error-free transformations and df arithmetic --------------------------

def test_two_sum_bitwise_jax_and_exact(ab64):
    a = np.asarray(ab64[0], np.float32)
    b = np.asarray(ab64[1], np.float32)
    s, e = tdf.two_sum(_t(a), _t(b))
    js, je = jdf.two_sum(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(_np(s), np.asarray(js))
    np.testing.assert_array_equal(_np(e), np.asarray(je))
    np.testing.assert_array_equal(
        _np(s).astype(np.float64) + _np(e).astype(np.float64),
        a.astype(np.float64) + b.astype(np.float64))


def test_two_prod_near_exact_and_as_jax(ab64):
    a = np.asarray(ab64[0], np.float32)
    b = np.asarray(ab64[1], np.float32)
    p, e = tdf.two_prod(_t(a), _t(b))
    exact = a.astype(np.float64) * b.astype(np.float64)
    got = _np(p).astype(np.float64) + _np(e).astype(np.float64)
    rel = np.abs(got - exact) / np.maximum(np.abs(exact), 1e-300)
    assert rel.max() < 2.0 ** -44, rel.max()
    # the same mask split and op order as the JAX package
    jp, je = jdf.two_prod(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(_np(p), np.asarray(jp))
    np.testing.assert_array_equal(_np(e), np.asarray(je))


@pytest.mark.parametrize("op", ["add", "mul", "div", "sqrt"])
def test_df_ops_near_f64_and_jax(ab64, op):
    a64, b64 = ab64
    a, b = tdf.df_from_f64(a64), tdf.df_from_f64(b64)
    ja, jb = jdf.df_from_f64(a64), jdf.df_from_f64(b64)
    if op == "add":
        got, ref = tdf.df_add(a, b), jdf.df_add(ja, jb)
        truth, scale = a64 + b64, np.abs(a64) + np.abs(b64)
    elif op == "mul":
        got, ref = tdf.df_mul(a, b), jdf.df_mul(ja, jb)
        truth = a64 * b64
        scale = np.abs(truth)
    elif op == "div":
        got, ref = tdf.df_div(a, b), jdf.df_div(ja, jb)
        truth = a64 / b64
        scale = np.abs(truth)
    else:
        got = tdf.df_sqrt(tdf.df_from_f64(np.abs(a64)))
        ref = jdf.df_sqrt(jdf.df_from_f64(np.abs(a64)))
        truth = np.sqrt(np.abs(a64))
        scale = truth
    g64 = _np(tdf.df_to_f64(got))
    assert np.max(np.abs(g64 - truth) / scale) < 1e-13
    assert np.max(np.abs(g64 - jdf.df_to_f64(ref)) / scale) < 1e-13


def test_df_reductions(ab64):
    a64, b64 = ab64
    a, b = tdf.df_from_f64(a64), tdf.df_from_f64(b64)
    s = float(tdf.df_to_f64(tdf.df_sum(a)))
    assert abs(s - a64.sum()) / abs(a64).sum() < 1e-13
    d = float(tdf.df_to_f64(tdf.df_dot(a, b)))
    assert abs(d - a64 @ b64) / np.abs(a64 * b64).sum() < 1e-13
    jd = float(jdf.df_to_f64(jdf.df_dot(jdf.df_from_f64(a64),
                                        jdf.df_from_f64(b64))))
    assert abs(d - jd) / np.abs(a64 * b64).sum() < 1e-13
    nrm = float(tdf.df_to_f64(tdf.df_norm(a)))
    assert abs(nrm - np.linalg.norm(a64)) < 1e-13 * np.linalg.norm(a64)


def test_df_split_is_exact_and_f32_ops_match(ab64):
    a64 = ab64[0]
    x = tdf.df_from_f64(a64)
    assert x.hi.dtype == torch.float32 and x.lo.dtype == torch.float32
    np.testing.assert_array_equal(_np(x.hi), a64.astype(np.float32))
    jx = jdf.df_from_f64(a64)
    np.testing.assert_array_equal(_np(x.lo), np.asarray(jx.lo))
    f = np.asarray(ab64[1], np.float32)
    for name in ("df_add_f32", "df_mul_f32"):
        got = getattr(tdf, name)(x, _t(f))
        ref = getattr(jdf, name)(jx, jnp.asarray(f))
        scale = np.abs(a64) + np.abs(f.astype(np.float64))
        if name == "df_mul_f32":
            scale = np.abs(a64 * f)
        assert np.max(np.abs(_np(tdf.df_to_f64(got)) - jdf.df_to_f64(ref))
                      / scale) < 1e-13, name
    z = tdf.df_zeros_like(x)
    assert not z.hi.any() and not z.lo.any()


# --- the df KKT matvec ------------------------------------------------------

@pytest.fixture(scope="module")
def kkt5000():
    rng = np.random.default_rng(3)
    m, p = 5000, 64
    u = rng.integers(0, p, m)
    v = (u + 1 + rng.integers(0, p - 1, m)) % p
    d = rng.uniform(1.0, 1000.0, m)
    x = rng.standard_normal(m + p)
    return d, u, v, p, x


def test_df_kkt_matvec_matches_f64_and_jax(kkt5000):
    d, u, v, p, x = kkt5000
    op = DFKKTOperator.from_f64(d, u, v, p, device=CPU)
    y = _np(tdf.df_to_f64(op.matvec_df(tdf.df_from_f64(x))))
    y_true = _truth_matvec(d, u, v, p, x)
    scale = np.abs(y_true).max()
    assert np.max(np.abs(y - y_true)) / scale < 1e-13
    jop = jdf_alg.DFKKTOperator.from_f64(d, u, v, p)
    y_jax = jdf.df_to_f64(jop.matvec_df(jdf.df_from_f64(x)))
    assert np.max(np.abs(y - y_jax)) / scale < 1e-13
    # the converted JAX operator computes with the same (hi, lo) pair
    conv = df_operator_from_jax(jop, device=CPU)
    assert torch.equal(conv.d2, op.d2)
    y_conv = conv.matvec_df(tdf.df_from_f64(x))
    assert np.max(np.abs(_np(tdf.df_to_f64(y_conv)) - y_jax)) / scale < 1e-13


def test_df_operator_table_guard_hub_graph():
    p, m = 70_000, 2000
    u = np.zeros(m, np.int64)  # star: node 0 has degree m
    v = 1 + np.arange(m, dtype=np.int64) % (p - 1)
    with pytest.raises(ValueError, match="DFFusedKKTSolver"):
        DFKKTOperator.from_f64(np.ones(m), u, v, p, device=CPU)


# --- the df passes ----------------------------------------------------------

def test_df_pass_one_matches_jax_on_kkt():
    rng = np.random.default_rng(11)
    m, p, k = 2500, 200, 20
    u = rng.integers(0, p, m).astype(np.int32)
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    d = rng.uniform(0.5, 5.0, m)
    b = rng.standard_normal(m + p)
    dec = lanczos_pass_one_df(DFKKTOperator.from_f64(d, u, v, p, device=CPU),
                              b, k)
    jdec = jdf_alg.lanczos_pass_one_df(
        jdf_alg.DFKKTOperator.from_f64(d, u, v, p), b, k)
    assert dec.steps() == jdec.steps() == k
    np.testing.assert_allclose(dec.alphas_f64(), jdec.alphas_f64(), rtol=0,
                               atol=1e-11)
    np.testing.assert_allclose(dec.betas_f64(), jdec.betas_f64(), rtol=0,
                               atol=1e-11)
    bn = float(tdf.df_to_f64(dec.b_norm))
    assert abs(bn - np.linalg.norm(b)) < 1e-12 * np.linalg.norm(b)


def test_df_coefficients_beat_f32_at_k200_inv_ill():
    """k = 200, inv/ill spectrum: max |Δα|, |Δβ| against the f64 oracle
    ≥ 10× better than plain f32, and < 1e-12 (``tests/test_df.py``)."""
    n, k = 10_000, 200
    op64, eigs = create_diagonal_problem(n, "ill-conditioned", "inv",
                                         device=CPU)
    b = np.random.default_rng(42).standard_normal(n)
    d64, _ = pass_one_scan(op64.matvec, _t(b), k)
    a64, b64 = d64.alphas.numpy(), d64.betas.numpy()
    ddf = lanczos_pass_one_df(DFDiagonalOperator.from_f64(eigs, device=CPU),
                              b, k)
    assert ddf.steps() == k
    a_df = np.abs(ddf.alphas_f64() - a64).max()
    b_df = np.abs(ddf.betas_f64() - b64[: k - 1]).max()
    e32 = _t(np.asarray(eigs, np.float32))
    d32, _ = pass_one_scan(lambda x: e32 * x, _t(b.astype(np.float32)), k)
    a_32 = np.abs(d32.alphas.numpy().astype(np.float64) - a64).max()
    b_32 = np.abs(d32.betas.numpy().astype(np.float64) - b64).max()
    assert a_df * 10 < a_32, (a_df, a_32)
    assert b_df * 10 < b_32, (b_df, b_32)
    assert a_df < 1e-12 and b_df < 1e-12, (a_df, b_df)


@pytest.mark.parametrize("method", ["two_pass", "one_pass"])
def test_df_solve_inv_at_f64_error_level(method):
    n, k = 2000, 60
    _, eigs = create_diagonal_problem(n, "well-conditioned", "inv", device=CPU)
    b = np.random.default_rng(7).standard_normal(n)
    x_true = b / eigs
    op = DFDiagonalOperator.from_f64(eigs, device=CPU)
    x_df = _np(solve_fAb_df(op, b, k=k, f="inv", method=method))
    jop64 = jtpl.DiagonalOperator(jnp.asarray(eigs))
    x_64 = np.asarray(jtpl.solve_fAb(jop64, jnp.asarray(b), k=k, f="inv",
                                     method=method))
    err_df = np.linalg.norm(x_df - x_true) / np.linalg.norm(x_true)
    err_64 = np.linalg.norm(x_64 - x_true) / np.linalg.norm(x_true)
    assert err_df < max(2.0 * err_64, 1e-12), (err_df, err_64)
    x_jax = jdf_alg.solve_fAb_df(jdf_alg.DFDiagonalOperator.from_f64(eigs), b,
                                 k=k, f="inv", method=method)
    assert np.linalg.norm(x_df - x_jax) / np.linalg.norm(x_jax) < 1e-12


def test_df_solve_exp():
    n, k = 1000, 40
    _, eigs = create_diagonal_problem(n, "well-conditioned", "exp", device=CPU)
    b = np.random.default_rng(9).standard_normal(n)
    x_df = _np(solve_fAb_df(DFDiagonalOperator.from_f64(eigs, device=CPU), b,
                            k=k, f="exp"))
    x_true = np.exp(eigs) * b
    assert np.linalg.norm(x_df - x_true) / np.linalg.norm(x_true) < 1e-6


def test_df_zero_b_and_breakdown():
    op = DFDiagonalOperator.from_f64(np.ones(16), device=CPU)
    assert lanczos_pass_one_df(op, np.zeros(16), 4).steps() == 0
    x = solve_fAb_df(op, np.zeros(16), k=4, f="inv")
    assert x.dtype == torch.float64 and not x.any()
    op2 = DFDiagonalOperator.from_f64(np.array([2.0, 3.0]), device=CPU)
    d = lanczos_pass_one_df(op2, np.array([1.0, 0.0]), 5)
    assert d.steps() == 1
    np.testing.assert_allclose(d.alphas_f64(), [2.0], atol=1e-14)
    dec, basis = lanczos_standard_df(op2, np.array([1.0, 0.0]), 5)
    assert dec.steps() == 1 and not basis.hi[1:].any()
    assert df_breakdown_tolerance() == 1000.0 * 2.0 ** -49


def test_df_one_pass_matches_two_pass():
    n, k = 1500, 50
    _, eigs = create_diagonal_problem(n, "well-conditioned", "inv", device=CPU)
    b = np.random.default_rng(13).standard_normal(n)
    opdf = DFDiagonalOperator.from_f64(eigs, device=CPU)
    x1 = _np(solve_fAb_df(opdf, b, k=k, f="inv", method="one_pass"))
    x2 = _np(solve_fAb_df(opdf, b, k=k, f="inv", method="two_pass"))
    assert np.linalg.norm(x1 - x2) / np.linalg.norm(x1) < 1e-12
    with pytest.raises(ValueError, match="unknown method"):
        solve_fAb_df(opdf, b, k=k, method="three_pass")


def test_df_four_properties_at_reference_tolerances():
    """The reference's four properties (k = 30, tol 5e-9) through the df
    path on a generated KKT instance; the regenerated basis is bitwise pass
    one's in both planes."""
    inst = generate_mcf_instance(3000, rho=3, instance_id=2)
    m, p = inst.num_arcs, inst.num_nodes
    n = m + p
    op = DFKKTOperator.from_f64(inst.quad_costs, inst.arc_u, inst.arc_v, p,
                                device=CPU)
    b = np.random.default_rng(42).standard_normal(n)
    k, tol = 30, 5e-9
    decomp, basis = lanczos_standard_df(op, b, k)
    assert decomp.steps() == k
    v = _np(tdf.df_to_f64(basis))
    alphas, betas = decomp.alphas_f64(), decomp.betas_f64()
    # 1. pass one (scalars only) == one-pass
    d2 = lanczos_pass_one_df(op, b, k)
    np.testing.assert_array_equal(d2.alphas_f64(), alphas)
    np.testing.assert_array_equal(d2.betas_f64(), betas)
    # 2. the Lanczos relation
    a = np.zeros((n, n))
    a[np.arange(m), np.arange(m)] = inst.quad_costs
    a[np.arange(m), m + inst.arc_u] += 1
    a[np.arange(m), m + inst.arc_v] -= 1
    a[m + inst.arc_u, np.arange(m)] += 1
    a[m + inst.arc_v, np.arange(m)] -= 1
    t = np.diag(alphas) + np.diag(betas, 1) + np.diag(betas, -1)
    av = v @ a
    resid = av - t @ v
    beta_k = float(tdf.df_to_f64(decomp.betas)[k - 1])
    v_next = resid[k - 1] / beta_k
    resid[k - 1] -= beta_k * v_next
    assert np.linalg.norm(resid) / np.linalg.norm(av) < tol
    assert abs(np.linalg.norm(v_next) - 1.0) < 1e-6
    # 3. orthonormality
    assert np.linalg.norm(np.eye(k) - v @ v.T) < tol
    # 4. reconstruction: the regenerated basis, bitwise in both planes
    _, basis2 = lanczos_pass_two_with_basis_df(op, b, decomp, np.zeros(k))
    assert torch.equal(basis2.hi, basis.hi)
    assert torch.equal(basis2.lo, basis.lo)
    # and the JAX package's df alphas on the same instance
    jdec = jdf_alg.lanczos_pass_one_df(jdf_alg.DFKKTOperator.from_f64(
        inst.quad_costs, inst.arc_u, inst.arc_v, p), b, k)
    atol = 1e-11 * np.abs(alphas).max()
    np.testing.assert_allclose(alphas, jdec.alphas_f64(), rtol=0, atol=atol)


def test_df_kkt_matvec_plain_arc_part_is_the_kernel_order(kkt5000):
    # the arc rows round as K11 does: exact product plus cross terms, then
    # df_add2 of the gathered difference (ops/eft.py is K13's plain twin)
    from two_pass_lanczos_tpu_torch.ops import eft
    d, u, v, p, x = kkt5000
    m = len(d)
    op = DFKKTOperator.from_f64(d, u, v, p, device=CPU)
    xd = tdf.df_from_f64(x)
    y = op.plain_matvec_df(xd)
    ph, pe = eft.two_prod(op.d.hi, xd.hi[:m])
    pe = pe + (op.d.hi * xd.lo[:m] + op.d.lo * xd.hi[:m])
    xn_h, xn_l = xd.hi[m:], xd.lo[m:]
    th, tl = eft.df_add2(xn_h[u], xn_l[u], -xn_h[v], -xn_l[v])
    yh, yl = eft.df_add2(ph, pe, th, tl)
    assert torch.equal(y.hi[:m], yh) and torch.equal(y.lo[:m], yl)
