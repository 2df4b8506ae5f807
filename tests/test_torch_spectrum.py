"""The port's ``spectrum`` (Ritz values and pairs, residual bounds, Gauss
and Gauss–Radau quadratures, A-norm certificates) against the JAX
package's on the same arrays, in f64 at 1e-10, and held to the analytic
truths of ``tests/test_spectrum.py`` (diagonal operators)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import two_pass_lanczos_tpu as jtpl
import two_pass_lanczos_tpu_torch as tpl
from tests.torch_cases import CPU, random_kkt
from two_pass_lanczos_tpu import spectrum as jspec
from two_pass_lanczos_tpu_torch import spectrum
from two_pass_lanczos_tpu_torch.convert import decomposition_from_jax


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def _decs(d, b, k):
    """The port's and the JAX package's f64 pass one on diag(d), b."""
    dec = tpl.lanczos_pass_one(tpl.DiagonalOperator(_t(d), device=CPU),
                               _t(b), k)
    jdec = jtpl.lanczos_pass_one(jtpl.DiagonalOperator(jnp.asarray(d)),
                                 jnp.asarray(b, jnp.float64), k)
    return dec, jdec


def _diag_problem(n=200, lo=0.1, hi=100.0, seed=0):
    d = np.linspace(lo, hi, n)
    b = np.random.default_rng(seed).standard_normal(n)
    return d, b


def test_tridiagonal_valid_shapes_and_dtype():
    d, b = _diag_problem()
    dec, jdec = _decs(d, b, 17)
    al, be = spectrum.tridiagonal_valid(dec)
    assert al.shape == (17,) and be.shape == (16,)
    assert al.dtype == np.float64 and be.dtype == np.float64
    jal, jbe = jspec.tridiagonal_valid(jdec)
    np.testing.assert_allclose(al, jal, rtol=1e-10)
    np.testing.assert_allclose(be, jbe, rtol=1e-10)


#: every public function of the module, on one decomposition
FUNCS = {
    "ritz_values": lambda m, dec: m.ritz_values(dec),
    "ritz_pairs": lambda m, dec: np.abs(m.ritz_pairs(dec)[1]),
    "ritz_residual_bounds": lambda m, dec: m.ritz_residual_bounds(dec),
    "quadratic_form_inv": lambda m, dec: m.quadratic_form(dec, "inv"),
    "quadratic_form_exp": lambda m, dec: m.quadratic_form(dec, "exp"),
    "quadratic_form_log": lambda m, dec: m.quadratic_form(dec, "log"),
    "gauss_radau_bracket": lambda m, dec: m.gauss_radau_bracket(dec, 0.5),
    "quadrature_bracket": lambda m, dec: m.quadrature_bracket(
        dec, (0.5, 11.0), "exp"),
    "a_norm_error_history": lambda m, dec: np.concatenate(
        m.a_norm_error_history(dec, 0.5, stride=3)),
}


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_same_decomposition_same_answer(name):
    # the JAX package's decomposition, converted: both modules see the same
    # coefficients, so only the host arithmetic may differ
    d, b = _diag_problem(n=150, lo=0.5, hi=10.0, seed=3)
    _, jdec = _decs(d, b, 18)
    ours = FUNCS[name](spectrum, decomposition_from_jax(jdec, device=CPU))
    ref = FUNCS[name](jspec, jdec)
    np.testing.assert_allclose(np.asarray(ours, np.float64),
                               np.asarray(ref, np.float64), rtol=1e-12,
                               atol=1e-300)


def test_ritz_values_exact_at_full_dimension():
    n = 24
    d = np.linspace(1.0, 2.0, n)
    b = np.random.default_rng(1).standard_normal(n)
    dec, jdec = _decs(d, b, n)
    theta = spectrum.ritz_values(dec)
    assert theta.shape == (dec.steps(),)
    np.testing.assert_allclose(theta, np.sort(d)[: theta.size], rtol=1e-10)
    np.testing.assert_allclose(theta, jspec.ritz_values(jdec), rtol=1e-10)


def test_extreme_ritz_values_converge_first():
    d, b = _diag_problem()
    errs = []
    for k in (20, 40, 80):
        dec, jdec = _decs(d, b, k)
        theta = spectrum.ritz_values(dec)
        errs.append(abs(theta[-1] - d.max()) / d.max())
        assert theta[0] >= d.min() - 1e-12
        assert theta[-1] <= d.max() + 1e-10
        jtheta = jspec.ritz_values(jdec)
        np.testing.assert_allclose(theta[[0, -1]], jtheta[[0, -1]],
                                   rtol=1e-10)
    assert errs[2] < errs[1] < errs[0]
    assert errs[2] < 1e-9


def test_ritz_residual_identity_against_real_matvec():
    d, b = _diag_problem(lo=1.0, hi=10.0)
    k = 20
    dec, basis = tpl.lanczos_standard(
        tpl.DiagonalOperator(_t(d), device=CPU), _t(b), k)
    theta, s_vecs = spectrum.ritz_pairs(dec)
    bounds = spectrum.ritz_residual_bounds(dec)
    v = basis.numpy()[: dec.steps()]
    for j in [0, k // 2, k - 1]:
        u = v.T @ s_vecs[:, j]
        resid = np.linalg.norm(d * u - theta[j] * u)
        assert bounds[j] == pytest.approx(resid, rel=1e-8, abs=1e-12)
    _, jdec = _decs(d, b, k)
    np.testing.assert_allclose(bounds, jspec.ritz_residual_bounds(jdec),
                               rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("f", ["inv", "exp", "log"])
def test_quadratic_form_matches_direct(f):
    d, b = _diag_problem(lo=1.0, hi=10.0)
    fn, truth = {
        "inv": ("inv", b @ (b / d)),
        "exp": (lambda x: np.exp(-x), b @ (np.exp(-d) * b)),
        "log": ("log", b @ (np.log(d) * b)),
    }[f]
    dec, jdec = _decs(d, b, 60)
    est = spectrum.quadratic_form(dec, fn)
    assert est == pytest.approx(float(truth), rel=1e-10)
    assert est == pytest.approx(jspec.quadratic_form(jdec, fn), rel=1e-10)
    if f == "log":
        # the device analogue takes the same string set
        dev = float(tpl.batched_quadratic_form(dec, "log"))
        assert est == pytest.approx(dev, rel=1e-10)


def test_gauss_radau_bracket_encloses_and_tightens():
    d, b = _diag_problem()
    truth = float(b @ (b / d))
    widths = []
    for k in (20, 40, 80):
        dec, jdec = _decs(d, b, k)
        lo, hi = spectrum.gauss_radau_bracket(dec, lambda_min=d.min())
        assert lo <= truth * (1 + 1e-12), (k, lo, truth)
        assert hi >= truth * (1 - 1e-12), (k, hi, truth)
        jlo, jhi = jspec.gauss_radau_bracket(jdec, lambda_min=d.min())
        assert lo == pytest.approx(jlo, rel=1e-10)
        assert hi == pytest.approx(jhi, rel=1e-10)
        widths.append(hi - lo)
    assert widths[2] < widths[1] < widths[0]
    assert widths[2] < 1e-6 * truth


def test_breakdown_makes_everything_exact():
    dec, _ = _decs([2.0, 3.0], [1.0, 0.0], 2)
    assert dec.steps() == 1
    np.testing.assert_array_equal(spectrum.ritz_residual_bounds(dec), [0.0])
    assert spectrum.quadratic_form(dec, "inv") == pytest.approx(
        0.5, rel=1e-14)
    lo, hi = spectrum.gauss_radau_bracket(dec, lambda_min=1.0)
    assert lo == hi == pytest.approx(0.5, rel=1e-14)


def test_zero_b_empty_results():
    dec, _ = _decs(np.ones(4), np.zeros(4), 3)
    assert dec.steps() == 0
    assert spectrum.ritz_values(dec).size == 0
    assert spectrum.ritz_residual_bounds(dec).size == 0
    assert spectrum.quadratic_form(dec) == 0.0
    assert spectrum.gauss_radau_bracket(dec, 1.0) == (0.0, 0.0)


@pytest.mark.parametrize("call,match", [
    (lambda dec: spectrum.gauss_radau_bracket(dec, 0.0), "lambda_min"),
    (lambda dec: spectrum.quadratic_form(dec, "sqrt"), "unknown function"),
])
def test_validation(call, match):
    d, b = _diag_problem()
    dec, _ = _decs(d, b, 5)
    with pytest.raises(ValueError, match=match):
        call(dec)


def test_accepts_df_path_decomposition():
    n, k = 150, 30
    d = np.linspace(1.0, 10.0, n)
    b = np.random.default_rng(6).standard_normal(n)
    dec_df = tpl.lanczos_pass_one_df(
        tpl.DFDiagonalOperator.from_f64(d, device=CPU), b, k)
    dec64, _ = _decs(d, b, k)
    np.testing.assert_allclose(spectrum.ritz_values(dec_df),
                               spectrum.ritz_values(dec64), rtol=1e-7)
    truth = float(b @ (b / d))
    assert spectrum.quadratic_form(dec_df, "inv") == pytest.approx(
        truth, rel=1e-7)
    bounds = spectrum.ritz_residual_bounds(dec_df)
    assert bounds.shape == (k,) and np.all(bounds >= 0)
    lo, hi = spectrum.gauss_radau_bracket(dec_df, lambda_min=1.0)
    assert lo <= truth * (1 + 1e-7) and hi >= truth * (1 - 1e-7)
    # the JAX df decomposition gives the same Ritz values
    jdec_df = jtpl.lanczos_pass_one_df(jtpl.DFDiagonalOperator.from_f64(d),
                                       b, k)
    np.testing.assert_allclose(spectrum.ritz_values(dec_df),
                               jspec.ritz_values(jdec_df), rtol=1e-10)


def test_accepts_chunked_and_fused_decompositions():
    d, b = _diag_problem(lo=1.0, hi=10.0)
    dec, _ = tpl.lanczos_standard_chunked(
        tpl.DiagonalOperator(_t(d), device=CPU), _t(b), 60, chunk=16)
    assert spectrum.quadratic_form(dec, "inv") == pytest.approx(
        float(b @ (b / d)), rel=1e-10)
    # the fused solver's pass one (f32): its Ritz values are those of the
    # JAX package's f32 pass one on the same KKT instance at f32 rounding
    rng = np.random.default_rng(4)
    dk, u, v, p = random_kkt(rng, m=300, p=100)
    bk = rng.standard_normal(len(dk) + p).astype(np.float32)
    fdec = tpl.FusedKKTSolver(dk, u, v, p, device=CPU).pass_one(bk, 12)
    jop = jtpl.make_kkt_operator(dk, u, v, p, backend="xla",
                                 dtype=jnp.float32)
    jdec = jtpl.lanczos_pass_one(jop, jnp.asarray(bk), 12)
    np.testing.assert_allclose(spectrum.ritz_values(fdec),
                               jspec.ritz_values(jdec), rtol=1e-4)


class TestANormErrorHistory:
    def test_bracket_encloses_true_error_spd_diagonal(self):
        n, k = 200, 40
        d = np.linspace(0.7, 25.0, n)
        b = np.random.default_rng(17).standard_normal(n)
        dec, jdec = _decs(d, b, k)
        js, lows, ups = spectrum.a_norm_error_history(dec, lambda_min=0.7)
        jjs, jlows, jups = jspec.a_norm_error_history(jdec, lambda_min=0.7)
        np.testing.assert_array_equal(js, jjs)
        # each bound is a difference of two quadratures: it agrees to the
        # quadratures' rounding, 1e-10 of the largest
        np.testing.assert_allclose(ups, jups, rtol=0, atol=1e-10 * ups[0])
        np.testing.assert_allclose(lows, jlows, rtol=0, atol=1e-10 * ups[0])
        assert js[0] == 1 and js[-1] == dec.steps() - 1
        op = tpl.DiagonalOperator(_t(d), device=CPU)
        x_true = b / d
        for j, lo, up in zip(js[::5], lows[::5], ups[::5]):
            x_j = tpl.solve_fAb(op, _t(b), k=int(j), f="inv",
                                method="one_pass").numpy()
            err = float(np.sqrt(np.sum(d * (x_true - x_j) ** 2)))
            assert lo <= err * (1 + 1e-8) + 1e-12, (j, lo, err)
            assert err <= up * (1 + 1e-8) + 1e-12, (j, err, up)
        assert ups[-1] < 1e-5 * ups[0]

    def test_validation_and_edges(self):
        dec, _ = _decs([2.0, 3.0], [1.0, 1.0], 2)
        with pytest.raises(ValueError, match="lambda_min > 0"):
            spectrum.a_norm_error_history(dec, 0.0)
        with pytest.raises(ValueError, match="stride"):
            spectrum.a_norm_error_history(dec, 1.0, stride=0)
        dec1, _ = _decs([2.0, 3.0], [1.0, 0.0], 2)
        js, lows, ups = spectrum.a_norm_error_history(dec1, 1.0)
        assert js.size == lows.size == ups.size <= 1


class TestQuadratureBracket:
    def test_exp_bracket_encloses_truth_indefinite(self):
        n = 150
        d = np.linspace(-2.0, 3.0, n)
        b = np.random.default_rng(41).standard_normal(n)
        truth = float(b @ (np.exp(d) * b))
        dec, jdec = _decs(d, b, 25)
        lo, up = spectrum.quadrature_bracket(dec, (-2.5, 3.5), "exp")
        assert lo <= truth * (1 + 1e-10) <= up * (1 + 1e-10)
        np.testing.assert_allclose(
            (lo, up), jspec.quadrature_bracket(jdec, (-2.5, 3.5), "exp"),
            rtol=1e-10)
        dec8, _ = _decs(d, b, 8)
        lo8, up8 = spectrum.quadrature_bracket(dec8, (-2.5, 3.5), "exp")
        assert lo8 <= lo and up <= up8
        assert (up - lo) < 0.01 * (up8 - lo8)

    def test_inv_bracket_delegates_to_gauss_radau(self):
        d = np.linspace(0.5, 9.0, 100)
        b = np.random.default_rng(43).standard_normal(100)
        dec, _ = _decs(d, b, 20)
        assert spectrum.quadrature_bracket(dec, (0.5, 9.0), "inv") == \
            spectrum.gauss_radau_bracket(dec, 0.5)
        truth = float(b @ (b / d))
        lo, up = spectrum.quadrature_bracket(dec, (0.5, 9.0), "inv")
        assert lo <= truth * (1 + 1e-10) <= up * (1 + 1e-10)

    @pytest.mark.parametrize("interval,f,match", [
        ((3.0, 1.0), "exp", "a < b"),
        ((-1.0, 2.0), "inv", "a > 0"),
        ((0.5, 2.0), np.sin, "sign-definite"),
    ])
    def test_validation(self, interval, f, match):
        dec, _ = _decs([1.0, 2.0], [1.0, 1.0], 2)
        with pytest.raises(ValueError, match=match):
            spectrum.quadrature_bracket(dec, interval, f)

    def test_breakdown_collapses_to_exact(self):
        dec, _ = _decs([2.0, 5.0], [1.0, 1.0], 6)
        lo, up = spectrum.quadrature_bracket(dec, (1.0, 6.0), "exp")
        truth = float(np.exp(2.0) + np.exp(5.0))
        assert lo == pytest.approx(truth, rel=1e-12)
        assert up == pytest.approx(truth, rel=1e-12)
