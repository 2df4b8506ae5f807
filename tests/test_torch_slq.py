"""The port's stochastic Lanczos quadrature (``slq.py``) against the JAX
package's on the same probes (f64 at 1e-10), and its keyed entry points
held to the contracts of ``tests/test_slq.py``: exact Rademacher traces of
diagonal operators, exact polynomial quadrature, the analytic log-det, the
adaptive loop's minimum, target and cap, a density of mass 1. The keys are
CPU ``torch.Generator``s (or int seeds); JAX's random bits are not
reproduced, so the probes of a comparison are made with NumPy."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import two_pass_lanczos_tpu as jtpl
import two_pass_lanczos_tpu_torch as tpl
from tests.torch_cases import CPU
from two_pass_lanczos_tpu import slq as jslq
from two_pass_lanczos_tpu_torch import slq
from two_pass_lanczos_tpu_torch.spectrum import quadratic_form


def _diag_op(d):
    return tpl.DiagonalOperator(np.asarray(d, np.float64), device=CPU)


def _jax_diag_op(d):
    return jtpl.DiagonalOperator(jnp.asarray(d, jnp.float64))


def _probes(m, n, seed):
    return np.random.default_rng(seed).standard_normal((m, n))


def test_batched_pass_one_bit_identical_to_solo_and_jax():
    n, m, k = 150, 4, 25
    d = np.linspace(0.5, 50.0, n)
    bs = _probes(m, n, 0)
    op = _diag_op(d)
    batched = tpl.lanczos_pass_one_batched(op, bs, k)
    assert batched.alphas.shape == (m, k)
    assert batched.steps_taken.shape == (m,)
    jb = jtpl.lanczos_pass_one_batched(_jax_diag_op(d), jnp.asarray(bs), k)
    for i in range(m):
        solo = tpl.lanczos_pass_one(op, torch.from_numpy(bs[i]), k)
        assert torch.equal(batched.alphas[i], solo.alphas)
        assert torch.equal(batched.betas[i], solo.betas)
        assert int(batched.steps_taken[i]) == solo.steps()
    np.testing.assert_allclose(batched.alphas.numpy(), np.asarray(jb.alphas),
                               rtol=1e-10)
    np.testing.assert_allclose(batched.betas.numpy(), np.asarray(jb.betas),
                               rtol=1e-10)
    np.testing.assert_allclose(batched.b_norm.numpy(), np.asarray(jb.b_norm),
                               rtol=1e-12)


@pytest.mark.parametrize("f", ["inv", "exp", "log"])
def test_batched_quadratic_form_matches_host_spectrum_and_jax(f):
    n, m, k = 120, 3, 30
    d = np.linspace(1.0, 10.0, n)
    bs = _probes(m, n, 1)
    op = _diag_op(d)
    batched = tpl.lanczos_pass_one_batched(op, bs, k)
    dev = tpl.batched_quadratic_form(batched, f).numpy()
    for i in range(m):
        solo = tpl.lanczos_pass_one(op, torch.from_numpy(bs[i]), k)
        assert dev[i] == pytest.approx(quadratic_form(solo, f), rel=1e-11)
    jb = jtpl.lanczos_pass_one_batched(_jax_diag_op(d), jnp.asarray(bs), k)
    np.testing.assert_allclose(
        dev, np.asarray(jtpl.batched_quadratic_form(jb, f)), rtol=1e-10)


def test_batched_quadratic_form_solo_decomposition():
    op = _diag_op(np.linspace(1.0, 4.0, 40))
    b = np.random.default_rng(2).standard_normal(40)
    decomp = tpl.lanczos_pass_one(op, torch.from_numpy(b), 20)
    got = tpl.batched_quadratic_form(decomp, "inv")
    assert got.shape == ()
    assert float(got) == pytest.approx(quadratic_form(decomp, "inv"),
                                       rel=1e-11)


def test_ritz_weights_same_decomposition_as_jax():
    # the JAX decomposition, converted: the padded T and the batched eigh
    # give JAX's Ritz values and weights, breakdown rows included
    d = [2.0, 3.0, 5.0, 7.0, 11.0, 13.0]
    bs = np.array([[1.0, 0, 0, 0, 0, 0], [1.0, 1.0, 0, 0, 0, 0],
                   [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]])
    jb = jtpl.lanczos_pass_one_batched(_jax_diag_op(d), jnp.asarray(bs), 5)
    theta, w = tpl.batched_ritz_weights(tpl.LanczosDecomposition(
        *(torch.from_numpy(np.array(a)) for a in (
            jb.alphas, jb.betas, jb.steps_taken, jb.b_norm))))
    jtheta, jw = jtpl.batched_ritz_weights(jb)
    np.testing.assert_allclose(theta.numpy(), np.asarray(jtheta), rtol=1e-12)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-10,
                               atol=1e-14)


def test_breakdown_rows_padded_safely():
    op = _diag_op([2.0, 3.0, 5.0, 7.0])
    bs = np.array([[1.0, 0.0, 0.0, 0.0], [1.0, 1.0, 1.0, 1.0]])
    batched = tpl.lanczos_pass_one_batched(op, bs, 4)
    assert int(batched.steps_taken[0]) == 1
    quad = tpl.batched_quadratic_form(batched, "inv").numpy()
    assert quad[0] == pytest.approx(0.5, rel=1e-13)
    assert quad[1] == pytest.approx(sum(1.0 / v for v in (2.0, 3.0, 5.0, 7.0)),
                                    rel=1e-12)
    # the padded eigenpairs carry no weight at all
    theta, w = tpl.batched_ritz_weights(batched)
    assert float(w[0].sum()) == pytest.approx(1.0, rel=1e-14)
    assert float(w[0][theta[0] == slq._PAD_DIAG].sum()) == 0.0


def test_zero_probe_row_yields_zero():
    quad = tpl.batched_quadratic_form(
        tpl.lanczos_pass_one_batched(_diag_op(np.ones(8)), np.zeros((2, 8)),
                                     3), "inv").numpy()
    np.testing.assert_array_equal(quad, [0.0, 0.0])


@pytest.mark.parametrize("f", ["inv", "exp"])
def test_slq_run_same_probes_as_jax(f):
    # the seam that takes arrays: the same probes through both packages
    n, m, k = 200, 6, 20
    d = np.linspace(0.5, 5.0, n)
    probes = np.sign(_probes(m, n, 5))
    res = slq._slq_run(_diag_op(d), torch.from_numpy(probes), k, f)
    jres = jslq._slq_run(_jax_diag_op(d), jnp.asarray(probes), k, f)
    np.testing.assert_allclose(res.samples.numpy(), np.asarray(jres.samples),
                               rtol=1e-10)
    assert float(res.estimate) == pytest.approx(float(jres.estimate),
                                                rel=1e-10)
    assert float(res.stderr) == pytest.approx(float(jres.stderr), rel=1e-8)


def test_rademacher_diag_trace_is_exact():
    d = np.array([1.0, 1.0, 4.0, 4.0, 4.0, 9.0] * 20)
    res = tpl.slq_trace(_diag_op(d), "inv", k=8, num_probes=4,
                        key=torch.Generator().manual_seed(0))
    assert float(res.estimate) == pytest.approx(float(np.sum(1.0 / d)),
                                                rel=1e-10)
    assert float(res.stderr) == pytest.approx(0.0, abs=1e-8)
    assert res.samples.shape == (4,)


def test_slq_logdet_converges_to_analytic():
    d = np.linspace(0.5, 20.0, 400)
    res = tpl.slq_logdet(_diag_op(d), k=40, num_probes=24, key=3)
    assert float(res.estimate) == pytest.approx(float(np.sum(np.log(d))),
                                                rel=1e-6)


def test_slq_gaussian_probes_within_sampling_error():
    d = np.linspace(1.0, 10.0, 300)
    res = tpl.slq_trace(_diag_op(d), "inv", k=30, num_probes=48, key=7,
                        probe="gaussian")
    err = abs(float(res.estimate) - float(np.sum(1.0 / d)))
    assert float(res.stderr) > 0.0
    assert err < 5.0 * float(res.stderr) + 1e-9


def test_slq_callable_f_and_determinism():
    d = np.linspace(0.1, 2.0, 64)
    op = _diag_op(d)
    a = tpl.slq_trace(op, lambda x: x ** 2, k=16, num_probes=8, key=11)
    b = tpl.slq_trace(op, lambda x: x ** 2, k=16, num_probes=8,
                      key=torch.Generator().manual_seed(11))
    # an int seed is a fresh CPU generator with that seed
    assert torch.equal(a.samples, b.samples)
    assert float(a.estimate) == pytest.approx(float(np.sum(d ** 2)),
                                              rel=1e-10)
    # no global random state is read or written
    state = torch.random.get_rng_state()
    tpl.slq_trace(op, "inv", k=4, num_probes=2, key=1)
    assert torch.equal(torch.random.get_rng_state(), state)


def test_slq_dense_operator():
    n = 96
    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.linspace(0.5, 8.0, n)
    op = tpl.DenseOperator((q * d) @ q.T, device=CPU)
    truth = float(np.sum(np.log(d)))
    res = tpl.slq_logdet(op, k=48, num_probes=64, key=9)
    err = abs(float(res.estimate) - truth)
    assert err < 5.0 * float(res.stderr) + 1e-6 * abs(truth)


def test_slq_on_vendored_kkt_operator():
    # tr(A²) = Σ d_i² + 4m, and the 2-point quadrature is exact for z²
    dmx = sorted((Path(__file__).resolve().parents[1] / "data" / "1000")
                 .glob("*.dmx"))
    if not dmx:
        pytest.skip("no vendored data/1000 instances")
    from two_pass_lanczos_tpu_torch.utils.data_loader import load_kkt_arrays

    arrays = load_kkt_arrays(dmx[0], dmx[0].with_suffix(".qfc"))
    dsc = arrays.quad_costs / float(np.max(arrays.quad_costs))
    op = tpl.make_kkt_operator(dsc, arrays.arc_u, arrays.arc_v,
                               arrays.num_nodes, dtype=torch.float64,
                               device=CPU)
    truth = float(np.sum(dsc ** 2)) + 4.0 * arrays.num_arcs
    res = tpl.slq_trace(op, lambda x: x ** 2, k=4, num_probes=64, key=13)
    err = abs(float(res.estimate) - truth)
    assert err < 5.0 * float(res.stderr) + 1e-9 * truth


class TestAdaptive:
    def test_zero_variance_stops_at_minimum(self):
        d = np.array([1.0, 4.0, 9.0] * 50)
        res = tpl.slq_trace_adaptive(_diag_op(d), "inv", k=8, key=0,
                                     batch=4, target_rel_stderr=1e-6)
        assert res.samples.shape[0] == 8
        assert float(res.estimate) == pytest.approx(float(np.sum(1.0 / d)),
                                                    rel=1e-9)

    def test_grows_probes_to_target(self):
        # Gaussian probes on this spectrum: the relative stderr of m samples
        # is ~0.078/√m, so 0.01 needs ~60 probes, far past two batches (the
        # JAX test's 0.02 sits at 16 probes, on the edge for another key)
        d = np.linspace(1.0, 10.0, 500)
        truth = float(np.sum(1.0 / d))
        res = tpl.slq_trace_adaptive(_diag_op(d), "inv", k=30, key=5,
                                     probe="gaussian",
                                     target_rel_stderr=0.01, batch=8,
                                     max_probes=512)
        assert res.samples.shape[0] > 16
        assert float(res.stderr) <= 0.01 * abs(float(res.estimate)) + 1e-12
        assert abs(float(res.estimate) - truth) < 5 * float(res.stderr) + 1e-9

    @pytest.mark.parametrize("max_probes", [24, 10])
    def test_respects_max_probes(self, max_probes):
        # 10: the cap holds when it is not a batch multiple
        d = np.linspace(1.0, 10.0, 200)
        res = tpl.slq_trace_adaptive(_diag_op(d), "inv", k=16, key=1,
                                     probe="gaussian",
                                     target_rel_stderr=1e-12, batch=8,
                                     max_probes=max_probes)
        assert res.samples.shape[0] == max_probes
        assert float(res.stderr) > 0.0

    def test_loop_matches_jax_on_the_same_samples(self):
        # the shared driver alone: the same per-batch samples give JAX's
        # stopping point, estimate and stderr
        table = np.random.default_rng(8).normal(3.0, 1.0, 64)

        def batches(wrap):
            drawn = [0]

            def run(_, take):
                out = table[drawn[0]:drawn[0] + take]
                drawn[0] += take
                return wrap(out)
            return run

        kw = dict(batch=6, max_probes=50, target_rel_stderr=0.04)
        ours = slq.adaptive_probe_loop(batches(torch.from_numpy), 0, **kw)
        ref = jslq.adaptive_probe_loop(batches(jnp.asarray),
                                       jax.random.key(0), **kw)
        assert ours.samples.shape == ref.samples.shape
        np.testing.assert_array_equal(ours.samples.numpy(),
                                      np.asarray(ref.samples))
        assert float(ours.stderr) == pytest.approx(float(ref.stderr),
                                                   rel=1e-12)

    @pytest.mark.parametrize("kw,match", [
        (dict(batch=1), "batch"), (dict(target_rel_stderr=0.0),
                                   "target_rel_stderr"),
        (dict(max_probes=1), "max_probes")])
    def test_validation(self, kw, match):
        with pytest.raises(ValueError, match=match):
            tpl.slq_trace_adaptive(_diag_op(np.ones(8)), "inv", key=0, **kw)


def test_spectral_density_integrates_to_one_and_locates_mass():
    d = np.concatenate([np.full(100, 2.0), np.full(100, 5.0),
                        np.full(100, 8.0)])
    grid = np.linspace(0.0, 10.0, 401)
    phi = tpl.slq_spectral_density(_diag_op(d), grid, sigma=0.2, k=12,
                                   num_probes=16, key=0).numpy()
    dt = grid[1] - grid[0]
    assert float(np.sum(phi) * dt) == pytest.approx(1.0, rel=1e-3)
    for center in (2.0, 5.0, 8.0):
        sel = np.abs(grid - center) < 0.6
        assert float(np.sum(phi[sel]) * dt) == pytest.approx(1 / 3, rel=0.05)
    for gap in (3.5, 6.5):
        sel = np.abs(grid - gap) < 0.4
        assert float(np.sum(phi[sel]) * dt) < 0.01
    assert float(np.sum(grid * phi) * dt) == pytest.approx(5.0, rel=0.02)


def test_density_same_probes_as_jax():
    n, m, k = 222, 4, 16
    d = np.linspace(0.5, 9.0, n)
    probes = _probes(m, n, 12)
    probes /= np.linalg.norm(probes, axis=1, keepdims=True)
    grid = np.linspace(0.0, 10.0, 101)
    phi = slq._dos_run(_diag_op(d), torch.from_numpy(probes),
                       torch.from_numpy(grid), 0.3, k).numpy()
    jphi = np.asarray(jslq._dos_run(_jax_diag_op(d), jnp.asarray(probes),
                                    jnp.asarray(grid), jnp.asarray(0.3), k))
    np.testing.assert_allclose(phi, jphi, rtol=1e-10,
                               atol=1e-12 * jphi.max())
    assert abs(np.trapezoid(phi, grid) - 1.0) < 0.05


@pytest.mark.parametrize("call,match", [
    (lambda op: tpl.slq_spectral_density(op, np.ones((2, 2)), key=0),
     "grid"),
    (lambda op: tpl.slq_spectral_density(op, np.linspace(0, 1, 10),
                                         sigma=-1.0, key=0), "sigma"),
    (lambda op: tpl.slq_spectral_density(op, np.linspace(0, 1, 10),
                                         num_probes=0, key=0), "num_probes"),
    (lambda op: tpl.slq_trace(op, "inv", k=4, num_probes=0, key=0),
     "num_probes"),
    (lambda op: tpl.slq_trace(op, "inv", k=4, num_probes=2, key=0,
                              probe="uniform"), "probe kind"),
    (lambda op: tpl.slq_trace(op, "sqrtish", k=4, num_probes=2, key=0),
     "unknown function"),
    (lambda op: tpl.lanczos_pass_one_batched(op, np.ones(8), 3),
     "bs must be"),
])
def test_input_validation(call, match):
    with pytest.raises(ValueError, match=match):
        call(_diag_op(np.ones(8)))


def test_key_must_be_a_cpu_generator_or_a_seed():
    op = _diag_op(np.ones(8))
    with pytest.raises(TypeError, match="key"):
        tpl.slq_trace(op, "inv", k=4, num_probes=2, key="seed")
    with pytest.raises(TypeError):
        tpl.slq_trace(op, "inv", k=4, num_probes=2)  # key is required
