"""The port's host modules: ``observability`` (replay, stopping point,
truncation, trace, the K1 speed-of-light model), ``checkpoint`` (the JAX
package's ``.npz`` format, version 1, both ways) and ``convergence`` held to
``tests/test_aux.py``, ``tests/test_fused.py::test_checkpoint_resume_fused``
and the JAX package's own functions on the same coefficients."""

import numpy as np
import pytest
import torch

from tests.torch_cases import CPU, random_kkt
from two_pass_lanczos_tpu import checkpoint as jax_checkpoint
from two_pass_lanczos_tpu import convergence as jax_convergence
from two_pass_lanczos_tpu import observability as jax_observability
from two_pass_lanczos_tpu.ops.kkt_fused import FusedKKTSolver as JaxFused
from two_pass_lanczos_tpu_torch import (
    convergence,
    find_stopping_point,
    load_decomposition,
    observability,
    padded_f_e1,
    replay_iterations,
    save_decomposition,
    truncate_decomposition,
)
from two_pass_lanczos_tpu_torch.convert import decomposition_from_jax
from two_pass_lanczos_tpu_torch.ops.kkt_fused import FusedKKTSolver


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(42)
    d, u, v, p = random_kkt(rng, m=500, p=130)
    b = rng.standard_normal(len(d) + p).astype(np.float32)
    return d, u, v, p, b


def _y_full(dec):
    y = padded_f_e1(dec, "inv")
    keep = torch.arange(dec.k_max) < dec.steps_taken
    return torch.where(keep, y * dec.b_norm, torch.zeros(()))


def test_callback_replay_views(problem):
    d, u, v, p, b = problem
    k = 15
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    decomp, basis = s.pass_one_with_basis(b, k)
    seen = []

    def cb(step, v_view, tk):
        alphas, betas = tk
        assert v_view.shape == (step, s.n)
        assert alphas.shape == (step,)
        assert betas.shape == (max(step - 1, 0),)
        seen.append(step)
        return True

    assert replay_iterations(decomp, cb, basis) == k
    assert seen == list(range(1, k + 1))


def test_callback_early_stop_and_truncation(problem):
    d, u, v, p, b = problem
    k = 15
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    decomp = s.pass_one(b, k)

    def cb(step, _v, tk):
        return step < 10

    stop = find_stopping_point(decomp, cb)
    assert stop == 10
    trunc = truncate_decomposition(decomp, stop)
    assert trunc.steps() == 10
    assert np.all(trunc.alphas.numpy()[10:] == 0)
    assert np.all(trunc.betas.numpy()[9:] == 0)
    np.testing.assert_array_equal(trunc.alphas_valid(),
                                  decomp.alphas_valid()[:10])
    # the truncated decomposition drives a valid (shorter) second pass
    x = s.pass_two(b, trunc, _y_full(trunc))
    assert np.all(np.isfinite(x.numpy()))
    # the same answers as the JAX package on its own decomposition
    js = JaxFused(d, u, v, p, interpret=True)
    jdec = js.pass_one(js.pack(b), k)
    assert jax_observability.find_stopping_point(jdec, cb) == stop
    jtr = jax_observability.truncate_decomposition(jdec, stop)
    ptr = truncate_decomposition(
        decomposition_from_jax(jdec, device=CPU), stop)
    np.testing.assert_array_equal(ptr.alphas.numpy(), np.asarray(jtr.alphas))
    np.testing.assert_array_equal(ptr.betas.numpy(), np.asarray(jtr.betas))
    assert ptr.steps() == int(jtr.steps_taken)


def test_decomposition_accessors_match_jax(problem):
    d, u, v, p, b = problem
    js = JaxFused(d, u, v, p, interpret=True)
    jdec = js.pass_one(js.pack(b), 12)
    dec = decomposition_from_jax(jdec, device=CPU)
    np.testing.assert_array_equal(dec.alphas_valid(), jdec.alphas_valid())
    np.testing.assert_array_equal(dec.betas_valid(), jdec.betas_valid())
    assert dec.beta_last() == jdec.beta_last()


def test_checkpoint_resume_fused(problem, tmp_path):
    d, u, v, p, b = problem
    k = 15
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    dec = s.pass_one(b, k)
    save_decomposition(tmp_path / "dec.npz", dec)
    # "another job": a fresh solver, load, replay pass two
    s2 = FusedKKTSolver(d, u, v, p, device=CPU)
    dec2 = load_decomposition(tmp_path / "dec.npz", device=CPU)
    assert torch.equal(dec2.alphas, dec.alphas)
    assert dec2.steps_taken.dtype == torch.int32 and dec2.steps() == k
    x = s2.pass_two(b, dec2, _y_full(dec2)).numpy()
    x_direct, _ = s.solve(b, k=k, f="inv")
    np.testing.assert_allclose(x, x_direct, rtol=0, atol=1e-6)


def test_checkpoint_jax_save_port_load(problem, tmp_path):
    d, u, v, p, b = problem
    k = 15
    js = JaxFused(d, u, v, p, interpret=True)
    jdec = js.pass_one(js.pack(b), k)
    jax_checkpoint.save_decomposition(tmp_path / "jax_dec", jdec)
    dec = load_decomposition(tmp_path / "jax_dec", device=CPU)
    np.testing.assert_array_equal(dec.alphas.numpy(), np.asarray(jdec.alphas))
    np.testing.assert_array_equal(dec.betas.numpy(), np.asarray(jdec.betas))
    assert dec.steps() == int(jdec.steps_taken)
    assert float(dec.b_norm) == float(jdec.b_norm)
    # pass two of the port on the JAX package's pass one
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    x = s.pass_two(b, dec, _y_full(dec)).numpy()
    x_ref, _ = js.solve(b, k=k, f="inv")
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-4


def test_checkpoint_port_save_jax_load(problem, tmp_path):
    d, u, v, p, b = problem
    dec = FusedKKTSolver(d, u, v, p, device=CPU).pass_one(b, 15)
    save_decomposition(tmp_path / "port_dec.npz", dec)
    jdec = jax_checkpoint.load_decomposition(tmp_path / "port_dec.npz")
    np.testing.assert_array_equal(np.asarray(jdec.alphas), dec.alphas.numpy())
    np.testing.assert_array_equal(np.asarray(jdec.betas), dec.betas.numpy())
    assert int(jdec.steps_taken) == dec.steps()
    assert np.asarray(jdec.alphas).dtype == np.float32


def test_checkpoint_rejects_unknown_version(tmp_path):
    np.savez(tmp_path / "bad.npz", alphas=np.zeros(2), betas=np.zeros(2),
             steps_taken=np.int32(0), b_norm=np.float32(0),
             meta='{"version": 99}')
    with pytest.raises(ValueError, match="unsupported"):
        load_decomposition(tmp_path / "bad.npz", device=CPU)


def test_trace_names_a_profiler_region():
    # no profiler: the shared null context, no record_function
    off = observability.trace("tpl_off")
    with off:
        torch.ones(4).sum()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        on = observability.trace("tpl_region")
        with on:
            torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert "tpl_region" in names and "tpl_off" not in names
    assert isinstance(on, torch.profiler.record_function)
    assert not isinstance(off, torch.profiler.record_function)


def test_sol_model_of_the_port_layout():
    # headline: m = 500,000 arcs, p = 1,155 nodes
    m, p = 500_000, 1155
    assert observability.kkt_matvec_bytes(m, p) == 28 * m + 12 * p + 4
    rep = observability.kkt_spmv_sol(m, p, achieved_seconds=13.6e-6)
    assert rep.nnz == 5 * m
    assert rep.sol_seconds == pytest.approx(
        rep.bytes_per_matvec / observability.H100_SXM_HBM3_BW)
    assert 0 < rep.sol_fraction < 1
    assert "speed of light" in str(rep)


@pytest.mark.parametrize("f", ["inv", "exp"])
def test_convergence_matches_jax(problem, f):
    d, u, v, p, b = problem
    dec = FusedKKTSolver(d, u, v, p, device=CPU).pass_one(b, 30)
    a, bt = dec.alphas_valid(), dec.betas_valid()
    np.testing.assert_allclose(
        convergence.update_norm(a, bt, f, lag=5),
        jax_convergence.update_norm(a, bt, f, lag=5), rtol=1e-12)
    assert (convergence.convergence_history(a, bt, f, lag=5, stride=4)
            == pytest.approx(jax_convergence.convergence_history(
                a, bt, f, lag=5, stride=4), rel=1e-12))


def test_radau_error_bound_matches_jax():
    # SPD tridiagonal coefficients (a diagonal-dominant T)
    rng = np.random.default_rng(7)
    a = rng.uniform(3.0, 5.0, 12)
    bt = rng.uniform(0.1, 0.9, 11)
    for s in (1, 2, 5, 12):
        np.testing.assert_allclose(
            convergence.radau_error_bound(a[:s], bt[:s - 1], 1.0),
            jax_convergence.radau_error_bound(a[:s], bt[:s - 1], 1.0),
            rtol=1e-12)
    cb = convergence.make_radau_error_callback(1.0, tol=1e-3)
    jcb = jax_convergence.make_radau_error_callback(1.0, tol=1e-3)
    for s in range(1, 13):
        coeffs = (a[:s], bt[:s - 1])
        go = cb(s, None, coeffs)
        assert go == jcb(s, None, coeffs)
        if not go:
            break
    assert cb.stopped_at is not None and cb.stopped_at == jcb.stopped_at
    assert cb.history == pytest.approx(jcb.history, rel=1e-12)
