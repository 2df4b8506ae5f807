"""The fused solver's capability methods: ``FusedKKTSolver.slq_trace``,
``slq_spectral_density``, ``slq_trace_adaptive``, ``estimate_interval``
and ``chebyshev_fAb``.

On the CPU (``device="cpu"``, the plain versions) they are held against
the JAX fused solver in interpret mode at m ≤ 500 on the same probes and
vectors, at the tolerances of ``tests/test_fused.py`` (SLQ samples rtol
2e-3 at k = 20, the density rtol 5e-3, Chebyshev 2e-4·max|y|), and the
keyed entry points to the contracts of its ``TestFusedSLQ``,
``TestFusedDOS`` and ``TestFusedChebyshev``.

The tests marked ``requires_cuda`` run the kernels on a card and skip
here: ``_slq_pass_one`` is one K2 launch a probe (K6's on a compensated
solver), each row bitwise ``pass_one_cuda`` alone; ``chebyshev_fAb`` is
exactly ``degree`` K1 launches; ``estimate_interval`` launches K8 only and
is cached. The module imports jax only inside the CPU tests' fixture, so
the card tests run where PyTorch alone is set up::

    python -m pytest --noconftest tests/test_torch_capability_fused.py -m requires_cuda
"""

import types

import numpy as np
import pytest
import torch

# the sibling module by its own name, as in tests/test_torch_cuda.py
from torch_cases import CPU, breakdown_kkt, cuda_device, random_kkt  # noqa: F401
from two_pass_lanczos_tpu_torch import (
    FusedKKTSolver,
    chebyshev_fAb,
    make_kkt_operator,
    slq_trace,
)
from two_pass_lanczos_tpu_torch import slq
from two_pass_lanczos_tpu_torch.eigen import eigsh
from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
    LAUNCHES,
    pass_one_cuda,
    reset_launches,
)
from two_pass_lanczos_tpu_torch.ops.spmv import kkt_matvec


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported here and only for the CPU tests."""
    import jax.numpy as jnp

    from two_pass_lanczos_tpu import slq as jslq
    from two_pass_lanczos_tpu.ops.kkt_fused import FusedKKTSolver as JaxFused

    return types.SimpleNamespace(jnp=jnp, slq=jslq, Fused=JaxFused)


def _kkt(seed=42, m=400, p=160):
    return random_kkt(np.random.default_rng(seed), m=m, p=p)


def _signs(m_probes, n, seed):
    rng = np.random.default_rng(seed)
    return np.sign(rng.standard_normal((m_probes, n))).astype(np.float32)


# --- SLQ on the CPU ---------------------------------------------------------

@pytest.mark.parametrize("compensated", [False, True], ids=["K2", "K6"])
def test_slq_pass_one_matches_jax_fused(jx, compensated):
    d, u, v, p = _kkt()
    k, probes = 20, _signs(6 if not compensated else 2, 400 + 160, 3)
    dec = FusedKKTSolver(d, u, v, p, device=CPU,
                         compensated=compensated)._slq_pass_one(probes, k)
    ref = jx.Fused(d, u, v, p, interpret=True,
                   compensated=compensated)._slq_pass_one(probes, k)
    assert dec.alphas.shape == (len(probes), k)
    np.testing.assert_array_equal(dec.steps_taken.numpy(),
                                  np.asarray(ref.steps_taken))
    np.testing.assert_allclose(dec.alphas.numpy(), np.asarray(ref.alphas),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dec.betas.numpy(), np.asarray(ref.betas),
                               rtol=1e-4)
    for f in ("exp", "inv"):
        np.testing.assert_allclose(
            slq.batched_quadratic_form(dec, f).numpy(),
            np.asarray(jx.slq.batched_quadratic_form(ref, f)), rtol=2e-3)


def test_slq_pass_one_rows_are_solo_passes():
    d, u, v, p = _kkt()
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    probes = _signs(3, s.n, 4)
    dec = s._slq_pass_one(probes, 12)
    for i in range(3):
        solo = s.pass_one(probes[i], 12)
        assert torch.equal(dec.alphas[i], solo.alphas)
        assert torch.equal(dec.betas[i], solo.betas)
        assert torch.equal(dec.b_norm[i], solo.b_norm)


def test_slq_trace_matches_generic_tier_same_key():
    # the same key draws the same probes on every tier: the fused samples
    # are the generic KKT operator's at f32 rounding
    d, u, v, p = _kkt()
    res = FusedKKTSolver(d, u, v, p, device=CPU).slq_trace(
        "exp", k=20, num_probes=6, key=3)
    op = make_kkt_operator(d, u, v, p, dtype=torch.float32, device=CPU)
    ref = slq_trace(op, "exp", k=20, num_probes=6, key=3)
    np.testing.assert_allclose(res.samples.numpy(), ref.samples.numpy(),
                               rtol=2e-3)


def test_polynomial_quadrature_exact_per_probe():
    # f(z) = z²: each sample is ‖A·z‖² of its probe
    d, u, v, p = _kkt(m=300, p=120)
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    res = s.slq_trace(lambda t: t * t, k=8, num_probes=4, key=7)
    probes = slq._draw_probes(7, 4, s.n, torch.float32, "rademacher")
    t = torch.from_numpy
    for i in range(4):
        az = kkt_matvec(t(d), t(u), t(v), p, probes[i]).double()
        truth = float(az @ az)
        assert abs(float(res.samples[i]) - truth) < 2e-2 * abs(truth)


def test_slq_validation_rejects_before_drawing():
    d, u, v, p = _kkt(m=100, p=50)
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    with pytest.raises(ValueError, match="num_probes"):
        s.slq_trace("inv", num_probes=0, key=gen)
    with pytest.raises(ValueError, match="unknown"):
        s.slq_trace("nope", key=gen)
    assert torch.equal(gen.get_state(), state)  # no probe was drawn
    with pytest.raises(ValueError, match="probe kind"):
        s.slq_trace("inv", key=gen, probe="uniform")
    with pytest.raises(ValueError, match="probes must be"):
        s._slq_pass_one(np.ones(s.n, np.float32), 4)


def test_slq_trace_adaptive_on_fused():
    d, u, v, p = _kkt(m=300, p=120)
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    res = s.slq_trace_adaptive(lambda t: t * t, k=8, batch=4,
                               target_rel_stderr=0.2, max_probes=24, key=3)
    truth = float(np.sum(d.astype(np.float64) ** 2) + 4 * len(d))
    assert res.samples.shape[0] >= 8  # two-batch minimum
    assert abs(float(res.estimate) - truth) < 0.3 * truth
    assert (float(res.stderr) <= 0.2 * abs(float(res.estimate))
            or res.samples.shape[0] == 24)


def test_density_matches_jax_same_probes(jx):
    d, u, v, p = _kkt(m=300, p=120)
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    grid = np.linspace(-4.0, 6.0, 101)
    z = np.random.default_rng(9).standard_normal((4, s.n)).astype(np.float32)
    z = z / np.linalg.norm(z, axis=1, keepdims=True)
    phi = slq.dos_from_decomposition(s._slq_pass_one(z, 12), grid,
                                     0.2).numpy()
    js = jx.Fused(d, u, v, p, interpret=True)
    ref = np.asarray(jx.slq.dos_from_decomposition(
        js._slq_pass_one(z, 12), jx.jnp.asarray(grid, jx.jnp.float32),
        jx.jnp.asarray(0.2, jx.jnp.float32)))
    np.testing.assert_allclose(phi, ref, rtol=5e-3, atol=5e-4 * ref.max())
    # the keyed method: a density of mass 1, the same as its seam's
    phi_k = s.slq_spectral_density(grid, k=12, num_probes=4, key=9).numpy()
    assert abs(np.trapezoid(phi_k, grid) - 1.0) < 0.05
    with pytest.raises(ValueError, match="grid"):
        s.slq_spectral_density(np.ones((2, 2)), key=0)


# --- Chebyshev and the interval on the CPU -----------------------------------

def test_chebyshev_matches_jax_fused(jx):
    d, u, v, p = _kkt(m=500, p=150)
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    x_in = np.random.default_rng(1).standard_normal(s.n).astype(np.float32)
    iv = (-4.0, 6.0)
    y = s.chebyshev_fAb(x_in, "exp", degree=30, interval=iv)
    assert isinstance(y, np.ndarray) and y.dtype == np.float32
    ref = np.asarray(jx.Fused(d, u, v, p, interpret=True).chebyshev_fAb(
        x_in, "exp", degree=30, interval=iv))
    np.testing.assert_allclose(y, ref, rtol=2e-4, atol=2e-4 * np.abs(ref).max())
    # raw: the device tensor; the generic tier on the same operator agrees
    y_raw = s.chebyshev_fAb(torch.from_numpy(x_in), "exp", degree=30,
                            interval=iv, raw=True)
    assert isinstance(y_raw, torch.Tensor) and torch.equal(
        y_raw, torch.from_numpy(y))
    op = make_kkt_operator(d, u, v, p, dtype=torch.float32, device=CPU)
    y_gen = chebyshev_fAb(op, x_in, "exp", degree=30, interval=iv).numpy()
    np.testing.assert_allclose(y_gen, y, rtol=2e-4,
                               atol=2e-4 * np.abs(y).max())


def test_chebyshev_interval_validation():
    d, u, v, p = _kkt(m=100, p=50)
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    with pytest.raises(ValueError, match="sign-definite"):
        s.chebyshev_fAb(np.ones(s.n, np.float32), "inv",
                        interval=(-1.0, 1.0))


def test_auto_interval_cached_and_enclosing(jx):
    d, u, v, p = _kkt(m=400, p=120)
    s = FusedKKTSolver(d, u, v, p, device=CPU)
    iv = s.estimate_interval()
    assert s.estimate_interval() is iv  # cached: eigsh runs once
    op = make_kkt_operator(d, u, v, p, dtype=torch.float32, device=CPU)
    hi = float(eigsh(op, nev=1, which="LA", ncv=30, key=5).eigenvalues[-1])
    lo = float(eigsh(op, nev=1, which="SA", ncv=30, key=6).eigenvalues[0])
    assert iv[0] <= lo and hi <= iv[1], (iv, lo, hi)
    # the JAX fused solver's estimate, from another random start
    jiv = jx.Fused(d, u, v, p, interpret=True).estimate_interval()
    np.testing.assert_allclose(iv, jiv, rtol=0.05)
    x_in = np.random.default_rng(2).standard_normal(s.n).astype(np.float32)
    y = s.chebyshev_fAb(x_in, "exp", degree=30)  # interval-free
    np.testing.assert_array_equal(
        y, s.chebyshev_fAb(x_in, "exp", degree=30, interval=iv))


# --- on the card ------------------------------------------------------------

def _card_probes(s, m_probes, seed):
    return torch.from_numpy(_signs(m_probes, s.n, seed)).to(s.device)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("compensated", [False, True], ids=["K2", "K6"])
def test_slq_pass_one_card_is_one_launch_a_probe(cuda_device, compensated):
    d, u, v, p = _kkt()
    s = FusedKKTSolver(d, u, v, p, device=cuda_device,
                       compensated=compensated)
    probes, k = _card_probes(s, 4, 5), 30
    reset_launches()
    dec = s._slq_pass_one(probes, k)
    torch.cuda.synchronize()
    name = "lanczos_pass_one_comp" if compensated else "lanczos_pass_one"
    assert {n: c for n, c in LAUNCHES.items() if c} == {
        name: 4, "kkt_matvec_in_pass": 4 * k}
    for i in range(4):
        solo = pass_one_cuda(s.layout, probes[i].contiguous(), k, s.tol,
                             s.ztol, compensated=compensated)
        assert torch.equal(dec.alphas[i], solo.alphas)
        assert torch.equal(dec.betas[i], solo.betas)
        assert torch.equal(dec.b_norm[i], solo.b_norm)
        assert torch.equal(dec.steps_taken[i], solo.steps_taken)
    # the card's samples are the CPU solver's at f32 rounding (k = 20)
    res = s.slq_trace("exp", k=20, num_probes=4, key=2)
    ref = FusedKKTSolver(d, u, v, p, device=CPU,
                         compensated=compensated).slq_trace(
        "exp", k=20, num_probes=4, key=2)
    assert res.samples.is_cuda
    np.testing.assert_allclose(res.samples.cpu().numpy(), ref.samples.numpy(),
                               rtol=2e-3)


@pytest.mark.requires_cuda
def test_slq_breakdown_and_zero_probe_on_card(cuda_device):
    d, u, v, p, b = breakdown_kkt()
    s = FusedKKTSolver(d, u, v, p, device=cuda_device)
    probes = np.stack([b, np.zeros_like(b)])
    dec = s._slq_pass_one(probes, 8)
    assert int(dec.steps_taken[0]) < 8 and int(dec.steps_taken[1]) == 0
    quad = slq.batched_quadratic_form(dec, "inv").cpu().numpy()
    ref = slq.batched_quadratic_form(FusedKKTSolver(
        d, u, v, p, device=CPU)._slq_pass_one(probes, 8), "inv").numpy()
    assert quad[1] == 0.0 and np.isfinite(quad[0])
    np.testing.assert_allclose(quad, ref, rtol=1e-5)


@pytest.mark.requires_cuda
def test_chebyshev_card_launches_and_generic_agreement(cuda_device):
    d, u, v, p = _kkt(m=500, p=150)
    s = FusedKKTSolver(d, u, v, p, device=cuda_device)
    x_in = torch.from_numpy(np.random.default_rng(1).standard_normal(s.n)
                            .astype(np.float32)).to(cuda_device)
    iv, degree = (-4.0, 6.0), 40
    reset_launches()
    y = s.chebyshev_fAb(x_in, "exp", degree=degree, interval=iv, raw=True)
    torch.cuda.synchronize()
    assert {n: c for n, c in LAUNCHES.items() if c} == {"kkt_matvec": degree}
    assert y.is_cuda
    op = make_kkt_operator(d, u, v, p, dtype=torch.float32,
                           device=cuda_device)
    reset_launches()
    y_gen = chebyshev_fAb(op, x_in, "exp", degree=degree, interval=iv)
    torch.cuda.synchronize()
    assert {n: c for n, c in LAUNCHES.items() if c} == {
        "kkt_operator_matvec": degree}
    ym = float(y.abs().max())
    assert float((y_gen - y).abs().max()) <= 2e-4 * ym
    # the CPU solver's expansion of the same b
    y_cpu = FusedKKTSolver(d, u, v, p, device=CPU).chebyshev_fAb(
        x_in.cpu(), "exp", degree=degree, interval=iv)
    assert float(np.abs(y.cpu().numpy() - y_cpu).max()) <= 2e-4 * ym


@pytest.mark.requires_cuda
def test_estimate_interval_card_runs_k8_and_caches(cuda_device):
    d, u, v, p = _kkt(m=400, p=120)
    s = FusedKKTSolver(d, u, v, p, device=cuda_device)
    reset_launches()
    iv = s.estimate_interval()
    torch.cuda.synchronize()
    launched = {n: c for n, c in LAUNCHES.items() if c}
    assert set(launched) == {"kkt_operator_matvec"}, launched
    assert s.estimate_interval() is iv
    assert LAUNCHES["kkt_operator_matvec"] == launched["kkt_operator_matvec"]
    cpu_iv = FusedKKTSolver(d, u, v, p, device=CPU).estimate_interval()
    np.testing.assert_allclose(iv, cpu_iv, rtol=1e-2)


@pytest.mark.requires_cuda
def test_eigsh_on_card_takes_no_tf32(cuda_device):
    # CGS2, the restart and the Ritz vectors are GEMVs: the caller's TF32
    # switch changes no bit of the result
    d, u, v, p = _kkt(m=400, p=120)
    op = make_kkt_operator(d, u, v, p, dtype=torch.float32,
                           device=cuda_device)
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        runs = []
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            runs.append(eigsh(op, nev=2, which="LA", ncv=20, maxiter=5,
                              key=0))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    np.testing.assert_array_equal(runs[0].eigenvalues, runs[1].eigenvalues)
    np.testing.assert_array_equal(runs[0].eigenvectors, runs[1].eigenvectors)
