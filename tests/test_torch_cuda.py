"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the ``requires_cuda`` marker and skips without a
GPU. The file imports neither jax nor the JAX package, so it runs where
only PyTorch for CUDA is set up::

    python -m pytest --noconftest tests/test_torch_cuda.py -m requires_cuda

(``--noconftest``: ``tests/conftest.py`` configures jax.) Sizes are small;
``chip_smoke.py`` checks the same kernels at the headline size.
"""

import numpy as np
import pytest
import torch

# the sibling module by its own name: pytest puts tests/ on sys.path, and a
# package named `tests` elsewhere on the path may shadow ours
from torch_cases import (  # noqa: F401
    CASES,
    CPU,
    breakdown_kkt,
    cuda_device,
    random_kkt,
)
from two_pass_lanczos_tpu_torch import (
    CudaKKTOperator,
    DFFusedKKTSolver,
    DFKKTOperator,
    DiagonalOperator,
    FusedKKTSolver,
    KKTOperator,
    SparseOperator,
    lanczos_pass_one_df,
    lanczos_pass_two_with_basis,
    lanczos_standard,
    lanczos_two_pass,
    load_decomposition,
    make_inv_solver,
    make_kkt_operator,
    solve_fAb,
)
from two_pass_lanczos_tpu_torch.algorithms.core import (
    dot_f64,
    pass_one_last_vector,
    pass_one_scan,
    pass_two_scan,
)
from two_pass_lanczos_tpu_torch.convert import decomposition_from_jax
from two_pass_lanczos_tpu_torch.models.kkt import kkt_sorted_coo
from two_pass_lanczos_tpu_torch.functions import padded_f_e1
from two_pass_lanczos_tpu_torch.ops.df import df_from_f64
from two_pass_lanczos_tpu_torch.ops.eft import eft_check_plain
from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
    LAUNCHES,
    eft_check_cuda,
    kkt_matvec_cuda,
    reset_launches,
)
from two_pass_lanczos_tpu_torch.ops.kkt_fused_df import (
    df_kkt_matvec_cuda,
    df_pass_one_last_vector,
)
from two_pass_lanczos_tpu_torch.ops.spmv import kkt_matvec
from two_pass_lanczos_tpu_torch.testing import check_reconstruction_stability
from two_pass_lanczos_tpu_torch.utils.data_loader import KKTArrays

pytestmark = pytest.mark.requires_cuda


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(42)
    d, u, v, p = random_kkt(rng)
    b = rng.standard_normal(len(d) + p).astype(np.float32)
    return d, u, v, p, b


def _rel(x, ref):
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _plain_mv(lay):
    return lambda x: kkt_matvec(lay.d, lay.u, lay.v, lay.p, x)


def _y_full(dec, nf, seed):
    y = np.random.default_rng(seed).standard_normal((nf, dec.k_max))
    y[:, dec.steps():] = 0.0
    return y.astype(np.float32)


# --- K1, K2, K3 ------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_card(case, cuda_device):
    rng = np.random.default_rng(5)
    d, u, v, p = CASES[case](rng)
    x = rng.standard_normal(len(d) + p).astype(np.float32)
    s = FusedKKTSolver(d, u, v, p, device=cuda_device)
    xd = torch.from_numpy(x).to(cuda_device)
    before = LAUNCHES["kkt_matvec"]
    y = kkt_matvec_cuda(s.layout, xd)
    torch.cuda.synchronize()
    assert LAUNCHES["kkt_matvec"] == before + 1
    t = torch.from_numpy
    y_ref = kkt_matvec(t(d), t(u), t(v), p, t(x)).numpy()
    m = len(d)
    # the arc part uses the plain version's rounding exactly
    np.testing.assert_array_equal(y[:m].cpu().numpy(), y_ref[:m])
    np.testing.assert_allclose(y.cpu().numpy(), y_ref, rtol=0,
                               atol=2e-5 * np.abs(y_ref).max())
    # fixed-order node sums: bitwise reproducible run to run
    np.testing.assert_array_equal(kkt_matvec_cuda(s.layout, xd).cpu().numpy(),
                                  y.cpu().numpy())


def test_kernels_match_plain_on_card(problem, cuda_device):
    d, u, v, p, b = problem
    k = 20
    s = FusedKKTSolver(d, u, v, p, device=cuda_device)
    bt = torch.from_numpy(b).to(cuda_device)
    before = dict(LAUNCHES)
    st1 = torch.empty(2, s.n, device=cuda_device)
    dec = s.pass_one(bt, k, state=st1)
    ref, _ = pass_one_scan(_plain_mv(s.layout), bt, k)
    assert dec.steps() == ref.steps() == k
    np.testing.assert_allclose(dec.alphas.cpu().numpy(),
                               ref.alphas.cpu().numpy(), rtol=1e-4)
    np.testing.assert_allclose(dec.betas.cpu().numpy(),
                               ref.betas.cpu().numpy(), rtol=1e-4)
    y = torch.from_numpy(_y_full(dec, 2, seed=9)).to(cuda_device)
    st2 = torch.empty(2, s.n, device=cuda_device)
    x = s.pass_two(bt, dec, y, state=st2)
    x_ref, _ = pass_two_scan(_plain_mv(s.layout), bt, dec, y)
    rel = (torch.linalg.norm(x - x_ref) / torch.linalg.norm(x_ref)).item()
    assert rel < 1e-5, rel
    assert torch.equal(pass_one_last_vector(dec, st1), st2[1])
    assert LAUNCHES["lanczos_pass_one"] == before["lanczos_pass_one"] + 1
    assert LAUNCHES["lanczos_pass_two"] == before["lanczos_pass_two"] + 1
    assert LAUNCHES["kkt_matvec"] == before["kkt_matvec"] + 2 * k - 1


def test_solve_on_card_matches_cpu(problem, cuda_device):
    d, u, v, p, b = problem
    k = 25
    x_cpu, _ = FusedKKTSolver(d, u, v, p, device=CPU).solve(b, k=k, f="inv")
    s = FusedKKTSolver(d, u, v, p, device=cuda_device)
    reset_launches()
    x, dec = s.solve(torch.from_numpy(b).to(cuda_device), k=k, raw=True)
    torch.cuda.synchronize()
    assert all(LAUNCHES[name] > 0 for name in
               ("kkt_matvec", "lanczos_pass_one", "lanczos_pass_two"))
    assert dec.steps() == k
    assert _rel(x.cpu().numpy(), x_cpu) < 1e-4


# --- K4: pass one with the basis -------------------------------------------

def test_basis_kernel_matches_plain_on_card(problem, cuda_device):
    d, u, v, p, b = problem
    k = 20
    s = FusedKKTSolver(d, u, v, p, device=cuda_device)
    bt = torch.from_numpy(b).to(cuda_device)
    reset_launches()
    dec, basis = s.pass_one_with_basis(bt, k)
    assert LAUNCHES["lanczos_pass_one_basis"] == 1
    assert LAUNCHES["kkt_matvec"] == k
    dec2 = s.pass_one(bt, k)
    assert torch.equal(dec.alphas, dec2.alphas)
    assert torch.equal(dec.betas, dec2.betas)
    _, basis_ref = pass_one_scan(_plain_mv(s.layout), bt, k, emit_basis=True)
    rel = (torch.linalg.norm(basis - basis_ref)
           / torch.linalg.norm(basis_ref)).item()
    assert rel < 1e-5, rel
    x1, _ = s.solve(bt, k=k, method="one_pass")
    x_cpu, _ = FusedKKTSolver(d, u, v, p, device=CPU).solve(
        b, k=k, method="one_pass")
    assert _rel(x1, x_cpu) < 1e-4


@pytest.mark.parametrize("nf", [1, 3])
def test_one_pass_product_ignores_tf32_on_card(problem, cuda_device, nf):
    d, u, v, p, b = problem
    s = FusedKKTSolver(d, u, v, p, device=cuda_device)
    f = ("inv", "exp", "inv")[:nf] if nf > 1 else "inv"
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        x_f32, dec = s.solve(b, k=20, f=f, method="one_pass", raw=True)
        torch.backends.cuda.matmul.allow_tf32 = True
        x_tf32, _ = s.solve(b, k=20, f=f, method="one_pass", raw=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert torch.equal(x_tf32, x_f32)
    _, basis = s.pass_one_with_basis(b, 20)
    y = np.stack([padded_f_e1(dec, fi).cpu().numpy() * float(dec.b_norm)
                  for fi in (f if nf > 1 else (f,))])
    x64 = y.astype(np.float64) @ basis.cpu().numpy().astype(np.float64)
    got = x_f32.cpu().numpy().reshape(nf, -1)
    assert _rel(got, x64) < 1e-5  # TF32 would be ~1e-3


def test_basis_kernel_rows_past_breakdown_zero_on_card(cuda_device):
    d, u, v, p, b = breakdown_kkt()
    s = FusedKKTSolver(d, u, v, p, device=cuda_device)
    dec, basis = s.pass_one_with_basis(b, 12)
    steps = dec.steps()
    assert 0 < steps < 12
    assert bool((basis[steps:] == 0).all())
    dec_cpu, basis_cpu = FusedKKTSolver(
        d, u, v, p, device=CPU).pass_one_with_basis(b, 12)
    assert dec_cpu.steps() == steps
    np.testing.assert_allclose(basis.cpu().numpy(), basis_cpu.numpy(),
                               rtol=0, atol=1e-6)
    x0, dec0 = s.solve(np.zeros_like(b), k=8, method="one_pass")
    assert dec0.steps() == 0
    np.testing.assert_array_equal(x0, 0.0)


# --- K5: the resumable pass one --------------------------------------------

@pytest.mark.parametrize("compensated", [False, True], ids=["plain", "comp"])
def test_chunk_kernel_matches_plain_on_card(problem, cuda_device,
                                            compensated):
    d, u, v, p, b = problem
    s = FusedKKTSolver(d, u, v, p, device=cuda_device,
                       compensated=compensated)
    bt = torch.from_numpy(b).to(cuda_device)
    k = 23  # not a multiple of the chunk
    reset_launches()
    got = s.pass_one_chunked(bt, k, chunk=8)
    name = "lanczos_pass_one_comp" if compensated else "lanczos_pass_one_chunk"
    assert LAUNCHES[name] == 3 and LAUNCHES["kkt_matvec"] == k
    ref = s.pass_one(bt, k)
    assert torch.equal(got.alphas, ref.alphas)
    assert torch.equal(got.betas, ref.betas)
    plain = FusedKKTSolver(d, u, v, p, compensated=compensated, device=CPU)
    want = plain.pass_one_chunked(b, k, chunk=8)
    np.testing.assert_allclose(got.alphas.cpu().numpy(), want.alphas.numpy(),
                               rtol=1e-4)


def test_chunk_kernel_stop_bounds_matvecs_on_card(problem, cuda_device):
    d, u, v, p, b = problem
    s = FusedKKTSolver(d, u, v, p, device=cuda_device)
    reset_launches()
    dec = s.pass_one_chunked(b, 40, callback=lambda st, V, sc: st < 11,
                             chunk=8)
    assert dec.steps() == 11 and LAUNCHES["kkt_matvec"] <= 16
    assert bool((dec.alphas[11:] == 0).all())
    assert bool((dec.betas[10:] == 0).all())
    zero = s.pass_one_chunked(np.zeros(s.n, np.float32), 8, chunk=4)
    assert zero.steps() == 0
    e1 = np.eye(4, dtype=np.float32)[0]
    tiny = FusedKKTSolver(np.array([2.0, 3.0]), [0, 1], [1, 0], 2,
                          device=cuda_device)
    ref = tiny.pass_one(e1, 6)
    got = tiny.pass_one_chunked(e1, 6, chunk=4)
    assert got.steps() == ref.steps() < 6
    assert torch.equal(got.alphas, ref.alphas)


# --- K6: the compensated builds --------------------------------------------

def test_compensated_kernel_matches_plain_on_card(cuda_device):
    # long reductions (n = 202,000), so that plain K2's f32 dots sit
    # measurably off the f64-dot version
    rng = np.random.default_rng(42)
    d, u, v, p = random_kkt(rng, m=200_000, p=2_000)
    b = rng.standard_normal(len(d) + p).astype(np.float32)
    s = FusedKKTSolver(d, u, v, p, device=cuda_device, compensated=True)
    bt = torch.from_numpy(b).to(cuda_device)
    k = 20
    reset_launches()
    dec = s.pass_one(bt, k)
    assert LAUNCHES["lanczos_pass_one_comp"] == 1
    assert LAUNCHES["lanczos_pass_one"] == 0
    # the reference runs K1's matvec, so that only the reductions differ
    ref, _ = pass_one_scan(lambda x: kkt_matvec_cuda(s.layout, x), bt, k,
                           dot=dot_f64)
    np.testing.assert_allclose(dec.alphas.cpu().numpy(),
                               ref.alphas.cpu().numpy(), rtol=1e-5)
    np.testing.assert_allclose(dec.betas.cpu().numpy(),
                               ref.betas.cpu().numpy(), rtol=1e-5)
    # an uncompensated build also meets rtol 1e-5: hold the kernel well
    # inside plain K2's own distance from the f64-dot version
    plain = FusedKKTSolver(d, u, v, p, device=cuda_device).pass_one(bt, k)

    def dist(x):
        return max(float((x.alphas - ref.alphas).abs().max()),
                   float((x.betas - ref.betas).abs().max()))

    assert 0 < dist(plain) and dist(dec) <= 0.25 * dist(plain), (
        dist(dec), dist(plain))
    dec1, _ = s.pass_one_with_basis(bt, k)
    assert torch.equal(dec1.alphas, dec.alphas)


def test_compensated_alphas_closer_to_f64_on_card(cuda_device):
    # the instance of tests/test_fused.py::test_compensated_alphas_closer_to_f64
    rng = np.random.default_rng(42)
    d, u, v, p = random_kkt(rng, m=1200, p=300)
    b = rng.standard_normal(len(d) + p).astype(np.float32)
    k = 6
    t = torch.from_numpy
    o64, _ = pass_one_scan(
        lambda x: kkt_matvec(t(d.astype(np.float64)), t(u), t(v), p, x),
        t(b.astype(np.float64)), k)
    a64 = o64.alphas.numpy()
    errs = []
    for comp in (False, True):
        s = FusedKKTSolver(d, u, v, p, device=cuda_device, compensated=comp)
        a = s.pass_one(b, k).alphas.cpu().numpy().astype(np.float64)
        errs.append(np.abs(a - a64).max())
    assert errs[1] < errs[0], errs


# --- K13: the error-free transformations -----------------------------------

def test_eft_kernel_exact_on_card(cuda_device):
    a = torch.full((300,), 1.0 + 2.0 ** -12, device=cuda_device)
    b = torch.full((300,), 2.0 ** -30, device=cuda_device)
    reset_launches()
    got = eft_check_cuda(a, b).cpu()
    assert LAUNCHES["eft_check"] == 1
    exact = torch.tensor([1.0 + 2.0 ** -12, 2.0 ** -30, 1.0 + 2.0 ** -11,
                          2.0 ** -24, 1.0 + 2.0 ** -12, 2.0 ** -30])
    assert torch.equal(got, exact[:, None].expand(6, 300))
    # random inputs: bitwise the plain twin
    rng = np.random.default_rng(0)
    ra = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    rb = torch.from_numpy(rng.standard_normal(1000).astype(np.float32) * 1e-5)
    assert torch.equal(eft_check_cuda(ra.to(cuda_device), rb.to(cuda_device))
                       .cpu(), eft_check_plain(ra, rb))


# --- K8: the generic operators' matvec -------------------------------------

def _node_bound(lay, x, eps):
    """2·deg·eps·Σ|x_a| per node: two summation orders of one node sum."""
    m = lay.m
    absum = torch.zeros(lay.p, dtype=x.dtype, device=x.device)
    absum.index_add_(0, lay.u, x[:m].abs()).index_add_(0, lay.v, x[:m].abs())
    deg = (lay.ptr[1:] - lay.ptr[:-1]).to(x.dtype)
    return 2 * deg * eps * absum


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_operator_kernel_matches_plain_on_card(case, dtype, cuda_device):
    rng = np.random.default_rng(5)
    d, u, v, p = CASES[case](rng)
    x = torch.from_numpy(rng.standard_normal(len(d) + p)).to(dtype)
    op = make_kkt_operator(d, u, v, p, dtype=dtype, device=cuda_device)
    assert isinstance(op, CudaKKTOperator) and op.dtype == dtype
    xd = x.to(cuda_device)
    before = LAUNCHES["kkt_operator_matvec"]
    y = op.matvec(xd)
    torch.cuda.synchronize()
    assert LAUNCHES["kkt_operator_matvec"] == before + 1
    lay = op.layout
    y_ref = kkt_matvec(lay.d.cpu(), lay.u.cpu(), lay.v.cpu(), p, x)
    m = len(d)
    # the arc part rounds as the plain version; the node part sums in
    # another fixed order
    assert torch.equal(y[:m].cpu(), y_ref[:m])
    bound = _node_bound(lay, xd, torch.finfo(dtype).eps).cpu()
    assert bool(((y[m:].cpu() - y_ref[m:]).abs() <= bound).all())
    assert torch.equal(op.matvec(xd), y)  # bitwise reproducible
    # KKTOperator on the card runs the same kernel, never index_add_
    plain_class = KKTOperator(d, u, v, p, dtype=dtype, device=cuda_device)
    assert torch.equal(plain_class.matvec(xd), y)
    assert LAUNCHES["kkt_operator_matvec"] == before + 3
    with pytest.raises(ValueError, match="plain"):
        make_kkt_operator(d, u, v, p, backend="plain", device=cuda_device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_generic_two_pass_basis_bitwise_on_card(problem, cuda_device, dtype):
    d, u, v, p, b = problem
    k = 25
    op = make_kkt_operator(d, u, v, p, dtype=dtype, device=cuda_device)
    bt = torch.from_numpy(b).to(cuda_device, dtype)
    reset_launches()
    dec, basis = lanczos_standard(op, bt, k)
    y = torch.ones(k, dtype=dtype, device=cuda_device)
    _, regen = lanczos_pass_two_with_basis(op, bt, dec, y)
    assert dec.steps() == k
    assert torch.equal(regen, basis)  # basis_drift_fro == 0 on the card
    assert LAUNCHES["kkt_operator_matvec"] == 2 * k - 1
    assert LAUNCHES["kkt_matvec"] == 0
    reset_launches()
    x = solve_fAb(op, bt, k=k, f="inv")
    assert LAUNCHES["kkt_operator_matvec"] == 2 * k - 1
    x_host = lanczos_two_pass(op, bt, k, make_inv_solver())
    cpu = make_kkt_operator(d, u, v, p, dtype=dtype, device="cpu")
    x_cpu = solve_fAb(cpu, bt.cpu(), k=k, f="inv")
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    assert _rel(x.cpu().numpy(), x_cpu.numpy()) < tol
    assert _rel(x_host.cpu().numpy(), x_cpu.numpy()) < tol


def test_sparse_operator_replay_bitwise_on_card(problem, cuda_device):
    d, u, v, p, b = problem
    arrays = KKTArrays(quad_costs=d.astype(np.float64), arc_u=u, arc_v=v,
                       num_nodes=p, num_arcs=len(d))
    op = SparseOperator(kkt_sorted_coo(arrays, device=cuda_device),
                        device=cuda_device)
    bt = torch.from_numpy(b.astype(np.float64)).to(cuda_device)
    report = check_reconstruction_stability(op, bt, 30)
    assert report.value == 0.0
    kkt = make_kkt_operator(d.astype(np.float64), u, v, p,
                            dtype=torch.float64, device=cuda_device)
    y = op.matvec(bt)
    assert torch.equal(op.matvec(bt), y)
    assert _rel(y.cpu().numpy(), kkt.matvec(bt).cpu().numpy()) < 1e-14
    x = lanczos_two_pass(DiagonalOperator(np.arange(1.0, 101.0),
                                          device=cuda_device),
                         np.ones(100), 30, make_inv_solver())
    assert _rel(x.cpu().numpy(), 1.0 / np.arange(1.0, 101.0)) < 1e-3


# --- K11, K9, K10: the double-float tier -----------------------------------

def _df_node_bound(lay, x2):
    """Two compensated folds of one node sum differ by at most
    8·(deg+1)·2⁻⁴⁸·Σ|x_a| (f64): each df_add2 of partial sums a, b errs by
    ≤ 3·2⁻⁴⁸·(|a| + |b|), a fold of deg terms adds ≤ deg such errors over
    partial sums bounded by Σ|x_a|, and the plain version's final df_sub
    adds one more."""
    m = lay.m
    xa = (x2[0, :m].double() + x2[1, :m].double()).abs()
    absum = torch.zeros(lay.p, dtype=torch.float64, device=x2.device)
    absum.index_add_(0, lay.u, xa).index_add_(0, lay.v, xa)
    deg = (lay.ptr[1:] - lay.ptr[:-1]).double()
    return 8 * (deg + 1) * 2.0 ** -48 * absum


def _df_problem(rng, m=700, p=300):
    u = rng.integers(0, p, m).astype(np.int32)
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    return rng.uniform(0.5, 5.0, m), u, v, p


@pytest.mark.parametrize("case", sorted(CASES))
def test_df_matvec_kernel_matches_plain_on_card(case, cuda_device,
                                                monkeypatch):
    rng = np.random.default_rng(5)
    d, u, v, p = CASES[case](rng)
    d64 = d.astype(np.float64) * (1.0 + rng.uniform(0, 1e-7, len(d)))
    x64 = rng.standard_normal(len(d) + p)
    op = DFKKTOperator.from_f64(d64, u, v, p, device=cuda_device)
    xdf = df_from_f64(x64, cuda_device)
    x2 = torch.stack([xdf.hi, xdf.lo])
    reset_launches()
    y2 = df_kkt_matvec_cuda(op.layout, op.d2, x2)
    torch.cuda.synchronize()
    assert LAUNCHES["df_kkt_matvec"] == 1
    ref = op.plain_matvec_df(xdf)
    m = len(d)
    # the arc part rounds as the plain version, in both planes
    assert torch.equal(y2[0, :m], ref.hi[:m])
    assert torch.equal(y2[1, :m], ref.lo[:m])
    # the node part folds in another fixed order
    got = y2[0, m:].double() + y2[1, m:].double()
    want = ref.hi[m:].double() + ref.lo[m:].double()
    assert bool(((got - want).abs() <= _df_node_bound(op.layout, x2)).all())
    assert torch.equal(df_kkt_matvec_cuda(op.layout, op.d2, x2), y2)
    # DFKKTOperator.matvec_df on the card is K11, never the plain fold
    monkeypatch.setattr(DFKKTOperator, "plain_matvec_df",
                        lambda *a: pytest.fail("plain df matvec on the card"))
    y = op.matvec_df(xdf)
    assert LAUNCHES["df_kkt_matvec"] == 3
    assert torch.equal(y.hi, y2[0]) and torch.equal(y.lo, y2[1])
    # and near the f64 truth
    t = torch.from_numpy
    truth = kkt_matvec(t(d64), t(u), t(v), p, t(x64)).numpy()
    y64 = (y2[0].double() + y2[1].double()).cpu().numpy()
    assert np.abs(y64 - truth).max() <= 1e-13 * np.abs(truth).max()


def test_df_pass_kernels_match_plain_on_card(cuda_device):
    rng = np.random.default_rng(11)
    d, u, v, p = _df_problem(rng)
    b = rng.standard_normal(len(d) + p)
    k = 20
    s = DFFusedKKTSolver(d, u, v, p, device=cuda_device)
    b2 = s.pack(torch.from_numpy(b).to(cuda_device))
    reset_launches()
    st1 = torch.empty(2, 2, s.n, device=cuda_device)
    coeffs = s.pass_one(b2, k, state=st1)
    torch.cuda.synchronize()
    assert LAUNCHES["df_lanczos_pass_one"] == 1
    assert LAUNCHES["df_kkt_matvec"] == k
    ah, al, bh, bl, bn2, steps = coeffs
    assert int(steps[0]) == k
    ref = lanczos_pass_one_df(DFKKTOperator.from_f64(d, u, v, p, device=CPU),
                              b, k)
    a64 = (ah.double() + al.double()).cpu().numpy()
    b64 = (bh.double() + bl.double()).cpu().numpy()
    atol = 1e-11 * max(1.0, np.abs(ref.alphas_f64()).max())
    np.testing.assert_allclose(a64, ref.alphas_f64(), rtol=0, atol=atol)
    np.testing.assert_allclose(b64[:k - 1], ref.betas_f64(), rtol=0,
                               atol=atol)
    bn = float(bn2[0].double() + bn2[1].double())
    assert abs(bn - np.linalg.norm(b)) < 1e-12 * np.linalg.norm(b)
    # K10 regenerates K9's basis: v_k bitwise in both planes
    y = torch.zeros(2, k, device=cuda_device)
    st2 = torch.empty(2, 2, s.n, device=cuda_device)
    s.pass_two(b2, coeffs, y[0], y[1], state=st2)
    torch.cuda.synchronize()
    assert LAUNCHES["df_lanczos_pass_two"] == 1
    assert LAUNCHES["df_kkt_matvec"] == 2 * k - 1
    assert torch.equal(df_pass_one_last_vector(coeffs, st1), st2[1])
    # the whole solve against the plain one on the CPU
    x, (al64, be64, st) = s.solve(b, k=k, f="inv")
    x_cpu, _ = DFFusedKKTSolver(d, u, v, p, device=CPU).solve(b, k=k)
    assert x.dtype == torch.float64 and x.is_cuda and st == k
    assert _rel(x.cpu().numpy(), x_cpu.numpy()) < 1e-10


def test_df_breakdown_and_zero_b_on_card(cuda_device):
    d, u, v, p, b = breakdown_kkt()
    s = DFFusedKKTSolver(d.astype(np.float64), u, v, p, device=cuda_device)
    coeffs = s.pass_one(b.astype(np.float64), 12)
    steps = int(coeffs[5][0])
    ref = DFFusedKKTSolver(d.astype(np.float64), u, v, p,
                           device=CPU).pass_one(b.astype(np.float64), 12)
    assert 0 < steps < 12 and steps == int(ref[5][0])
    # the step that breaks down writes alpha but not beta
    assert float(coeffs[0][steps - 1]) != 0.0
    assert float(coeffs[2][steps - 1]) == 0.0
    assert bool((coeffs[0][steps:] == 0).all())
    x, (_, _, st) = s.solve(b.astype(np.float64), k=12)
    assert st == steps and bool(torch.isfinite(x).all())
    # a zero b: 0 steps and x = 0; a subnormal b: the same, never NaN
    n = s.n
    x0, (_, _, s0) = s.solve(np.zeros(n), k=5)
    assert s0 == 0 and bool((x0 == 0).all())
    b_sub = s.pack(np.full(n, 1e-42))
    c_sub = s.pass_one(b_sub, 4)
    assert int(c_sub[5][0]) == 0
    zero = torch.zeros(4, device=cuda_device)
    x_sub = s.pass_two(b_sub, c_sub, zero, zero)
    assert bool(torch.isfinite(x_sub).all()) and bool((x_sub == 0).all())


# --- the default device ----------------------------------------------------

@pytest.mark.parametrize("entry", [
    "FusedKKTSolver", "make_kkt_operator", "DiagonalOperator",
    "load_decomposition", "decomposition_from_jax", "DFFusedKKTSolver",
    "DFKKTOperator"])
def test_entry_points_default_to_the_card(entry, monkeypatch, tmp_path):
    # with no card, the default device="cuda" raises; it never falls back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = np.ones(3, np.float32)
    calls = {
        "FusedKKTSolver": lambda: FusedKKTSolver(d, [0, 1, 2], [1, 2, 0], 3),
        "make_kkt_operator": lambda: make_kkt_operator(d, [0, 1, 2],
                                                       [1, 2, 0], 3),
        "DiagonalOperator": lambda: DiagonalOperator(d),
        "load_decomposition": lambda: load_decomposition(tmp_path / "x.npz"),
        "decomposition_from_jax": lambda: decomposition_from_jax(None),
        "DFFusedKKTSolver": lambda: DFFusedKKTSolver(d, [0, 1, 2],
                                                     [1, 2, 0], 3),
        "DFKKTOperator": lambda: DFKKTOperator.from_f64(d, [0, 1, 2],
                                                        [1, 2, 0], 3),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()
