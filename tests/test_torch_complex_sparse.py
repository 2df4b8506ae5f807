"""Complex Hermitian operators in the port's sparse tiers against the JAX
package's, on the same complex triplets.

The generic ``SparseOperator`` runs here on CPU tensors beside the JAX
``SparseOperator``: α and β within 1e-12·max|α| and x within rel 1e-10 for
the two-pass and one-pass solves of inv and exp in complex128, and within
the f32-class 2e-4·max|α| and rel 2e-4 in complex64 (the JAX run stays in
complex128 there). The row-sharded ``ShardedSparseOperator`` runs in gloo
processes, one per rank, spawned by ``tests/torch_ranks.py`` for D ∈ {1,
2, 4}; each spawn runs every method on the complex triplets, and the JAX
operator runs here on a virtual CPU mesh of D devices, with ``v0`` and the
probes the port drew passed to both (JAX's keys are not reproduced). The
tolerances are those of ``tests/test_sharded.py`` (solves at rel 1e-9, α,
β at rtol 1e-10), ``tests/test_chebyshev.py``, ``tests/test_slq.py``,
``tests/test_block.py`` and ``tests/test_eigen_sharded.py``, whose two
complex tests (``test_sharded_eigsh_complex_hermitian``,
``test_complex_hermitian_sharded_block``) are ported at their own
thresholds.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import two_pass_lanczos_tpu as jtpl
from two_pass_lanczos_tpu.ops.spmv import csr_from_triplets as j_csr
from two_pass_lanczos_tpu.parallel import ShardedSparseOperator as JaxSparse
from two_pass_lanczos_tpu.parallel import make_mesh as jax_mesh
from two_pass_lanczos_tpu.slq import batched_quadratic_form as j_quad

from torch_cases import CPU
from torch_ranks import spawn
import two_pass_lanczos_tpu_torch as tpl
from two_pass_lanczos_tpu_torch.convert import operator_from_jax
from two_pass_lanczos_tpu_torch.models import hofstadter_triplets
from two_pass_lanczos_tpu_torch.ops.spmv import coo_spmv, csr_from_triplets
from two_pass_lanczos_tpu_torch.testing import check_reconstruction_stability
from two_pass_lanczos_tpu_torch.utils.collectives import CollectiveOp


def _hermitian_triplets(n, seed, per_row=4, lo=1.0, hi=6.0):
    """A random sparse complex Hermitian matrix with its spectrum in about
    [lo, hi]: ``per_row`` random off-diagonal entries a row and their
    mirrors, scaled, plus a diagonal; duplicates summed by the builders."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), per_row)
    c = rng.integers(0, n, r.size)
    off = r != c
    r, c = r[off], c[off]
    z = rng.standard_normal(r.size) + 1j * rng.standard_normal(r.size)
    rows = np.concatenate([r, c])
    cols = np.concatenate([c, r])
    vals = np.concatenate([z, z.conj()])
    dense = np.zeros((n, n), complex)
    np.add.at(dense, (rows, cols), vals)
    lam = np.linalg.eigvalsh(dense)
    scale = (hi - lo) / (lam[-1] - lam[0])
    shift = lo - scale * lam[0]
    idx = np.arange(n)
    rows = np.concatenate([rows, idx])
    cols = np.concatenate([cols, idx])
    vals = np.concatenate([scale * vals, np.full(n, shift, complex)])
    dense = np.zeros((n, n), complex)
    np.add.at(dense, (rows, cols), vals)
    return n, rows, cols, vals, dense


N, ROWS, COLS, VALS, DENSE = _hermitian_triplets(60, 3)
TRIPLETS = {"triplets": (N, ROWS, COLS, VALS)}
_rng = np.random.default_rng(4)
B = _rng.standard_normal(N) + 1j * _rng.standard_normal(N)
B_BLOCK = _rng.standard_normal((N, 2)) + 1j * _rng.standard_normal((N, 2))
V0 = _rng.standard_normal(N) + 1j * _rng.standard_normal(N)
K = 20


def _rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


def _f_dense(dense, f, b):
    lam, q = np.linalg.eigh(dense)
    g = np.exp(lam) if f == "exp" else 1.0 / lam
    return (q * g) @ (q.conj().T @ b)


# --- the generic SparseOperator ----------------------------------------------

def _port_op(dtype=np.complex128):
    return tpl.SparseOperator(csr_from_triplets(
        N, N, ROWS, COLS, VALS.astype(dtype), device=CPU), device=CPU)


def _jax_op():
    return jtpl.SparseOperator(j_csr(N, N, ROWS, COLS, VALS))


def test_complex_spmv_matches_dense():
    x = _rng_vec(5)
    for dtype, tol in ((np.complex128, 1e-13), (np.complex64, 1e-5)):
        op = _port_op(dtype)
        y = op.matvec(torch.from_numpy(x.astype(dtype))).numpy()
        assert y.dtype == dtype
        assert _rel(y, DENSE @ x) < tol


def _rng_vec(seed, n=N):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


def test_complex_spmv_sums_each_row_in_fixed_order():
    # the real view's segmented sum is the real and imaginary parts' own
    # fixed-order sums, bit for bit
    op = _port_op()
    x = torch.from_numpy(_rng_vec(6))
    y = coo_spmv(op.mat, x)
    prod = op.mat.vals * x[op.mat.cols]
    for got, part in ((y.real, prod.real), (y.imag, prod.imag)):
        ref = torch.segment_reduce(part.contiguous(), "sum",
                                   offsets=op.mat.indptr)
        assert torch.equal(got, ref)
    assert torch.equal(y, coo_spmv(op.mat, x))


def test_real_spmv_keeps_its_single_call():
    rows, cols = np.nonzero(np.abs(DENSE) > 0)
    mat = csr_from_triplets(N, N, rows, cols, DENSE.real[rows, cols],
                            device=CPU)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(N))
    ref = torch.segment_reduce(mat.vals * x[mat.cols], "sum",
                               offsets=mat.indptr)
    y = coo_spmv(mat, x)
    assert y.dtype == torch.float64 and torch.equal(y, ref)


@pytest.mark.parametrize("method", ["two_pass", "one_pass"])
@pytest.mark.parametrize("f", ["inv", "exp"])
def test_complex_sparse_operator_matches_jax(method, f):
    op, jop = _port_op(), _jax_op()
    bt = torch.from_numpy(B)
    dec = tpl.lanczos_pass_one(op, bt, K)
    jdec = jtpl.lanczos_pass_one(jop, jnp.asarray(B), K)
    scale = float(np.abs(np.asarray(jdec.alphas)).max())
    assert dec.steps() == int(jdec.steps_taken) == K
    np.testing.assert_allclose(dec.alphas.numpy(), np.asarray(jdec.alphas),
                               rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(dec.betas.numpy(), np.asarray(jdec.betas),
                               rtol=0, atol=1e-12 * scale)
    x = tpl.solve_fAb(op, bt, k=K, f=f, method=method).numpy()
    xj = np.asarray(jtpl.solve_fAb(jop, jnp.asarray(B), k=K, f=f,
                                   method=method))
    assert x.dtype == np.complex128
    assert _rel(x, xj) < 1e-10
    assert _rel(x, _f_dense(DENSE, f, B)) < 1e-6


@pytest.mark.parametrize("method", ["two_pass", "one_pass"])
def test_complex64_sparse_operator_matches_jax(method):
    op, jop = _port_op(np.complex64), _jax_op()
    b64 = B.astype(np.complex64)
    dec = tpl.lanczos_pass_one(op, torch.from_numpy(b64), K)
    jdec = jtpl.lanczos_pass_one(jop, jnp.asarray(b64.astype(np.complex128)),
                                 K)
    assert dec.alphas.dtype == torch.float32
    scale = float(np.abs(np.asarray(jdec.alphas)).max())
    np.testing.assert_allclose(dec.alphas.numpy(), np.asarray(jdec.alphas),
                               rtol=0, atol=2e-4 * scale)
    np.testing.assert_allclose(dec.betas.numpy(), np.asarray(jdec.betas),
                               rtol=0, atol=2e-4 * scale)
    x = tpl.solve_fAb(op, torch.from_numpy(b64), k=K, f="inv",
                      method=method).numpy()
    xj = np.asarray(jtpl.solve_fAb(jop, jnp.asarray(b64.astype(
        np.complex128)), k=K, f="inv", method=method))
    assert x.dtype == np.complex64
    assert _rel(x, xj) < 2e-4


def test_complex_sparse_operator_from_jax():
    op = operator_from_jax(_jax_op(), device=CPU)
    assert op.dtype == torch.complex128
    np.testing.assert_allclose(op.mat.todense().numpy(), DENSE, rtol=0,
                               atol=1e-15)


def test_complex_basis_replays_bitwise():
    # pass two regenerates pass one's complex basis bit for bit
    rep = check_reconstruction_stability(
        _port_op(), torch.from_numpy(B), k=K)
    assert rep.value == 0.0


def test_hofstadter_triplets_are_the_magnetic_laplacian():
    side, q, shift = 8, 4, 0.5
    n, rows, cols, vals = hofstadter_triplets(side, q, shift)
    assert n == side * side and rows.size == 5 * n
    h = np.zeros((n, n), complex)
    np.add.at(h, (rows, cols), vals)
    np.testing.assert_array_equal(h, h.conj().T)
    lam = np.linalg.eigvalsh(h) - shift
    assert lam[0] >= -1e-12 and lam[-1] <= 8.0 + 1e-12
    # the flux through a plaquette: the product of the hoppings around it
    at = lambda x, y: (x % side) * side + (y % side)  # noqa: E731
    x, y = 3, 5
    loop = (h[at(x, y), at(x + 1, y)] * h[at(x + 1, y), at(x + 1, y + 1)]
            * h[at(x + 1, y + 1), at(x, y + 1)] * h[at(x, y + 1), at(x, y)])
    assert np.angle(loop) == pytest.approx(2 * np.pi / q)
    with pytest.raises(ValueError, match="does not close"):
        hofstadter_triplets(10, 4)


# --- the row-sharded ShardedSparseOperator ------------------------------------

#: the ported JAX tests' instances (tests/test_eigen_sharded.py:95,
#: tests/test_block.py:319), dense complex Hermitian in COO
def _dense_hermitian(n, d, seed):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    q, _ = np.linalg.qr(m)
    a = (q * d) @ q.conj().T
    return (a + a.conj().T) / 2, q


EIG_D = np.concatenate([np.linspace(1.0, 6.0, 46), [9.0, 10.0]])
EIG_A, _ = _dense_hermitian(48, EIG_D, 55)
BLK_D = np.concatenate([[1.0, 1.0, 2.5], np.linspace(3.0, 9.0, 45)])
_blk = np.random.default_rng(31)
_m = _blk.standard_normal((48, 48)) + 1j * _blk.standard_normal((48, 48))
BLK_Q, _ = np.linalg.qr(_m)
BLK_A = (BLK_Q * BLK_D) @ BLK_Q.conj().T
BLK_B = (np.random.default_rng(32).standard_normal((48, 2))
         + 1j * np.random.default_rng(32).standard_normal((48, 2)))
_R48, _C48 = np.nonzero(np.ones((48, 48), bool))


def _dense_spec(a):
    return {"triplets": (a.shape[0], _R48, _C48, a[_R48, _C48])}


def _case(case_id, case_name, **kw):
    return (case_id, case_name, kw)


STOP_AT = 7
GRID = np.linspace(0.0, 7.0, 41)

#: the cases of every spawn: each method on the complex triplets
COMMON = [
    _case("two_pass_inv", "sparse_solve", spec=TRIPLETS, b=B, k=K, f="inv"),
    _case("two_pass_exp", "sparse_solve", spec=TRIPLETS, b=B, k=K, f="exp"),
    _case("one_pass_inv", "sparse_solve", spec=TRIPLETS, b=B, k=K, f="inv",
          method="one_pass"),
    _case("callback", "sparse_callback", spec=TRIPLETS, b=B, k=K,
          stop_at=STOP_AT, chunk=3),
    _case("reorth", "sparse_reorth", spec=TRIPLETS, b=B, k=K, reorth=True),
    _case("cheb", "sparse_chebyshev", spec=TRIPLETS, b=B, f="exp", degree=40,
          interval=(0.5, 6.5)),
    _case("cheb_auto", "sparse_chebyshev", spec=TRIPLETS, b=B, f="inv",
          degree=60),
    _case("slq", "sparse_slq", spec=TRIPLETS, f="inv", k=12, num_probes=4,
          key=3),
    _case("eigsh", "sparse_eigsh", spec=TRIPLETS, nev=3, which="LA",
          tol=1e-10, maxiter=200, v0=V0),
    _case("block", "sparse_block", spec=TRIPLETS, b_block=B_BLOCK, k=20),
    _case("c64", "sparse_solve", spec={"triplets": (
        N, ROWS, COLS, VALS.astype(np.complex64))}, b=B.astype(np.complex64),
        k=K, f="inv"),
]


@pytest.fixture(scope="module")
def ranks1(tmp_path_factory):
    cases = COMMON + [
        _case("dos", "sparse_dos", spec=TRIPLETS, grid=GRID, sigma=0.3, k=12,
              num_probes=4, key=12)]
    return spawn(1, cases, tmp_path_factory.mktemp("complex1"))


def _jax_fields(jsop):
    """The host fields ``convert.sharded_operator_from_jax`` reads, as
    NumPy in plain namespaces (a rank must not unpickle a JAX type)."""
    part = jsop.part
    return SimpleNamespace(
        part=SimpleNamespace(perm=np.asarray(part.perm),
                             rows_per=int(part.rows_per),
                             ndev=int(part.ndev), n_orig=int(part.n_orig)),
        local_blocks=[np.asarray(a) for a in jsop.local_blocks])


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    jax8 = JaxSparse(N, ROWS, COLS, VALS, jax_mesh(8))
    cases = COMMON + [
        _case("convert", "sparse_convert", jax_like=_jax_fields(jax8), b=B,
              k=K),
        _case("eig_dense", "sparse_eigsh", spec=_dense_spec(EIG_A), nev=2,
              which="LA", tol=1e-9, maxiter=200),
        _case("block_dense", "sparse_block", spec=_dense_spec(BLK_A),
              b_block=BLK_B, k=24),
        _case("adaptive", "sparse_adaptive", spec=TRIPLETS, k=8, batch=4,
              target=0.05, max_probes=16, key=5),
        _case("collectives", "sparse_collectives", spec=TRIPLETS, b=B, k=6),
        _case("real_block_errors", "sparse_block_errors",
              spec={"triplets": (16, np.arange(16), np.arange(16),
                                 np.ones(16))}),
        _case("errors", "sparse_dtype_errors", n=4),
    ]
    return spawn(2, cases, tmp_path_factory.mktemp("complex2"))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return spawn(4, COMMON, tmp_path_factory.mktemp("complex4"))


@pytest.fixture(scope="module")
def jax_ops():
    """The JAX operator on the complex triplets, one a mesh width."""
    return {d: JaxSparse(N, ROWS, COLS, VALS, jax_mesh(d)) for d in (1, 2, 4)}


ALL = pytest.mark.parametrize("ranks,ndev", [("ranks1", 1), ("ranks2", 2),
                                             ("ranks4", 4)],
                              indirect=["ranks"])


@pytest.fixture
def ranks(request):
    return request.getfixturevalue(request.param)


def _same(ranks, key, field):
    """``field`` of case ``key``, bitwise the same on every rank."""
    first = np.asarray(ranks[0][key][field])
    for r in ranks[1:]:
        np.testing.assert_array_equal(np.asarray(r[key][field]), first)
    return first


@ALL
@pytest.mark.parametrize("key,method,f", [
    ("two_pass_inv", "two_pass", "inv"), ("two_pass_exp", "two_pass", "exp"),
    ("one_pass_inv", "one_pass", "inv")])
def test_sharded_complex_solve_matches_jax(ranks, ndev, jax_ops, key,
                                           method, f):
    x = _same(ranks, key, "x")
    alphas = _same(ranks, key, "alphas")
    betas = _same(ranks, key, "betas")
    assert x.dtype == np.complex128 and ranks[0][key]["steps"] == K
    xj, dj = jax_ops[ndev].solve_fAb(B, k=K, f=f, method=method)
    np.testing.assert_allclose(alphas, np.asarray(dj.alphas), rtol=1e-10)
    np.testing.assert_allclose(betas, np.asarray(dj.betas), rtol=1e-10)
    assert _rel(x, np.asarray(xj)) < 1e-9
    single = tpl.solve_fAb(_port_op(), torch.from_numpy(B), k=K, f=f,
                           method=method).numpy()
    assert _rel(x, single) < 1e-9


@ALL
def test_sharded_complex64_solve(ranks, ndev, jax_ops):
    x = _same(ranks, "c64", "x")
    assert x.dtype == np.complex64
    xj, _ = jax_ops[ndev].solve_fAb(B, k=K, f="inv")
    assert _rel(x, np.asarray(xj)) < 2e-4


@ALL
def test_sharded_complex_callback_matches_jax(ranks, ndev, jax_ops):
    r = ranks[0]["callback"]
    assert r["seen"][-1] == STOP_AT and r["views"]
    assert r["steps"] == STOP_AT and r["p2_len"] == STOP_AT
    x = _same(ranks, "callback", "x")
    np.testing.assert_array_equal(x, r["ref"]["x"])
    xj, dj = jax_ops[ndev].solve_fAb(
        B, k=K, f="inv", callback=lambda s, *_: s < STOP_AT,
        callback_chunk=3)
    assert int(dj.steps_taken) == STOP_AT
    np.testing.assert_allclose(x, np.asarray(xj), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(xj)).max())


@ALL
def test_sharded_complex_reorth_matches_jax(ranks, ndev, jax_ops):
    x = _same(ranks, "reorth", "x")
    assert ranks[0]["reorth"]["defect"] < 1e-12
    xj, _ = jax_ops[ndev].solve_fAb(B, k=K, f="inv", method="one_pass",
                                    reorth=True)
    assert _rel(x, np.asarray(xj)) < 1e-9


@ALL
def test_sharded_complex_chebyshev_matches_jax(ranks, ndev, jax_ops):
    x = _same(ranks, "cheb", "x")
    xj = jax_ops[ndev].chebyshev_fAb(B, "exp", degree=40,
                                     interval=(0.5, 6.5))
    assert x.dtype == np.complex128
    assert _rel(x, np.asarray(xj)) < 1e-12
    assert _rel(x, _f_dense(DENSE, "exp", B)) < 1e-8


@ALL
def test_sharded_complex_estimate_interval(ranks, ndev):
    # estimate_interval under chebyshev_fAb(interval=None): an interval
    # that holds the spectrum, about as wide as the JAX one's widening
    lo, hi = ranks[0]["cheb_auto"]["interval"]
    lam = np.linalg.eigvalsh(DENSE)
    assert lo <= lam[0] and hi >= lam[-1]
    assert hi - lo < 1.2 * (lam[-1] - lam[0])
    x = _same(ranks, "cheb_auto", "x")
    assert _rel(x, _f_dense(DENSE, "inv", B)) < 1e-6


@ALL
def test_sharded_complex_slq_matches_jax(ranks, ndev, jax_ops):
    r = ranks[0]["slq"]
    probes = r["probes"]
    # rademacher probes stay real-valued in the complex dtype, as JAX's
    assert probes.dtype == np.complex128
    np.testing.assert_array_equal(probes.imag, 0.0)
    jdec = jax_ops[ndev]._slq_pass_one(probes, 12)
    np.testing.assert_allclose(r["dec"]["alphas"], np.asarray(jdec.alphas),
                               rtol=1e-10)
    np.testing.assert_allclose(r["dec"]["betas"], np.asarray(jdec.betas),
                               rtol=1e-10, atol=1e-12)
    samples = np.asarray(j_quad(jdec, "inv"))
    np.testing.assert_allclose(_same(ranks, "slq", "samples"), samples,
                               rtol=1e-10)
    truth = float(np.trace(np.linalg.inv(DENSE)).real)
    assert abs(r["estimate"] - truth) < 4 * r["stderr"] + 1e-8


@ALL
def test_sharded_complex_eigsh_matches_jax(ranks, ndev, jax_ops):
    r = ranks[0]["eigsh"]
    assert r["converged"]
    res = jax_ops[ndev].eigsh(nev=3, which="LA", tol=1e-10, maxiter=200,
                              v0=V0)
    np.testing.assert_allclose(r["values"], np.asarray(res.eigenvalues),
                               rtol=1e-9)
    np.testing.assert_allclose(r["values"], np.linalg.eigvalsh(DENSE)[-3:],
                               rtol=1e-9)
    assert np.iscomplexobj(r["vectors"])
    for theta, u in zip(r["values"], r["vectors"]):
        assert np.linalg.norm(DENSE @ u - theta * u) < 1e-8


@ALL
def test_sharded_complex_block_matches_jax(ranks, ndev, jax_ops):
    x = _same(ranks, "block", "x")
    assert ranks[0]["block"]["steps"] == 20
    xj = jax_ops[ndev].solve_fAb_block(B_BLOCK, k=20, f="inv")
    assert _rel(x, np.asarray(xj)) < 1e-9
    assert _rel(x, np.linalg.solve(DENSE, B_BLOCK)) < 1e-6


def test_sharded_complex_density(ranks1, jax_ops):
    from two_pass_lanczos_tpu.slq import dos_from_decomposition as j_dos
    r = ranks1[0]["dos"]
    probes = r["probes"] / np.linalg.norm(r["probes"], axis=1, keepdims=True)
    jdec = jax_ops[1]._slq_pass_one(probes, 12)
    phi = np.asarray(j_dos(jdec, jnp.asarray(GRID), jnp.asarray(0.3)))
    np.testing.assert_allclose(r["phi"], phi, rtol=1e-9, atol=1e-12)


def test_sharded_complex_adaptive(ranks2):
    r = ranks2[0]["adaptive"]
    assert 4 <= r["m"] <= 16 and r["m"] % 4 == 0
    truth = float(np.trace(DENSE @ DENSE).real)
    assert abs(r["estimate"] - truth) < 0.2 * truth


def test_sharded_complex_operator_from_jax(ranks2, jax_ops):
    # the complex triplets read back from a JAX operator on 8 devices
    x = _same(ranks2, "convert", "x")
    xj, _ = jax_ops[2].solve_fAb(B, k=K, f="inv")
    assert x.dtype == np.complex128
    assert _rel(x, np.asarray(xj)) < 1e-9


def test_sharded_eigsh_complex_hermitian(ranks2):
    """``tests/test_eigen_sharded.py:95`` on two ranks: complex basis rows
    split over the ranks, conjugated projections folded."""
    r = ranks2[0]["eig_dense"]
    assert r["converged"]
    np.testing.assert_allclose(r["values"], [9.0, 10.0], rtol=1e-8)
    assert np.iscomplexobj(r["vectors"])
    for theta, u in zip(r["values"], r["vectors"]):
        assert np.linalg.norm(u) == pytest.approx(1.0, abs=1e-9)
        assert np.linalg.norm(EIG_A @ u - theta * u) < 1e-7


def test_complex_hermitian_sharded_block(ranks2):
    """``tests/test_block.py:319`` on two ranks: CholeskyQR2 with Hermitian
    Gram folds against the dense oracle."""
    x = ranks2[0]["block_dense"]["x"]
    truth = (BLK_Q * (1.0 / BLK_D)) @ (BLK_Q.conj().T @ BLK_B)
    assert _rel(x, truth) < 1e-9


def test_sharded_complex_gathers_recorded_at_their_bytes(ranks2):
    r = ranks2[0]["collectives"]
    rp, n_pad = r["rows_per"], r["n_pad"]
    ops = {(o[0], o[1], o[2]): o[3] for o in r["ops"]}
    # the Krylov vector: one async c128 gather a matvec; α, β² real folds
    assert ops[("all-gather-start", "c128", (2, rp))] == 2 * 6 - 1
    assert ("all-gather", "f64", (2,)) in ops
    # the final x: one c128 gather of the shards
    assert ops[("all-gather", "c128", (2, rp))] == 1
    expect = sum(c * int(np.prod(s)) * {"c128": 16, "f64": 8}[d]
                 for (k, d, s), c in ops.items())
    assert r["bytes"] == expect
    assert n_pad == 2 * rp


def test_real_operator_refuses_a_complex_block(ranks2):
    e = ranks2[0]["real_block_errors"]["complex"]
    assert e.startswith("TypeError")
    assert "complex b_block with a real operator; build the " \
           "ShardedSparseOperator with complex vals" in e


def test_sharded_operator_admits_complex_dtypes_only(ranks2):
    e = ranks2[0]["errors"]
    assert e["complex64"] is None and e["complex128"] is None
    assert e["float16"].startswith("ValueError")
    assert e["int64"].startswith("ValueError")


def test_complex_collective_op_bytes():
    assert CollectiveOp("all-gather", "c128", (4, 10), 3).bytes_out \
        == 4 * 10 * 16 * 3
    assert CollectiveOp("all-gather", "c64", (2, 5), 1).bytes_out == 80
