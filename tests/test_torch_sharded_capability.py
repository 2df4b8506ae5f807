"""The sharded tiers' capability methods and reorthogonalisation against the
JAX package's and the port's single-device ones.

``ShardedSparseOperator`` (``eigsh``, ``slq_trace``,
``slq_spectral_density``, ``slq_trace_adaptive``, ``solve_fAb_block``,
``estimate_interval``, ``chebyshev_fAb``, ``solve_fAb(reorth=...)``) and
``ShardedFusedKKTSolver`` (the SLQ methods, ``estimate_interval``,
``chebyshev_fAb``) run in gloo processes on CPU tensors, one per rank,
spawned by ``tests/torch_ranks.py`` for D ∈ {1, 2, 4}; each spawn runs
many cases. The JAX side runs here: its ``ShardedSparseOperator`` on a
virtual CPU mesh of D devices where the JAX test does, the host solvers
otherwise, always on the same arrays (the probes and ``v0`` the port drew
go through both packages at the array seams; JAX's keys are not
reproduced). The tolerances are those of ``tests/test_eigen_sharded.py``,
``tests/test_slq.py``, ``tests/test_chebyshev.py``, ``tests/test_block.py``,
``tests/test_reorth.py`` and ``tests/test_fused_sharded.py``; what every
rank computes from the same folded bits is held bitwise across ranks.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import two_pass_lanczos_tpu as jtpl
from two_pass_lanczos_tpu.algorithms.block import solve_fAb_block as j_block
from two_pass_lanczos_tpu.algorithms.chebyshev import (
    chebyshev_fAb as j_chebyshev_fAb,
)
from two_pass_lanczos_tpu.parallel import ShardedSparseOperator as JaxSparse
from two_pass_lanczos_tpu.parallel import make_mesh as jax_mesh
from two_pass_lanczos_tpu.slq import (
    batched_quadratic_form as j_quad,
    dos_from_decomposition as j_dos,
    lanczos_pass_one_batched as j_batched,
)

from torch_cases import CPU
from torch_ranks import spawn
import two_pass_lanczos_tpu_torch as tpl
from two_pass_lanczos_tpu_torch import FusedKKTSolver
from two_pass_lanczos_tpu_torch.models.generator import generate_mcf_instance
from two_pass_lanczos_tpu_torch.models.synthetic import (
    create_diagonal_problem,
)


def _diag(d):
    d = np.asarray(d, np.float64)
    idx = np.arange(d.size)
    return {"triplets": (d.size, idx, idx, d)}


def _scaled_kkt(arcs, iid, scale=True):
    inst = generate_mcf_instance(arcs, rho=3, instance_id=iid)
    d = inst.quad_costs / (float(np.max(inst.quad_costs)) if scale else 1.0)
    return (d, inst.arc_u, inst.arc_v, inst.num_nodes)


def _kkt_spec(arrs):
    return {"kkt": arrs, "dtype": np.float64}


def _random_kkt(seed, m, p):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, p, m).astype(np.int32)
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    d = rng.uniform(1.0, 3.0, m).astype(np.float32)
    return dict(d=d, u=u, v=v, p=p)


# --- the instances of the JAX tests ------------------------------------------
D333 = np.linspace(0.5, 40.0, 333)          # test_eigen_sharded
DEGEN = np.array([1.0, 2.0, 3.0] * 40)
KKT_EIG = _scaled_kkt(400, 5)
V0_EIG = np.random.default_rng(5).standard_normal(400 + KKT_EIG[3])
D111 = np.array([1.0, 4.0, 9.0] * 37)       # test_slq
KKT_SLQ = _scaled_kkt(300, 7)
D200 = np.linspace(1.0, 4.0, 200)
D222 = np.linspace(0.5, 9.0, 222)
GRID = np.linspace(0.0, 10.0, 101)
KKT_CHEB = _scaled_kkt(400, 2)              # test_chebyshev
B_CHEB = np.random.default_rng(1).standard_normal(400 + KKT_CHEB[3])
KKT_CHEB_BAD = _scaled_kkt(200, 3, scale=False)
D222B = np.linspace(0.5, 8.0, 222)
VEC222 = np.random.default_rng(3).standard_normal(222)
D333B = np.linspace(0.5, 12.0, 333)         # test_block TestShardedBlock
B333 = np.random.default_rng(21).standard_normal((333, 3))
MULT = np.array([1.0, 1.0, 2.0, 2.0, 5.0, 5.0] * 20)
B_MULT = np.random.default_rng(22).standard_normal((MULT.size, 2))
D64 = np.linspace(1.0, 2.0, 64)
COL64 = np.random.default_rng(23).standard_normal(64)
B_DEF = np.stack([COL64, 3.0 * COL64], axis=1)
_, EIGS700 = create_diagonal_problem(700, "well-conditioned", "inv",
                                     device=CPU)
D700 = np.asarray(EIGS700)                  # test_reorth TestSharded
B700 = np.random.default_rng(42).standard_normal(700)
K_RE = 25
F_SLQ = _random_kkt(11, 600, 200)           # test_fused_sharded
F_DOS = _random_kkt(12, 400, 150)
F_CHEB = _random_kkt(13, 500, 150)
X_CHEB = np.random.default_rng(13).standard_normal(650).astype(np.float32)
F_AUTO = _random_kkt(14, 400, 120)
X_AUTO = np.random.default_rng(14).standard_normal(520).astype(np.float32)
F_ADAPT = _random_kkt(15, 300, 120)
F_SMALL = _random_kkt(16, 200, 80)
DOS_GRID = np.linspace(-4.0, 6.0, 81)


def _jax_sparse(d, ndev):
    idx = np.arange(d.size)
    return JaxSparse(d.size, idx, idx, np.asarray(d, np.float64),
                     jax_mesh(ndev))


def _jax_kkt(arrs, ndev):
    from two_pass_lanczos_tpu.utils.data_loader import KKTArrays
    d, u, v, p = arrs
    arrays = KKTArrays(quad_costs=d, arc_u=u, arc_v=v, num_nodes=p,
                       num_arcs=len(d))
    return JaxSparse.from_kkt_arrays(arrays, jax_mesh(ndev))


def _jax_fields(jsop):
    """The host fields ``convert.sharded_operator_from_jax`` reads, as
    NumPy in plain namespaces (a rank must not unpickle a JAX type)."""
    part = jsop.part
    return SimpleNamespace(
        part=SimpleNamespace(perm=np.asarray(part.perm),
                             rows_per=int(part.rows_per),
                             ndev=int(part.ndev), n_orig=int(part.n_orig)),
        local_blocks=[np.asarray(a) for a in jsop.local_blocks])


#: a JAX operator on 8 virtual devices, read back on D ranks
JAX_KKT = _jax_kkt(KKT_EIG, 8)
B_CONV = np.random.default_rng(9).standard_normal(400 + KKT_EIG[3])


def _case(case_id, case_name, **kw):
    return (case_id, case_name, kw)


#: the cases of every spawn
COMMON = [
    _case("eig_diag", "sparse_eigsh", spec=_diag(D333), nev=4, which="LA",
          tol=1e-10),
    _case("eig_kkt", "sparse_eigsh", spec=_kkt_spec(KKT_EIG), nev=3,
          which="LA", tol=1e-9, maxiter=300, v0=V0_EIG),
    _case("slq_exact", "sparse_slq", spec=_diag(D111), f="inv", k=8,
          num_probes=4, key=0),
    _case("cheb_kkt", "sparse_chebyshev", spec=_kkt_spec(KKT_CHEB), b=B_CHEB,
          f="exp", degree=60, interval=None),
    _case("block", "sparse_block", spec=_diag(D333B), b_block=B333, k=30),
    _case("reorth_full", "sparse_reorth", spec=_diag(D700), b=B700, k=K_RE,
          reorth=True),
    _case("reorth_selective", "sparse_reorth", spec=_diag(D700), b=B700,
          k=K_RE, reorth="selective"),
    _case("f_slq", "fused_slq", **F_SLQ, k=16, num_probes=5, key=11),
    _case("f_cheb", "fused_chebyshev", **F_CHEB, x=X_CHEB, f="exp",
          degree=30, interval=(-4.0, 6.0)),
]


@pytest.fixture(scope="module")
def ranks1(tmp_path_factory):
    cases = COMMON + [
        _case("f_cheb_raw", "fused_chebyshev", **F_CHEB, x=X_CHEB, f="exp",
              degree=30, interval=(-4.0, 6.0), raw=True),
    ]
    return spawn(1, cases, tmp_path_factory.mktemp("cap1"))


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    cases = COMMON + [
        _case("eig_errors", "sparse_eigsh_errors", spec=_diag(np.linspace(
            1.0, 5.0, 64))),
        _case("slq_kkt", "sparse_slq", spec=_kkt_spec(KKT_SLQ), f="x2", k=4,
              num_probes=8, key=11),
        _case("slq_errors", "sparse_slq_errors", spec=_diag(np.ones(16))),
        _case("adaptive", "sparse_adaptive", spec=_diag(D200), k=6, batch=4,
              target=0.05, max_probes=32, key=5),
        _case("dos", "sparse_dos", spec=_diag(D222), grid=GRID, sigma=0.3,
              k=16, num_probes=4, key=12),
        _case("cheb_errors", "sparse_chebyshev_errors",
              spec=_kkt_spec(KKT_CHEB_BAD)),
        _case("cheb_auto", "sparse_chebyshev", spec=_diag(D222B), b=VEC222,
              f="inv", degree=60),
        _case("block_deficient", "sparse_block", spec=_diag(D64),
              b_block=B_DEF, k=5),
        _case("block_errors", "sparse_block_errors", spec=_diag(np.ones(16))),
        _case("reorth_errors", "sparse_reorth_errors",
              spec=_diag(np.linspace(1.0, 2.0, 64))),
        _case("f_slq_errors", "fused_slq_errors", **F_SMALL),
        _case("f_dos", "fused_dos", **F_DOS, grid=DOS_GRID, k=10,
              num_probes=3, key=10),
        _case("f_cheb_errors", "fused_chebyshev_errors", **F_SMALL),
        _case("f_auto", "fused_chebyshev", **F_AUTO, x=X_AUTO, f="exp",
              degree=30),
        _case("f_adaptive", "fused_adaptive", **F_ADAPT, k=8, batch=4,
              target=0.2, max_probes=16, key=4),
        _case("convert", "sparse_convert", jax_like=_jax_fields(JAX_KKT),
              b=B_CONV, k=25),
    ]
    return spawn(2, cases, tmp_path_factory.mktemp("cap2"))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    cases = COMMON + [
        _case("eig_sa", "sparse_eigsh", spec=_diag(D333), nev=3, which="SA",
              tol=1e-10, maxiter=300),
        _case("eig_degen", "sparse_eigsh", spec=_diag(DEGEN), nev=3,
              which="LA", ncv=12, tol=1e-10),
        _case("block_mult", "sparse_block", spec=_diag(MULT), b_block=B_MULT,
              k=10),
        _case("convert", "sparse_convert", jax_like=_jax_fields(JAX_KKT),
              b=B_CONV, k=25),
    ]
    return spawn(4, cases, tmp_path_factory.mktemp("cap4"))


@pytest.fixture
def ranks(request):
    """The spawn of ``request.param`` ranks."""
    return request.getfixturevalue(f"ranks{request.param}")


ALL = pytest.mark.parametrize("ranks", [1, 2, 4], indirect=True)


def _same(ranks, key, field):
    """``field`` of case ``key``, which every rank must hold bit for bit."""
    first = ranks[0][key][field]
    for r in ranks[1:]:
        assert np.array_equal(r[key][field], first), (key, field)
    return first


def _rel(x, ref):
    return float(np.linalg.norm(np.asarray(x) - ref) / np.linalg.norm(ref))


def _dense_kkt(arrs):
    d, u, v, p = arrs
    m = len(d)
    a = np.zeros((m + p, m + p))
    a[np.arange(m), np.arange(m)] = d
    for j in range(m):
        a[m + u[j], j] += 1.0
        a[m + v[j], j] -= 1.0
    a[:m, m:] = a[m:, :m].T
    return a


def _host_kkt(arrs, dtype=jnp.float64):
    d, u, v, p = arrs
    return jtpl.make_kkt_operator(d, u, v, p, backend="xla", dtype=dtype)


@pytest.fixture(scope="module")
def jax_meshes():
    """The JAX package's sharded operator on meshes of 1, 2 and 4 virtual
    devices: the block solve, the reorthogonalised solves and eigsh on the
    KKT instance from the port's ``v0``."""
    out = {}
    for nd in (1, 2, 4):
        sop = _jax_sparse(D700, nd)
        blk = _jax_sparse(D333B, nd).solve_fAb_block(B333, k=30, f="inv")
        r_full, _ = sop.solve_fAb(B700, k=K_RE, f="inv", method="one_pass",
                                  reorth=True)
        r_sel, _ = sop.solve_fAb(B700, k=K_RE, f="inv", method="one_pass",
                                 reorth="selective")
        eig = _jax_kkt(KKT_EIG, nd).eigsh(nev=3, which="LA", tol=1e-9,
                                          maxiter=300, v0=V0_EIG)
        out[nd] = {"block": np.asarray(blk), "reorth_full": r_full,
                   "reorth_selective": r_sel, "eig_kkt": eig}
    return out


# --- eigsh -------------------------------------------------------------------

@ALL
def test_sharded_eigsh_diagonal_truth(ranks):
    values = _same(ranks, "eig_diag", "values")
    r = ranks[0]["eig_diag"]
    assert r["converged"]
    np.testing.assert_allclose(values, np.sort(D333)[-4:], rtol=1e-9)
    for j, u in enumerate(_same(ranks, "eig_diag", "vectors")):
        assert np.linalg.norm(u) == pytest.approx(1.0, abs=1e-9)
        assert abs(u[333 - 4 + j]) == pytest.approx(1.0, abs=1e-7)


@ALL
def test_sharded_eigsh_matches_host_on_kkt(ranks, jax_meshes):
    """N ranks against the JAX host eigsh (the JAX test's truth), the JAX
    sharded eigsh on a mesh of as many devices and the port's single-card
    eigsh, all from the same v0."""
    nd = len(ranks)
    r = ranks[0]["eig_kkt"]
    assert r["converged"]
    values = _same(ranks, "eig_kkt", "values")
    truth = jtpl.eigsh(_host_kkt(KKT_EIG), nev=3, which="LA", tol=1e-9,
                       maxiter=300, v0=jnp.asarray(V0_EIG))
    np.testing.assert_allclose(values, truth.eigenvalues, rtol=1e-8)
    for u_d, u_h in zip(r["vectors"], truth.eigenvectors):
        assert abs(float(u_d @ np.asarray(u_h))) == pytest.approx(1.0,
                                                                  abs=1e-6)
    jx = jax_meshes[nd]["eig_kkt"]
    np.testing.assert_allclose(values, jx.eigenvalues, rtol=1e-10)
    d, u, v, p = KKT_EIG
    single = tpl.eigsh(tpl.make_kkt_operator(d, u, v, p, device=CPU), nev=3,
                       which="LA", tol=1e-9, maxiter=300, v0=V0_EIG)
    np.testing.assert_allclose(values, single.eigenvalues, rtol=1e-10)


def test_sharded_eigsh_sa_padding_never_leaks(ranks4):
    """which="SA" would pick up the row padding's spurious zero
    eigenvalues if an injection or v0 ever touched a padded row; λ_min is
    0.5 here."""
    r = ranks4[0]["eig_sa"]
    assert r["converged"]
    np.testing.assert_allclose(r["values"], np.sort(D333)[:3], rtol=1e-9)
    assert r["values"][0] > 0.4


def test_sharded_eigsh_degenerate_injection_across_mesh(ranks4):
    """The masked per-rank injections find the degenerate copies."""
    r = ranks4[0]["eig_degen"]
    assert r["converged"]
    np.testing.assert_allclose(r["values"], [3.0, 3.0, 3.0], rtol=1e-9)
    gram = r["vectors"] @ r["vectors"].T
    np.testing.assert_allclose(gram, np.eye(3), atol=1e-8)
    _same(ranks4, "eig_degen", "vectors")


def test_sharded_eigsh_validation(ranks2):
    e = ranks2[0]["eig_errors"]
    assert e["which"].startswith("ValueError") and "which" in e["which"]
    assert e["v0"].startswith("ValueError") and "nonzero" in e["v0"]


# --- SLQ ---------------------------------------------------------------------

@ALL
def test_sharded_slq_trace_diagonal_exact(ranks):
    r = ranks[0]["slq_exact"]
    _same(ranks, "slq_exact", "samples")
    assert r["estimate"] == pytest.approx(float(np.sum(1.0 / D111)),
                                          rel=1e-9)
    assert r["stderr"] == pytest.approx(0.0, abs=1e-8)


def test_sharded_slq_matches_single_device_estimator(ranks2):
    """The same probes through the row partition, the port's host
    estimator (same key) and the JAX host pass one (same probes)."""
    r = ranks2[0]["slq_kkt"]
    d, u, v, p = KKT_SLQ
    f = lambda t: t ** 2  # noqa: E731
    host = tpl.slq_trace(tpl.make_kkt_operator(d, u, v, p, device=CPU), f,
                         k=4, num_probes=8, key=11)
    np.testing.assert_allclose(r["samples"], host.samples.numpy(),
                               rtol=1e-10)
    assert r["estimate"] == pytest.approx(float(host.estimate), rel=1e-10)
    jdec = j_batched(_host_kkt(KKT_SLQ), jnp.asarray(r["probes"]), 4)
    np.testing.assert_allclose(r["samples"], np.asarray(j_quad(jdec, f)),
                               rtol=1e-10)
    for field in ("alphas", "betas"):
        np.testing.assert_allclose(r["dec"][field],
                                   np.asarray(getattr(jdec, field)),
                                   rtol=1e-10, atol=1e-12)


def test_sharded_slq_validation(ranks2):
    e = ranks2[0]["slq_errors"]
    assert e["num_probes"].startswith("ValueError")
    assert "num_probes" in e["num_probes"]
    assert "unknown function" in e["f"]


def test_generic_sharded_adaptive(ranks2):
    """Diagonal A and Rademacher probes: every sample is exact, the
    stderr 0, so the loop stops at its two-batch minimum."""
    r = ranks2[0]["adaptive"]
    assert r["estimate"] == pytest.approx(float(np.sum(D200 ** 2)), rel=1e-5)
    assert r["m"] == 8


def test_sharded_dos_matches_host(ranks2):
    r = ranks2[0]["dos"]
    phi = _same(ranks2, "dos", "phi")
    host = tpl.slq_spectral_density(tpl.DiagonalOperator(D222, device=CPU),
                                    GRID, sigma=0.3, k=16, num_probes=4,
                                    key=12).numpy()
    np.testing.assert_allclose(phi, host, rtol=1e-8, atol=1e-10 * host.max())
    z = r["probes"] / np.linalg.norm(r["probes"], axis=1, keepdims=True)
    jdec = j_batched(jtpl.DiagonalOperator(jnp.asarray(D222)),
                     jnp.asarray(z), 16)
    ref = np.asarray(j_dos(jdec, jnp.asarray(GRID), jnp.asarray(0.3)))
    np.testing.assert_allclose(phi, ref, rtol=1e-8, atol=1e-10 * ref.max())
    assert abs(np.trapezoid(phi, GRID) - 1.0) < 0.05


# --- Chebyshev and the interval ----------------------------------------------

@ALL
def test_sharded_chebyshev_matches_host(ranks):
    """The interval from the sharded eigsh, and the expansion on it against
    the JAX host expansion on the same interval."""
    x = _same(ranks, "cheb_kkt", "x")
    iv = _same(ranks, "cheb_kkt", "interval")
    d, u, v, p = KKT_CHEB
    op = tpl.make_kkt_operator(d, u, v, p, device=CPU)
    np.testing.assert_allclose(iv, tpl.estimate_interval(op), rtol=1e-9)
    lam = np.linalg.eigvalsh(_dense_kkt(KKT_CHEB))
    assert iv[0] <= lam[0] and lam[-1] <= iv[1]
    ref = np.asarray(j_chebyshev_fAb(_host_kkt(KKT_CHEB), jnp.asarray(B_CHEB),
                                     "exp", degree=60, interval=iv))
    assert np.all(np.isfinite(ref)) and np.linalg.norm(ref) > 0
    np.testing.assert_allclose(x, ref, rtol=1e-11, atol=1e-13)


def test_sharded_chebyshev_validation(ranks2):
    assert "sign-definite" in ranks2[0]["cheb_errors"]["inv"]


def test_sharded_interval_estimation_and_auto_chebyshev(ranks2):
    r = ranks2[0]["cheb_auto"]
    a, b_hi = r["interval"]
    assert a <= 0.5 and b_hi >= 8.0
    assert a > 0.0
    assert b_hi < 12.0
    assert _rel(r["x"], VEC222 / D222B) < 1e-6


# --- block Lanczos (CholeskyQR2) ---------------------------------------------

@ALL
def test_sharded_block_matches_single_device_and_truth(ranks, jax_meshes):
    x = _same(ranks, "block", "x")
    truth = B333 / D333B[:, None]
    assert _rel(x, truth) < 1e-5  # Krylov convergence at k=30, κ=24
    single = tpl.solve_fAb_block(tpl.DiagonalOperator(D333B, device=CPU),
                                 B333, 30, "inv").numpy()
    assert _rel(x, single) < 1e-10  # CholeskyQR2 against Householder
    j1 = np.asarray(j_block(jtpl.DiagonalOperator(jnp.asarray(D333B)),
                            jnp.asarray(B333), 30, "inv"))
    assert _rel(x, j1) < 1e-10
    assert _rel(x, jax_meshes[len(ranks)]["block"]) < 1e-10


def test_sharded_block_breakdown_multiplicity(ranks4):
    """Three distinct eigenvalues, width 2: the space is exhausted at s = 3
    and the solve is exact; the rank test sees it through the recurrence
    scale."""
    r = ranks4[0]["block_mult"]
    np.testing.assert_allclose(r["x"], B_MULT / MULT[:, None], rtol=1e-9)
    assert r["steps"] == 3
    dec, _ = tpl.block_pass_one(
        tpl.DiagonalOperator(MULT, device=CPU).matvec,
        torch.from_numpy(B_MULT), 10)
    assert int(dec.steps_taken) == r["steps"]


def test_sharded_block_rank_deficient_b_zeros(ranks2):
    r = ranks2[0]["block_deficient"]
    np.testing.assert_array_equal(r["x"], np.zeros((64, 2)))
    assert r["steps"] == 0


def test_sharded_block_validation(ranks2):
    e = ranks2[0]["block_errors"]
    assert "b_block must be" in e["ndim"]
    assert "rows" in e["rows"]
    assert "unknown function" in e["f"]
    assert "k must be >= 1" in e["k"]
    assert "block width" in e["width"]
    assert e["complex"].startswith("TypeError")
    assert "complex b_block with a real" in e["complex"]


# --- reorthogonalisation -----------------------------------------------------

@pytest.mark.parametrize("mode", ["full", "selective"])
@ALL
def test_sharded_reorth_matches_single_device(ranks, jax_meshes, mode):
    key = f"reorth_{mode}"
    x = _same(ranks, key, "x")
    for field in ("alphas", "betas"):
        _same(ranks, key, field)
    assert ranks[0][key]["steps"] == K_RE
    reorth = True if mode == "full" else "selective"
    single = tpl.solve_fAb(tpl.DiagonalOperator(D700, device=CPU),
                           torch.from_numpy(B700), k=K_RE, f="inv",
                           method="one_pass", reorth=reorth).numpy()
    assert _rel(x, single) < 1e-9
    assert _rel(x, jax_meshes[len(ranks)][key]) < 1e-9
    assert ranks[0][key]["defect"] < 1e-12


def test_sharded_reorth_guards(ranks2):
    e = ranks2[0]["reorth_errors"]
    assert "one_pass" in e["two_pass"]
    assert "callback" in e["callback"]
    assert "reorth must be" in e["typo"]


# --- the arc-sharded solver --------------------------------------------------

@ALL
def test_fused_sharded_slq_matches_fused_and_xla(ranks):
    """The same probes through the arc partition, the port's single-card
    fused solver (same key) and the JAX XLA pass one (same probes): every
    sample within f32 rounding (rtol 2e-3)."""
    r = ranks[0]["f_slq"]
    samples = _same(ranks, "f_slq", "samples")
    g = F_SLQ
    single = FusedKKTSolver(g["d"], g["u"], g["v"], g["p"], device=CPU)
    res_f = single.slq_trace("exp", k=16, num_probes=5, key=11)
    np.testing.assert_allclose(samples, res_f.samples.numpy(), rtol=2e-3)
    op = jtpl.make_kkt_operator(g["d"], g["u"], g["v"], g["p"],
                                backend="xla", dtype=jnp.float32)
    jdec = j_batched(op, jnp.asarray(r["probes"]), 16)
    np.testing.assert_allclose(samples, np.asarray(j_quad(jdec, "exp")),
                               rtol=2e-3)


@ALL
def test_fused_sharded_slq_probe_is_a_solves_pass_one(ranks):
    """Each probe runs the recurrence of ``solve``: its α, β, ‖z‖ and
    steps are bitwise a pass one on that probe."""
    for r in ranks:
        c = r["f_slq"]
        for field in ("alphas", "betas"):
            assert np.array_equal(c["dec"][field][0], c["solo"][field])
        assert c["dec"]["b_norm"][0] == c["solo"]["b_norm"]
        assert c["dec"]["steps"][0] == c["solo"]["steps"]


def test_fused_sharded_slq_validation(ranks2):
    e = ranks2[0]["f_slq_errors"]
    assert "num_probes" in e["num_probes"]
    assert "unknown" in e["f"]


def test_fused_sharded_dos_matches_single_chip(ranks2):
    phi = _same(ranks2, "f_dos", "phi")
    g = F_DOS
    ref = FusedKKTSolver(g["d"], g["u"], g["v"], g["p"],
                         device=CPU).slq_spectral_density(
        DOS_GRID, k=10, num_probes=3, key=10).numpy()
    np.testing.assert_allclose(phi, ref, rtol=5e-3, atol=5e-4 * ref.max())


@ALL
def test_fused_sharded_chebyshev_matches_xla(ranks):
    y = _same(ranks, "f_cheb", "y")
    g = F_CHEB
    op = jtpl.make_kkt_operator(g["d"], g["u"], g["v"], g["p"],
                                backend="xla", dtype=jnp.float32)
    ref = np.asarray(j_chebyshev_fAb(op, jnp.asarray(X_CHEB), "exp",
                                     degree=30, interval=(-4.0, 6.0)))
    np.testing.assert_allclose(y, ref, rtol=2e-4, atol=2e-4 * np.abs(ref).max())
    single = FusedKKTSolver(g["d"], g["u"], g["v"], g["p"],
                            device=CPU).chebyshev_fAb(
        X_CHEB, "exp", degree=30, interval=(-4.0, 6.0))
    np.testing.assert_allclose(y, single, rtol=2e-4,
                               atol=2e-4 * np.abs(single).max())


def test_fused_sharded_chebyshev_raw(ranks1):
    r = ranks1[0]["f_cheb_raw"]["y"]
    full = ranks1[0]["f_cheb"]["y"]
    assert np.array_equal(np.concatenate([r["ya"], r["yn"]]), full)
    assert r["m_d"] == F_CHEB["d"].size


def test_fused_sharded_chebyshev_interval_validation(ranks2):
    assert "sign-definite" in ranks2[0]["f_cheb_errors"]["inv"]


def test_fused_sharded_auto_interval(ranks2):
    """The cached interval (eigsh on the instance's KKT operator) drives
    the same expansion as an explicit-interval XLA run."""
    for r in ranks2:
        assert r["f_auto"]["cached"]
    iv = _same(ranks2, "f_auto", "interval")
    g = F_AUTO
    op = jtpl.make_kkt_operator(g["d"], g["u"], g["v"], g["p"],
                                backend="xla", dtype=jnp.float32)
    ref = np.asarray(j_chebyshev_fAb(op, jnp.asarray(X_AUTO), "exp",
                                     degree=30, interval=tuple(iv)))
    y = _same(ranks2, "f_auto", "y")
    np.testing.assert_allclose(y, ref, rtol=2e-4, atol=2e-4 * np.abs(ref).max())
    single = FusedKKTSolver(g["d"], g["u"], g["v"], g["p"],
                            device=CPU).estimate_interval()
    np.testing.assert_allclose(iv, single, rtol=1e-6)


def test_fused_sharded_adaptive(ranks2):
    g = F_ADAPT
    truth = float(np.sum(g["d"].astype(np.float64) ** 2) + 4 * len(g["d"]))
    assert abs(ranks2[0]["f_adaptive"]["estimate"] - truth) < 0.3 * truth
    assert ranks2[0]["f_adaptive"]["m"] >= 8


# --- the converter ------------------------------------------------------------

@pytest.mark.parametrize("ranks", [2, 4], indirect=True)
def test_sharded_operator_from_jax(ranks):
    """The JAX operator's matrix, read back from its 8 devices' blocks and
    partitioned over D ranks, solves as the JAX operator does (the
    tolerance of ``tests/test_torch_sharded_sparse.py``)."""
    x = _same(ranks, "convert", "x")
    xj, dj = JAX_KKT.solve_fAb(B_CONV, k=25, f="inv")
    assert _rel(x, np.asarray(xj)) < 1e-9
    np.testing.assert_allclose(ranks[0]["convert"]["alphas"],
                               np.asarray(dj.alphas), rtol=1e-10, atol=1e-12)
