"""The port's row-sharded ``ShardedSparseOperator`` against the JAX
package's and against the port's single-device generic tier.

The port runs in gloo processes on CPU tensors, one per rank, spawned by
``tests/torch_ranks.py`` for D ∈ {1, 2, 3, 4}; each spawn runs several
cases. The JAX side runs here as ``tests/test_sharded.py`` runs it: f64 on
the virtual CPU mesh ``make_mesh(8)``. The tolerances are the JAX tests'
own (``tests/test_sharded.py``, ``tests/test_collectives.py``): SpMV
against dense at atol 1e-12, solves against one device at 1e-9 (inv on the
KKT) and 1e-13 (exp on the diagonal problem), α, β at rtol 1e-10, mesh
sizes at 1e-9, a callback stop's x at atol 1e-12·max|x|; what is the same
computation on every rank, or chunked against monolithic, is held bitwise.
"""

import numpy as np
import pytest
import torch

from two_pass_lanczos_tpu.parallel import ShardedSparseOperator as JaxSparse
from two_pass_lanczos_tpu.parallel import make_mesh as jax_mesh

from torch_cases import CPU
from torch_ranks import spawn
import two_pass_lanczos_tpu_torch as tpl
from two_pass_lanczos_tpu_torch.models.generator import generate_mcf_instance
from two_pass_lanczos_tpu_torch.models.kkt import (
    kkt_operator_from_arrays,
    kkt_sorted_coo,
)
from two_pass_lanczos_tpu_torch.models.synthetic import (
    create_diagonal_problem,
)
from two_pass_lanczos_tpu_torch.utils.data_loader import KKTArrays

K = 25


def _arrays(arcs=500, iid=1):
    inst = generate_mcf_instance(arcs, rho=3, instance_id=iid)
    return KKTArrays(quad_costs=inst.quad_costs, arc_u=inst.arc_u,
                     arc_v=inst.arc_v, num_nodes=inst.num_nodes,
                     num_arcs=inst.num_arcs)


def _kkt(arrays, dtype=np.float64):
    return {"kkt": (arrays.quad_costs, arrays.arc_u, arrays.arc_v,
                    arrays.num_nodes), "dtype": dtype}


#: the JAX tests' instances (tests/test_sharded.py, tests/test_collectives.py)
KKT500 = _arrays()
KKT300 = _arrays(arcs=300)
COLL = _arrays(arcs=20_000)
DIAG_OP, EIGS = create_diagonal_problem(700, "well-conditioned", "exp",
                                        device=CPU)
DIAG = {"triplets": (700, np.arange(700), np.arange(700), EIGS)}
B_KKT = np.random.default_rng(42).standard_normal(KKT500.n)
B_DIAG = np.random.default_rng(42).standard_normal(700)
B_CONS = np.random.default_rng(1).standard_normal(KKT300.n)
B_CHUNK = np.random.default_rng(7).standard_normal(KKT500.n)
B_COLL = np.random.default_rng(0).standard_normal(COLL.n)
X_DENSE = np.random.default_rng(0).standard_normal(KKT500.n)
X_COLL = np.random.default_rng(3).standard_normal(COLL.n)
METHODS = ["one_pass", "two_pass"]
FUNCS = ["exp", "inv"]


def _solve_case(method, f):
    spec, b = (_kkt(KKT500), B_KKT) if f == "inv" else (DIAG, B_DIAG)
    return (f"{method}_{f}", "sparse_solve",
            dict(spec=spec, b=b, k=K, f=f, method=method))


#: the cases every spawn runs
COMMON = ([_solve_case(mth, f) for mth in METHODS for f in FUNCS]
          + [("matvec", "sparse_matvec", dict(spec=_kkt(KKT500), x=X_DENSE)),
             ("cons", "sparse_solve", dict(spec=_kkt(KKT300), b=B_CONS, k=20,
                                           f="inv")),
             ("replay", "sparse_replay", dict(spec=_kkt(KKT500), b=B_KKT,
                                              k=K))])


@pytest.fixture(scope="module")
def ranks1(tmp_path_factory):
    cases = COMMON + [
        ("callback", "sparse_callback", dict(spec=_kkt(KKT500), b=B_CHUNK,
                                             k=30, stop_at=11, chunk=4)),
        ("mesh1_f32", "sparse_solve", dict(spec=_kkt(KKT500, np.float32),
                                           b=B_KKT, k=12, f="inv"))]
    return spawn(1, cases, tmp_path_factory.mktemp("sparse1"))


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    cases = COMMON + [
        ("chunked", "sparse_chunked", dict(spec=_kkt(KKT500), b=B_CHUNK,
                                           k=23, chunk=8)),
        ("zero", "sparse_zero", dict(spec=_kkt(KKT500), k=8, chunk=4)),
        ("collectives", "sparse_collectives", dict(
            spec=_kkt(KKT500), b=B_KKT, k=6))]
    return spawn(2, cases, tmp_path_factory.mktemp("sparse2"))


@pytest.fixture(scope="module")
def ranks3(tmp_path_factory):
    cases = COMMON + [
        ("callback", "sparse_callback", dict(spec=_kkt(KKT500), b=B_CHUNK,
                                             k=30, stop_at=11, chunk=4))]
    return spawn(3, cases, tmp_path_factory.mktemp("sparse3"))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    cases = COMMON + [
        ("chunked", "sparse_chunked", dict(spec=_kkt(KKT500), b=B_CHUNK,
                                           k=23, chunk=8)),
        ("callback", "sparse_callback", dict(spec=_kkt(KKT500), b=B_CHUNK,
                                             k=30, stop_at=11, chunk=4)),
        ("multi", "sparse_solve", dict(spec=DIAG, b=B_DIAG, k=K,
                                       f=("exp", "inv"))),
        ("raw", "sparse_solve", dict(spec=_kkt(KKT500), b=B_KKT, k=K,
                                     f="inv", raw=True)),
        ("errors", "sparse_errors", dict(spec=_kkt(KKT500))),
        ("coll_matvec", "sparse_matvec", dict(spec=_kkt(COLL), x=X_COLL)),
        ("collectives", "sparse_collectives", dict(
            spec=_kkt(COLL), b=B_COLL, k=8)),
        # the arc-sharded f32 solver on the same instance: its O(p) gathers
        ("fused_collectives", "collectives", dict(
            d=COLL.quad_costs.astype(np.float32), u=COLL.arc_u,
            v=COLL.arc_v, p=COLL.num_nodes, b=B_COLL.astype(np.float32),
            k=8)),
    ]
    return spawn(4, cases, tmp_path_factory.mktemp("sparse4"))


@pytest.fixture
def ranks(request):
    """The spawn of ``request.param`` ranks."""
    return request.getfixturevalue(f"ranks{request.param}")


@pytest.fixture(scope="module")
def jax8():
    """The JAX package's sharded operator on the virtual 8-device mesh."""
    mesh = jax_mesh(8)
    kkt = JaxSparse.from_kkt_arrays(KKT500, mesh)
    diag = JaxSparse(700, np.arange(700), np.arange(700), EIGS, mesh)
    out = {}
    for method in METHODS:
        x, dec = kkt.solve_fAb(B_KKT, k=K, f="inv", method=method)
        out[f"{method}_inv"] = (x, np.asarray(dec.alphas))
        x, dec = diag.solve_fAb(B_DIAG, k=K, f="exp", method=method)
        out[f"{method}_exp"] = (x, np.asarray(dec.alphas))
    return out


def _same_on_every_rank(ranks, key, field):
    first = ranks[0][key][field]
    for r in ranks[1:]:
        assert np.array_equal(r[key][field], first), (key, field)
    return first


def _rel(x, ref):
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _single(f, method, k=K):
    """The port's single-device generic solve on the CPU, f64."""
    if f == "inv":
        op, b = kkt_operator_from_arrays(KKT500, device=CPU).operator, B_KKT
    else:
        op, b = DIAG_OP, B_DIAG
    return tpl.solve_fAb(op, torch.from_numpy(b), k=k, f=f,
                         method=method).numpy()


# --- SpMV -------------------------------------------------------------------

@pytest.mark.parametrize("ranks", [1, 2, 3, 4], indirect=True)
def test_distributed_spmv_matches_dense(ranks):
    dense = kkt_sorted_coo(KKT500, device=CPU).todense().numpy()
    y = _same_on_every_rank(ranks, "matvec", "y")
    np.testing.assert_allclose(y, dense @ X_DENSE, atol=1e-12)
    assert ranks[0]["matvec"]["shape"] == (KKT500.n, KKT500.n)


def test_generic_split_matvec_matches_dense(ranks4):
    """Owned + remote split reproduces the full SpMV (the JAX test's numpy
    reference on its 20,000-arc instance)."""
    y = _same_on_every_rank(ranks4, "coll_matvec", "y")
    m, x = COLL.num_arcs, X_COLL
    yt = np.zeros_like(y)
    yt[:m] = COLL.quad_costs * x[:m] + x[m + COLL.arc_u] - x[m + COLL.arc_v]
    np.add.at(yt, m + COLL.arc_u, x[:m])
    np.add.at(yt, m + COLL.arc_v, -x[:m])
    assert np.allclose(y, yt, rtol=1e-12, atol=1e-12)


# --- solves -----------------------------------------------------------------

@pytest.mark.parametrize("f", FUNCS)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("ranks", [1, 2, 3, 4], indirect=True)
def test_distributed_solve_matches_single_device(ranks, method, f):
    # exp on the KKT spectrum overflows: the diagonal problem takes exp
    x = _same_on_every_rank(ranks, f"{method}_{f}", "x")
    tol = 1e-9 if f == "inv" else 1e-13
    rel = _rel(x, _single(f, method))
    assert rel < tol, f"{method}/{f}: N-rank vs 1-device deviation {rel:.3e}"
    assert ranks[0][f"{method}_{f}"]["steps"] == K


@pytest.mark.parametrize("f", FUNCS)
@pytest.mark.parametrize("method", METHODS)
def test_matches_jax_sharded_operator(ranks4, jax8, method, f):
    """The ranks' x against the JAX package's ShardedSparseOperator on the
    same triplets and b (f64, 8 virtual devices)."""
    x = _same_on_every_rank(ranks4, f"{method}_{f}", "x")
    xj, aj = jax8[f"{method}_{f}"]
    assert _rel(x, np.asarray(xj)) < 1e-9
    np.testing.assert_allclose(ranks4[0][f"{method}_{f}"]["alphas"], aj,
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("ranks", [1, 2, 3, 4], indirect=True)
def test_distributed_decomposition_matches_single_device(ranks):
    op = kkt_operator_from_arrays(KKT500, device=CPU).operator
    single = tpl.lanczos_pass_one(op, torch.from_numpy(B_KKT), K)
    for field, ref in (("alphas", single.alphas), ("betas", single.betas)):
        got = _same_on_every_rank(ranks, "replay", field)
        np.testing.assert_allclose(got, ref.numpy(), rtol=1e-10, atol=1e-12)


def test_distributed_mesh_sizes_consistent(ranks1, ranks2, ranks3, ranks4):
    # the same problem over 1, 2, 3 and 4 ranks agrees to tolerance
    xs = [_same_on_every_rank(r, "cons", "x")
          for r in (ranks1, ranks2, ranks3, ranks4)]
    for x in xs[1:]:
        assert _rel(x, xs[0]) < 1e-9


def test_mesh_of_one_in_f32(ranks1):
    r = ranks1[0]["mesh1_f32"]
    op = tpl.make_kkt_operator(KKT500.quad_costs, KKT500.arc_u, KKT500.arc_v,
                               KKT500.num_nodes, dtype=torch.float32,
                               device=CPU)
    x1 = tpl.solve_fAb(op, torch.from_numpy(B_KKT.astype(np.float32)), k=12,
                       f="inv").numpy()
    assert r["x"].dtype == np.float32 and r["steps"] == 12
    assert _rel(r["x"], x1) < 1e-4


def test_multi_f_and_raw(ranks4):
    xm = _same_on_every_rank(ranks4, "multi", "x")
    assert xm.shape == (2, 700)
    # one decomposition, one replay: the exp row is the single-f solve
    assert np.array_equal(xm[0], ranks4[0]["two_pass_exp"]["x"])
    inv = tpl.solve_fAb(DIAG_OP, torch.from_numpy(B_DIAG), k=K,
                        f="inv").numpy()
    assert _rel(xm[1], inv) < 1e-9
    # raw: each rank's row-permuted shard, no collective
    x = ranks4[0]["two_pass_inv"]["x"]
    from two_pass_lanczos_tpu_torch.parallel import snake_partition
    part = snake_partition(np.bincount(np.concatenate(
        [np.arange(KKT500.num_arcs)] * 3 + [KKT500.arc_u + KKT500.num_arcs,
                                            KKT500.arc_v + KKT500.num_arcs]),
        minlength=KKT500.n), 4)
    for rank, r in enumerate(ranks4):
        ids = part.perm[rank * part.rows_per:(rank + 1) * part.rows_per]
        shard = r["raw"]["x"]
        assert shard.shape == (part.rows_per,)
        assert np.array_equal(shard[ids < KKT500.n], x[ids[ids < KKT500.n]])
        assert (shard[ids >= KKT500.n] == 0).all()


# --- replay, chunked pass one, the callback ---------------------------------

@pytest.mark.parametrize("ranks", [1, 2, 4], indirect=True)
def test_pass_two_replays_pass_one_bitwise(ranks):
    for r in ranks:
        assert r["replay"]["replay"] and r["replay"]["steps"] == K
    for field in ("alphas", "betas", "b_norm"):
        _same_on_every_rank(ranks, "replay", field)


@pytest.mark.parametrize("ranks", [2, 4], indirect=True)
def test_bit_identical_to_monolithic(ranks):
    for r in ranks:
        c = r["chunked"]
        assert not c["stopped"] and c["steps"] == 23
        assert np.array_equal(c["alphas"], c["mono"]["alphas"])
        assert np.array_equal(c["betas"], c["mono"]["betas"])
        assert c["launches"] == 3  # ceil(23 / 8) chunks


@pytest.mark.parametrize("ranks", [1, 3, 4], indirect=True)
def test_callback_stop_cost_and_result(ranks):
    stop_at, chunk = 11, 4
    for r in ranks:
        c = r["callback"]
        assert c["seen"] == list(range(1, stop_at + 1)) and c["views"]
        assert c["steps"] == stop_at
        assert c["p1_launches"] <= -(-stop_at // chunk)
        assert c["p2_len"] == stop_at
        ref = c["ref"]
        assert np.array_equal(c["alphas"][:stop_at], ref["alphas"])
        np.testing.assert_allclose(c["x"], ref["x"], rtol=0,
                                   atol=1e-12 * np.abs(ref["x"]).max())


def test_zero_b(ranks2):
    r = ranks2[0]["zero"]
    assert not r["stopped"]
    assert r["steps"] == r["steps_cb"] == r["steps_mono"] == 0
    np.testing.assert_array_equal(r["x"], 0.0)
    np.testing.assert_array_equal(r["x_mono"], 0.0)


# --- collectives ------------------------------------------------------------

def test_generic_path_collectives(ranks4):
    """Per matvec one O(n) gather of the padded Krylov vector; besides it
    only the (D,) dot partials and the final gather of x."""
    d, k = 4, 8
    for r in ranks4:
        c = r["collectives"]
        rp = c["rows_per"]
        assert c["steps"] == k and c["n_pad"] == d * rp
        assert c["ops"] == sorted([
            ("all-gather", "f64", (d,), 2 * k + 1),       # |b|, alpha, beta²
            ("all-gather", "f64", (d, rp), 1),            # x, once
            ("all-gather-start", "f64", (d, rp), 2 * k - 1),  # a matvec each
        ])


def test_traffic_ratio_matches_perf_model(ranks4):
    """The O(n) against the O(p) design: per step the generic path gathers
    the padded vector (n_pad·8 bytes in f64), the arc-sharded solver its
    (D, p) f32 node partials (D·p·4 bytes)."""
    d = 4
    c = ranks4[0]["collectives"]
    gathers = [o for o in c["ops"] if o[0] == "all-gather-start"]
    per_step_gather = max(np.prod(s) * 8 for _, _, s, _ in gathers)
    assert per_step_gather == c["n_pad"] * 8
    fused = ranks4[0]["fused_collectives"]["ops"]
    node = [o for o in fused if o[2] == (d, COLL.num_nodes)]
    per_step_fused = max(np.prod(s) * 4 for _, _, s, _ in node)
    assert per_step_fused == d * COLL.num_nodes * 4
    assert per_step_gather / per_step_fused > 25  # O(n)/O(p)


def test_nnz_balance(ranks4):
    """The snake partition balances nnz, not rows: max/mean < 1.02 on the
    KKT instance across the ranks."""
    per = np.asarray(ranks4[0]["collectives"]["nnz"])
    assert per.sum() == 5 * COLL.num_arcs
    assert per.max() / per.mean() < 1.02, per


@pytest.mark.parametrize("ranks", [2, 4], indirect=True)
def test_generic_matvec_overlaps_halo_with_owned_spmv(ranks):
    """SURVEY §7 stage 5: every matvec issues its gather, computes the
    owned-column SpMV while it is in flight, waits, then computes the
    remote-column part."""
    for r in ranks:
        ev = [e for e in r["collectives"]["events"]
              if e != "all-gather"]  # the dots' and x's blocking gathers
        steps = [ev[i:i + 4] for i in range(0, len(ev), 4)]
        assert steps and all(s == ["all-gather-start", "owned-spmv",
                                   "all-gather-done", "remote-spmv"]
                             for s in steps), ev


# --- what the operator refuses ----------------------------------------------

def test_unported_capabilities_and_options_raise(ranks4):
    e = ranks4[0]["errors"]
    assert e["method"].startswith("ValueError")
    assert "two_pass" in e["callback_one_pass"]
    assert "length" in e["shape"] and e["chunk"].startswith("ValueError")
