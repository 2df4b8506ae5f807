"""The port's arc-sharded f32 solver against the JAX package's.

``two_pass_lanczos_tpu_torch.parallel.ShardedFusedKKTSolver`` runs in gloo
processes on CPU tensors, one per rank, spawned by ``tests/torch_ranks.py``
(K7's plain version, ``kkt_shard_matvec``, is its matvec there); each spawn
runs several cases. The JAX side runs here as ``tests/test_fused_sharded.py``
runs it: ``ShardedFusedKKTSolver(..., interpret=True)`` on the virtual CPU
mesh ``make_mesh(4)``, and the XLA KKT operator. The tolerances are the JAX
tests' own: matvec atol 2e-5·max|y|, x rel 1e-4 across device counts,
α rtol 2e-4, one-pass against two-pass rel 1e-5, a callback stop's x atol
1e-6·max|x|; what is the same computation on every rank, or in both
passes, is held bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import two_pass_lanczos_tpu as jtpl
from two_pass_lanczos_tpu.parallel import ShardedFusedKKTSolver as JaxSharded
from two_pass_lanczos_tpu.parallel import make_mesh as jax_mesh

from torch_cases import CASES, CPU
from torch_ranks import spawn
from two_pass_lanczos_tpu_torch import FusedKKTSolver
from two_pass_lanczos_tpu_torch.models.generator import generate_mcf_instance
from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
    KKTLayout,
    kkt_shard_matvec,
    kkt_shard_matvec_cuda,
)
from two_pass_lanczos_tpu_torch.ops.spmv import kkt_matvec
from two_pass_lanczos_tpu_torch.parallel import (
    initialize_distributed,
    make_mesh,
)


def _random_kkt(rng, m, p):
    u = rng.integers(0, p, m).astype(np.int32)
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    d = rng.uniform(1.0, 3.0, m).astype(np.float32)
    return d, u, v, p


def _problem(seed, m, p):
    rng = np.random.default_rng(seed)
    d, u, v, p = _random_kkt(rng, m, p)
    b = rng.standard_normal(m + p).astype(np.float32)
    return dict(d=d, u=u, v=v, p=p, b=b)


#: the JAX tests' shapes (tests/test_fused_sharded.py)
MAIN = _problem(1, 3000, 300)
UNEVEN = _problem(2, 1003, 97)
SMALL = _problem(3, 800, 64)
PACK = _problem(4, 1200, 96)
CONS = _problem(5, 1500, 150)
ONE = _problem(6, 1200, 120)
CHUNK = _problem(7, 900, 120)
ZERO_CHUNK = _problem(8, 500, 64)
MESH1 = _problem(9, 2000, 200)
#: a decoupled two-node system: b = e1 spans an invariant subspace
BREAK = dict(d=np.array([2.0, 3.0], np.float32),
             u=np.array([0, 1], np.int32), v=np.array([1, 0], np.int32),
             p=2, b=np.eye(4, dtype=np.float32)[0])
K = 20
#: the JAX collectives test's instance (tests/test_collectives.py)
COLL = generate_mcf_instance(20_000, rho=3, instance_id=1)
COLL_B = np.random.default_rng(0).standard_normal(
    COLL.num_arcs + COLL.num_nodes).astype(np.float32)


def _inst(prob):
    return {key: prob[key] for key in ("d", "u", "v", "p")}


def _x(seed, prob):
    n = len(prob["d"]) + prob["p"]
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _rel(x, ref):
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _port_single(prob, k, **kw):
    s = FusedKKTSolver(prob["d"], prob["u"], prob["v"], prob["p"],
                       device=CPU)
    x, dec = s.solve(prob["b"], k=k, **kw)
    return x, dec.alphas.numpy(), dec.steps()


@pytest.fixture(scope="module")
def jax4():
    """The JAX package's sharded solver on the virtual 4-device mesh."""
    mesh = jax_mesh(4)
    s = JaxSharded(MAIN["d"], MAIN["u"], MAIN["v"], MAIN["p"], mesh,
                   interpret=True)
    out = {"arc_idx": [np.asarray(ix) for ix in s.arc_idx],
           "matvec": s.matvec(_x(10, MAIN))}
    for f in ("inv", "exp"):
        x, dec = s.solve(MAIN["b"], k=K, f=f)
        out[f] = (x, np.asarray(dec.alphas), int(dec.steps_taken))
    su = JaxSharded(UNEVEN["d"], UNEVEN["u"], UNEVEN["v"], UNEVEN["p"], mesh,
                    interpret=True)
    out["uneven"] = su.matvec(_x(11, UNEVEN))
    for name, prob, seed in (("main_xla", MAIN, 10),
                             ("uneven_xla", UNEVEN, 11)):
        op = jtpl.make_kkt_operator(prob["d"], prob["u"], prob["v"],
                                    prob["p"], backend="xla",
                                    dtype=jnp.float32)
        out[name] = np.asarray(op.matvec(jnp.asarray(_x(seed, prob))))
    return out


#: the cases every spawn runs
COMMON = [("cons", "solve", dict(CONS, k=12)),
          ("replay", "replay", dict(MAIN, k=K)),
          ("mesh", "mesh", {})]


@pytest.fixture(scope="module")
def ranks4(jax4, tmp_path_factory):
    cases = COMMON + [
        ("matvec", "matvec", dict(_inst(MAIN), x=_x(10, MAIN))),
        ("uneven", "matvec", dict(_inst(UNEVEN), x=_x(11, UNEVEN))),
        ("inv", "solve", dict(MAIN, k=K, f="inv")),
        ("exp", "solve", dict(MAIN, k=K, f="exp")),
        ("multi", "solve", dict(MAIN, k=K, f=("inv", "exp"))),
        ("raw", "solve", dict(MAIN, k=K, raw=True)),
        ("zero", "solve", dict(_inst(SMALL), b=np.zeros(864, np.float32),
                               k=6)),
        ("unpacked", "solve", dict(PACK, k=12)),
        ("packed", "solve", dict(PACK, k=12, packed=True)),
        ("one_pass", "solve", dict(CONS, k=15, method="one_pass")),
        ("two_pass", "solve", dict(CONS, k=15)),
        ("one_single", "solve", dict(ONE, k=12, method="one_pass")),
        ("chunked", "chunked", dict(CHUNK, k=23, chunk=8)),
        ("callback", "callback", dict(CHUNK, k=30, stop_at=11, chunk=4)),
        ("zero_chunked", "zero_chunked", dict(_inst(ZERO_CHUNK), k=8,
                                              chunk=4)),
        ("errors", "errors", _inst(SMALL)),
        ("collectives", "collectives", dict(
            d=COLL.quad_costs.astype(np.float32), u=COLL.arc_u,
            v=COLL.arc_v, p=COLL.num_nodes, b=COLL_B, k=8)),
        ("convert", "convert", dict(MAIN, k=K, arc_idx=jax4["arc_idx"])),
    ]
    return spawn(4, cases, tmp_path_factory.mktemp("ranks4"))


@pytest.fixture(scope="module")
def ranks1(tmp_path_factory):
    cases = COMMON + [
        ("matvec", "matvec", dict(_inst(MAIN), x=_x(10, MAIN))),
        ("one_pass", "solve", dict(CONS, k=15, method="one_pass")),
        ("two_pass", "solve", dict(CONS, k=15)),
        ("callback", "callback", dict(CHUNK, k=30, stop_at=11, chunk=4)),
        ("mesh1", "solve", dict(MESH1, k=15)),
    ]
    return spawn(1, cases, tmp_path_factory.mktemp("ranks1"))


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    cases = COMMON + [
        ("break_one", "solve", dict(BREAK, k=6, method="one_pass")),
        ("break_two", "solve", dict(BREAK, k=6)),
        ("break_chunked", "chunked", dict(BREAK, k=6, chunk=4)),
        ("chunked", "chunked", dict(CHUNK, k=23, chunk=8)),
    ]
    return spawn(2, cases, tmp_path_factory.mktemp("ranks2"))


@pytest.fixture(scope="module")
def ranks3(tmp_path_factory):
    cases = COMMON + [
        ("one_pass", "solve", dict(CONS, k=15, method="one_pass")),
        ("two_pass", "solve", dict(CONS, k=15)),
        ("callback", "callback", dict(CHUNK, k=30, stop_at=11, chunk=4)),
    ]
    return spawn(3, cases, tmp_path_factory.mktemp("ranks3"))


@pytest.fixture(scope="module")
def ranks5(tmp_path_factory):
    return spawn(5, COMMON, tmp_path_factory.mktemp("ranks5"))


@pytest.fixture
def ranks(request):
    """The spawn of ``request.param`` ranks."""
    return request.getfixturevalue(f"ranks{request.param}")


def _same_on_every_rank(ranks, key, field):
    first = ranks[0][key][field]
    for r in ranks[1:]:
        assert np.array_equal(r[key][field], first), (key, field)
    return first


# --- the mesh ---------------------------------------------------------------

@pytest.mark.parametrize("ranks", [1, 4], indirect=True)
def test_mesh_is_the_process_group(ranks):
    for rank, r in enumerate(ranks):
        m = r["mesh"]
        assert (m["rank"], m["size"], m["world"]) == (rank, len(ranks),
                                                      len(ranks))
        assert m["backend"] == "gloo" and m["axis"] == "rows"
        assert m["device"] == "cpu" and m["again"] is True
        assert "requested" in m["too_many"]


@pytest.fixture
def no_run(monkeypatch):
    """An environment that names no distributed run."""
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)


def test_initialize_distributed_without_a_run_is_a_no_op(no_run,
                                                         monkeypatch):
    assert initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    # half a run's environment is refused, never guessed
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="rank"):
        initialize_distributed(device="cpu")
    assert not torch.distributed.is_initialized()


def test_cuda_mesh_without_nccl_raises(no_run, monkeypatch):
    # a CUDA mesh takes NCCL or nothing: no gloo, no CPU fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_nccl_available",
                        lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        make_mesh(1)
    assert not torch.distributed.is_initialized()


# --- matvec -----------------------------------------------------------------

def test_matvec_matches_jax_and_xla(ranks4, jax4):
    y = _same_on_every_rank(ranks4, "matvec", slice(None))
    for ref in (jax4["matvec"], jax4["main_xla"]):
        np.testing.assert_allclose(y, ref, rtol=0,
                                   atol=2e-5 * np.abs(ref).max())


def test_uneven_arc_split(ranks4, jax4):
    y = _same_on_every_rank(ranks4, "uneven", slice(None))
    np.testing.assert_allclose(y, jax4["uneven_xla"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(y, jax4["uneven"], rtol=0, atol=2e-5)


def test_matvec_of_one_rank_is_the_plain_matvec(ranks1):
    y = ranks1[0]["matvec"]
    t = torch.from_numpy
    ref = kkt_matvec(t(MAIN["d"]), t(MAIN["u"]).long(), t(MAIN["v"]).long(),
                     MAIN["p"], t(_x(10, MAIN))).numpy()
    assert np.array_equal(y, ref)


# --- solve ------------------------------------------------------------------

@pytest.mark.parametrize("f", ["inv", "exp"])
def test_matches_jax_sharded_and_single_device(ranks4, jax4, f):
    x = _same_on_every_rank(ranks4, f, "x")
    a = _same_on_every_rank(ranks4, f, "alphas")
    xj, aj, sj = jax4[f]
    x1, a1, s1 = _port_single(MAIN, K, f=f)
    assert ranks4[0][f]["steps"] == sj == s1 == K
    for ref_x, ref_a in ((xj, aj), (x1, a1)):
        assert _rel(x, ref_x) < 1e-4
        np.testing.assert_allclose(a, ref_a, rtol=2e-4)


def test_multi_f_and_raw(ranks4):
    xm = _same_on_every_rank(ranks4, "multi", "x")
    assert xm.shape == (2, MAIN["p"] + 3000)
    # one decomposition, one replay: each row is its single-f solve
    assert np.array_equal(xm[0], ranks4[0]["inv"]["x"])
    assert np.array_equal(xm[1], ranks4[0]["exp"]["x"])
    # raw: each rank's (x_a of its shard, x_n), no collective
    x = ranks4[0]["inv"]["x"]
    for r in ranks4:
        raw = r["raw"]["x"]
        a0, md = raw["arc0"], raw["m_d"]
        assert np.array_equal(raw["xa"], x[a0:a0 + md])
        assert np.array_equal(raw["xn"], x[3000:])


def test_zero_b(ranks4):
    r = ranks4[0]["zero"]
    assert r["steps"] == 0
    np.testing.assert_array_equal(r["x"], 0.0)


def test_prepacked_b_bit_identical(ranks4):
    for r in ranks4:
        assert np.array_equal(r["packed"]["x"], r["unpacked"]["x"])
        assert np.array_equal(r["packed"]["alphas"], r["unpacked"]["alphas"])


@pytest.mark.parametrize("ranks", [1, 2, 3, 4, 5], indirect=True)
def test_mesh_sizes_consistent(ranks):
    x = _same_on_every_rank(ranks, "cons", "x")
    x1, _, _ = _port_single(CONS, 12)
    assert _rel(x, x1) < 1e-4


def test_mesh_of_one_is_the_single_device_path(ranks1):
    r = ranks1[0]["mesh1"]
    x1, a1, s1 = _port_single(MESH1, 15)
    assert r["steps"] == s1 == 15
    assert _rel(r["x"], x1) < 1e-4
    np.testing.assert_allclose(r["alphas"], a1, rtol=2e-4)


# --- one-pass ---------------------------------------------------------------

@pytest.mark.parametrize("ranks", [1, 3, 4], indirect=True)
def test_one_pass_matches_two_pass(ranks):
    for r in ranks:
        one, two = r["one_pass"], r["two_pass"]
        # the same pass one, so the same coefficients; x by the basis GEMV
        # and by the replay agree to rounding
        assert np.array_equal(one["alphas"], two["alphas"])
        assert np.array_equal(one["betas"], two["betas"])
        assert _rel(one["x"], two["x"]) < 1e-5


def test_one_pass_matches_single_device(ranks4):
    x = _same_on_every_rank(ranks4, "one_single", "x")
    x1, _, _ = _port_single(ONE, 12, method="one_pass")
    assert _rel(x, x1) < 1e-4


def test_one_pass_breakdown_truncates_basis(ranks2):
    r = ranks2[0]["break_one"]
    assert 0 < r["steps"] < 6 and np.isfinite(r["x"]).all()
    assert r["steps"] == ranks2[0]["break_two"]["steps"]


def test_one_pass_hbm_admission(ranks4):
    e = ranks4[0]["errors"]
    assert e["hbm"].startswith("ValueError") and "HBM" in e["hbm"]
    # k·(largest shard + p)·4 bytes per rank, admitted against 64 GiB
    assert e["one_pass_bytes"] == 7 * (max(e["shard_sizes"]) + 64) * 4
    assert e["budget"] == 64 * 2 ** 30


# --- chunked pass one and the callback --------------------------------------

@pytest.mark.parametrize("ranks", [2, 4], indirect=True)
def test_chunked_bit_identical_to_monolithic(ranks):
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
        # pass one: at most ceil(s/chunk) chunks; pass two: s steps
        assert c["p1_launches"] <= -(-stop_at // chunk)
        assert c["p2_len"] == stop_at
        ref = c["ref"]
        assert np.array_equal(c["alphas"][:stop_at], ref["alphas"])
        np.testing.assert_allclose(c["x"], ref["x"], rtol=0,
                                   atol=1e-6 * np.abs(ref["x"]).max())


def test_breakdown_inside_chunk(ranks2):
    c, two = ranks2[0]["break_chunked"], ranks2[0]["break_two"]
    assert not c["stopped"] and c["steps"] == two["steps"] < 6
    assert np.array_equal(c["alphas"], two["alphas"])


def test_chunked_zero_b(ranks4):
    r = ranks4[0]["zero_chunked"]
    assert r["steps"] == 0 and not r["stopped"] and r["steps_cb"] == 0
    np.testing.assert_array_equal(r["x"], 0.0)


def test_callback_requires_two_pass(ranks4):
    e = ranks4[0]["errors"]
    assert e["callback_one_pass"].startswith("ValueError")
    assert "two_pass" in e["callback_one_pass"]
    assert "two_pass" in e["method"] and "shape" in e["shape"]


# --- replay, collectives, capability, conversion ----------------------------

@pytest.mark.parametrize("ranks", [1, 2, 4], indirect=True)
def test_pass_two_replays_pass_one_bitwise(ranks):
    for r in ranks:
        assert r["replay"]["replay"]  # pass two's v_s is pass one's
        assert r["replay"]["steps"] == K
    # the node block, alpha, beta and |b| are the same bits on every rank
    for field in ("alphas", "betas", "b_norm", "node", "x_node"):
        _same_on_every_rank(ranks, "replay", field)


def test_collectives_per_step_are_O_p(ranks4):
    """Per step only (D, p) node gathers and (D,) scalar gathers; the one
    O(m) collective is the final gather of x (the port's form of the JAX
    package's ``test_fused_path_collectives``)."""
    p, k, d = COLL.num_nodes, 8, 4
    for r in ranks4:
        c = r["collectives"]
        assert c["steps"] == k
        assert c["ops"] == [
            ("all-gather", "f32", (d,), 2 * k + 1),      # |b|, alpha, beta²
            ("all-gather", "f32", (d, p), 2 * k - 1),    # a matvec each
            ("all-gather", "f32", (d, c["width"]), 1),   # x, once
        ]
        per_step = (d * p * 4 * (2 * k - 1) + d * 4 * (2 * k + 1)) / k
        assert per_step < 8 * d * p  # O(p) bytes a step, not O(n)


def test_sharded_solver_from_jax(ranks4):
    for r in ranks4:
        c = r["convert"]
        assert np.array_equal(c["x"], r["inv"]["x"])
        assert "arc_idx differs" in c["refused"]


# --- K7's plain version ------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_shard_matvecs_fold_to_kkt_matvec(case, n_shards):
    rng = np.random.default_rng(3)
    d, u, v, p = CASES[case](rng)
    m = len(d)
    x = torch.from_numpy(rng.standard_normal(m + p).astype(np.float32))
    t = torch.from_numpy
    y = kkt_matvec(t(d), t(u).long(), t(v).long(), p, x)
    parts = []
    for ix in np.array_split(np.arange(m), n_shards):
        lay = KKTLayout.build(d[ix], u[ix], v[ix], p, CPU)
        xl = torch.cat([x[ix[0]:ix[-1] + 1], x[m:]])
        yl = kkt_shard_matvec(lay, xl)
        assert torch.equal(yl[:len(ix)], y[ix[0]:ix[-1] + 1])
        parts.append(yl[len(ix):])
        # e_scale scales the gathers and the partial
        y2 = kkt_shard_matvec(lay, xl, e_scale=2.0)
        ref = lay.d * xl[:len(ix)] + 2 * (xl[len(ix):][lay.u.long()]
                                          - xl[len(ix):][lay.v.long()])
        torch.testing.assert_close(y2[:len(ix)], ref)
        assert torch.equal(y2[len(ix):], 2 * yl[len(ix):])
    folded = parts[0]
    for s in parts[1:]:
        folded = folded + s
    if n_shards == 1:
        assert torch.equal(folded, y[m:])
    absum = torch.zeros(p)
    absum.index_add_(0, t(u).long(), x[:m].abs())
    absum.index_add_(0, t(v).long(), x[:m].abs())
    deg = torch.from_numpy(np.bincount(np.concatenate([u, v]), minlength=p))
    bound = 2 * deg * torch.finfo(torch.float32).eps * absum
    assert bool(((folded - y[m:]).abs() <= bound).all())


def test_shard_kernel_wrapper_refuses_cpu_tensors():
    d, u, v, p = CASES["random"](np.random.default_rng(0))
    lay = KKTLayout.build(d, u, v, p, CPU)
    with pytest.raises(ValueError, match="CUDA"):
        kkt_shard_matvec_cuda(lay, torch.zeros(lay.n))
