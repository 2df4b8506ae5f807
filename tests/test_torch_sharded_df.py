"""The port's arc-sharded double-float solver against the JAX package's.

``two_pass_lanczos_tpu_torch.parallel.DFShardedFusedKKTSolver`` runs in gloo
processes on CPU tensors (``tests/torch_ranks.py``), where K12's plain
version, the shard's ``DFKKTOperator.plain_matvec_df``, is its matvec. The
JAX side runs here as ``tests/test_fused_df.py::TestDFSharded`` runs it: one
4-device ``DFShardedFusedKKTSolver(..., interpret=True)`` on the virtual CPU
mesh, its XLA df path and the f64 oracle. The tolerances are that test's:
α atol 1e-11 against the df paths, α and β atol 1e-10 and x
1e-9·max|x| against f64; what is the same computation on every rank, or in
both passes, is held bitwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import two_pass_lanczos_tpu as jtpl
from two_pass_lanczos_tpu.algorithms.core import pass_one_scan as jax_pass_one
from two_pass_lanczos_tpu.algorithms.df import (
    DFKKTOperator as JaxDFKKTOperator,
    lanczos_pass_one_df as jax_pass_one_df,
)
from two_pass_lanczos_tpu.parallel.fused_sharded_df import (
    DFShardedFusedKKTSolver as JaxDFSharded,
)

from torch_cases import CASES, CPU
from torch_ranks import spawn
from two_pass_lanczos_tpu_torch import DFFusedKKTSolver, DFKKTOperator
from two_pass_lanczos_tpu_torch.ops.df import DF, df_add, df_from_f64
from two_pass_lanczos_tpu_torch.ops.kkt_fused_df import (
    df_kkt_shard_matvec,
    df_kkt_shard_matvec_cuda,
)


def _problem(seed, m, p):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, p, m).astype(np.int32)
    v = ((u + 1 + rng.integers(0, p - 1, m)) % p).astype(np.int32)
    return dict(d=rng.uniform(0.5, 5.0, m), u=u, v=v, p=p,
                b=rng.standard_normal(m + p))


#: the shapes of tests/test_fused_df.py::TestDFSharded
MAIN = _problem(1, 1500, 200)
ZERO = dict(_problem(2, 600, 100), b=np.zeros(700))
K = 12
#: the cases every spawn runs
COMMON = [("solve", "df_solve", dict(MAIN, k=K)),
          ("replay", "df_replay", dict(MAIN, k=K))]


@pytest.fixture(scope="module")
def jax4():
    """The JAX package's df sharded solver on 4 virtual devices, its XLA df
    pass one and the f64 oracle, on MAIN."""
    d, u, v, p, b = (MAIN[key] for key in ("d", "u", "v", "p", "b"))
    mesh = Mesh(np.array(jax.devices()[:4]), ("rows",))
    s = JaxDFSharded(d, u, v, p, mesh, interpret=True)
    x, (a64, b64, steps) = s.solve(b, k=K, f="inv")
    ddf = jax_pass_one_df(JaxDFKKTOperator.from_f64(d, u, v, p), b, K)
    op64 = jtpl.KKTOperator(d=jnp.asarray(d), arc_u=jnp.asarray(u),
                            arc_v=jnp.asarray(v), num_nodes=p)
    dref, _ = jax_pass_one(op64.matvec, jnp.asarray(b), K, emit_basis=False)
    x64 = np.asarray(jtpl.solve_fAb(op64, jnp.asarray(b), k=K, f="inv",
                                    method="two_pass"))
    return {"x": x, "alphas": a64, "betas": b64, "steps": steps,
            "arc_idx": [np.asarray(ix) for ix in s.arc_idx], "m": s.m,
            "p": s.p, "xla_alphas": ddf.alphas_f64(),
            "f64_alphas": np.asarray(dref.alphas)[:K],
            "f64_betas": np.asarray(dref.betas)[:K - 1], "f64_x": x64}


@pytest.fixture(scope="module")
def ranks4(jax4, tmp_path_factory):
    cases = COMMON + [
        ("pair", "df_solve", dict(MAIN, k=K, pair=True)),
        ("packed", "df_solve", dict(MAIN, k=K, packed=True)),
        ("zero", "df_solve", dict(ZERO, k=4)),
        ("collectives", "df_collectives", dict(MAIN, k=8)),
        ("convert", "df_convert", dict(MAIN, k=K, arc_idx=jax4["arc_idx"],
                                       m=jax4["m"], p_jax=jax4["p"])),
    ]
    return spawn(4, cases, tmp_path_factory.mktemp("df4"))


@pytest.fixture(scope="module")
def ranks1(tmp_path_factory):
    return spawn(1, COMMON, tmp_path_factory.mktemp("df1"))


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return spawn(2, COMMON + [("zero", "df_solve", dict(ZERO, k=4))],
                 tmp_path_factory.mktemp("df2"))


@pytest.fixture
def ranks(request):
    """The spawn of ``request.param`` ranks."""
    return request.getfixturevalue(f"ranks{request.param}")


def _same_on_every_rank(ranks, key, field):
    first = ranks[0][key][field]
    for r in ranks[1:]:
        assert np.array_equal(r[key][field], first), (key, field)
    return first


def test_df_sharded_4_ranks_tracks_jax_df_and_f64(ranks4, jax4):
    a = _same_on_every_rank(ranks4, "solve", "alphas")
    bt = _same_on_every_rank(ranks4, "solve", "betas")
    x = _same_on_every_rank(ranks4, "solve", "x")
    assert ranks4[0]["solve"]["steps"] == jax4["steps"] == K
    # the df paths: the JAX sharded solver and its XLA df pass one
    np.testing.assert_allclose(a, jax4["alphas"], rtol=0, atol=1e-11)
    np.testing.assert_allclose(bt, jax4["betas"], rtol=0, atol=1e-11)
    np.testing.assert_allclose(a, jax4["xla_alphas"], rtol=0, atol=1e-11)
    # the f64 oracle
    np.testing.assert_allclose(a, jax4["f64_alphas"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(bt, jax4["f64_betas"], rtol=0, atol=1e-10)
    x64 = jax4["f64_x"]
    np.testing.assert_allclose(x, x64, rtol=0, atol=1e-9 * np.abs(x64).max())
    np.testing.assert_allclose(x, jax4["x"], rtol=0,
                               atol=1e-9 * np.abs(x64).max())


@pytest.mark.parametrize("ranks", [2, 4], indirect=True)
def test_df_sharded_zero_b(ranks):
    for r in ranks:
        z = r["zero"]
        assert z["steps"] == 0 and len(z["alphas"]) == 0
        np.testing.assert_array_equal(z["x"], 0.0)


@pytest.mark.parametrize("ranks", [1, 2, 4], indirect=True)
def test_df_mesh_sizes_consistent(ranks):
    a = _same_on_every_rank(ranks, "solve", "alphas")
    x = _same_on_every_rank(ranks, "solve", "x")
    x1, (a1, _, s1) = DFFusedKKTSolver(
        MAIN["d"], MAIN["u"], MAIN["v"], MAIN["p"], device=CPU).solve(
            MAIN["b"], k=K)
    assert ranks[0]["solve"]["steps"] == s1 == K
    np.testing.assert_allclose(a, a1, rtol=0, atol=1e-11)
    x1 = x1.numpy()
    np.testing.assert_allclose(x, x1, rtol=0, atol=1e-9 * np.abs(x1).max())


@pytest.mark.parametrize("ranks", [1, 2, 4], indirect=True)
def test_df_pass_two_replays_pass_one_bitwise(ranks):
    for r in ranks:
        assert r["replay"]["replay"]  # hi and lo v_s of pass two = pass one
    for i in range(6):  # αh, αl, βh, βl, ‖b‖ pair, steps: the same bits
        first = ranks[0]["replay"]["coeffs"][i]
        assert all(np.array_equal(r["replay"]["coeffs"][i], first)
                   for r in ranks)
    _same_on_every_rank(ranks, "replay", "node")


def test_df_pair_costs_and_packed_b(ranks4):
    for r in ranks4:
        for key in ("pair", "packed"):
            assert np.array_equal(r[key]["x"], r["solve"]["x"]), key
            assert np.array_equal(r[key]["alphas"], r["solve"]["alphas"])


def test_df_collectives_per_step_are_O_p(ranks4):
    """Per step one (D, 2, p) node gather and (D, 2) scalar gathers, never
    a plain f32 reduction of df partials; the final gather of x once."""
    p, k, d = MAIN["p"], 8, 4
    for r in ranks4:
        c = r["collectives"]
        assert c["steps"] == k
        assert c["ops"] == [
            ("all-gather", "f32", (d, 2), 2 * k + 1),
            ("all-gather", "f32", (d, 2, p), 2 * k - 1),
            ("all-gather", "f32", (d, 2, c["width"]), 1),
        ]


def test_df_sharded_solver_from_jax(ranks4):
    for r in ranks4:
        c = r["convert"]
        assert np.array_equal(c["x"], r["solve"]["x"])
        assert "m=1499" in c["refused"]


# --- K12's plain version -----------------------------------------------------

def _df_node_bound(u, v, p, x2):
    """8·(deg+1)·2⁻⁴⁸·Σ|x_a|: two compensated folds of one node sum."""
    m = len(u)
    xa = (x2[0, :m].double() + x2[1, :m].double()).abs()
    t = torch.from_numpy
    absum = torch.zeros(p, dtype=torch.float64)
    absum.index_add_(0, t(u).long(), xa).index_add_(0, t(v).long(), xa)
    deg = t(np.bincount(np.concatenate([u, v]), minlength=p)).double()
    return 8 * (deg + 1) * 2.0 ** -48 * absum


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_df_shard_matvecs_fold_to_plain_matvec_df(case, n_shards):
    rng = np.random.default_rng(3)
    d, u, v, p = CASES[case](rng)
    m = len(d)
    d64 = d.astype(np.float64) * (1.0 + rng.uniform(0, 1e-7, m))
    xdf = df_from_f64(rng.standard_normal(m + p), CPU)
    x2 = torch.stack([xdf.hi, xdf.lo])
    y = DFKKTOperator(d64, u, v, p, device=CPU).plain_matvec_df(xdf)
    acc = None
    for ix in np.array_split(np.arange(m), n_shards):
        op = DFKKTOperator(d64[ix], u[ix], v[ix], p, device=CPU)
        # the local vector as K12 takes it: (hi, lo) pairs
        xl = torch.cat([x2[:, ix[0]:ix[-1] + 1], x2[:, m:]], dim=1).T
        yl = df_kkt_shard_matvec(op, xl)
        mine = len(ix)
        assert tuple(yl.shape) == (mine + p, 2)
        # the arc part is the whole matvec's slice, in both halves
        assert torch.equal(yl[:mine, 0], y.hi[ix[0]:ix[-1] + 1])
        assert torch.equal(yl[:mine, 1], y.lo[ix[0]:ix[-1] + 1])
        part = DF(yl[mine:, 0], yl[mine:, 1])
        acc = part if acc is None else df_add(acc, part)
    if n_shards == 1:
        assert torch.equal(acc.hi, y.hi[m:]) and torch.equal(acc.lo, y.lo[m:])
    got = acc.hi.double() + acc.lo.double()
    want = y.hi[m:].double() + y.lo[m:].double()
    assert bool(((got - want).abs() <= _df_node_bound(u, v, p, x2)).all())


def test_df_shard_kernel_wrapper_refuses_cpu_tensors():
    d, u, v, p = CASES["random"](np.random.default_rng(0))
    op = DFKKTOperator(d.astype(np.float64), u, v, p, device=CPU)
    with pytest.raises(ValueError, match="CUDA"):
        df_kkt_shard_matvec_cuda(op.layout, op.d2,
                                 torch.zeros(op.layout.n, 2))
