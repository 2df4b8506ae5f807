"""The K14 probes' plain versions against what the JAX package's Pallas
probes check, and against the JAX streaming matvec.

The Pallas probes (``scripts/probe_gather.py``, ``scripts/probe/``) run only
on a TPU and build their instances when imported, so they are never
imported here: each test rebuilds a probe's inputs with numpy from the
probe's own seed and shapes and holds the port's plain version to the
probe's own check (``probe_gather.py:46`` take_along_axis, ``:75``
``xn[hi, lo]``, ``:98`` the widened index + 1, ``bench_gather.py:88`` the
strip-wise gather). The stage probe's ``full`` mode is K7's function and is
held against ``kkt_streaming_matvec(..., interpret=True, e_scale=sc)``
(``two_pass_lanczos_tpu/ops/kkt_fused.py:992``) within K7's tolerance,
atol 2e-5·max|y|. The kernels themselves run only on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 19)."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_pass_lanczos_tpu.ops.kkt_fused import (
    LANE,
    SortedKKTLayout,
    kkt_streaming_matvec,
)

from torch_cases import CASES, CPU, node_rows_in_warp_order
from two_pass_lanczos_tpu_torch import probes
from two_pass_lanczos_tpu_torch.ops.kkt_fused import (
    KKTLayout,
    kkt_shard_matvec,
)
from two_pass_lanczos_tpu_torch.probes import bench
from two_pass_lanczos_tpu_torch.probes.gather import (
    MAX_CLUSTER,
    MODES as GATHER_MODES,
    SMEM_MAX_ENTRIES,
    TableNotStaged,
    cluster_plan,
    cluster_slices,
    gather,
    gather_cuda,
    gather_plain,
    two_level,
    vector_plan,
    walk,
)
from two_pass_lanczos_tpu_torch.probes.pipeline import (
    MODES as PIPELINE_MODES,
    NODE_MODES as PIPELINE_NODE_MODES,
    STAGE_COUNTS,
    STORES,
    TILES,
    pipeline,
    pipeline_cuda,
    pipeline_plain,
    ring_plan,
    ring_walk,
)
from two_pass_lanczos_tpu_torch.probes.stages import (
    ARC_MODES,
    MODES as STAGE_MODES,
    NODE_MODES,
    node_sorted_copy,
    stages,
    stages_cuda,
    stages_plain,
)
from two_pass_lanczos_tpu_torch.probes.stream import (
    pack_records,
    stream,
    stream_cuda,
    stream_plain,
    stream_records,
)

ROOT = Path(__file__).resolve().parents[1]
CHUNK = 128  # the probes' CHUNK == LANE == 128
T = torch.from_numpy


def _lanes(rows):
    return np.broadcast_to(np.arange(LANE), (rows, LANE))


# --- K14a: the gather -------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(GATHER_MODES))
def test_sublane_gather_is_take_along_axis(mode):
    """probe_sublane (probe_gather.py:31-46): out[i, l] = xn[idx[i, l], l],
    checked against take_along_axis(axis=0), as the flat index and as the
    two-level (row, lane) index."""
    p2, rows = 32, CHUNK
    xn = np.arange(p2 * LANE, dtype=np.float32).reshape(p2, LANE)
    idx = np.random.default_rng(0).integers(0, p2, (rows, LANE)).astype(
        np.int32)
    want = np.asarray(jnp.take_along_axis(jnp.asarray(xn), jnp.asarray(idx),
                                          axis=0))
    tab = T(xn.reshape(-1))
    flat = gather(tab, T((idx * LANE + _lanes(rows)).reshape(-1)), mode=mode)
    two = gather(tab, T(_lanes(rows).astype(np.uint8).reshape(-1)),
                 hi=T(idx.astype(np.int16).reshape(-1)), mode=mode)
    np.testing.assert_array_equal(flat.numpy().reshape(rows, LANE), want)
    np.testing.assert_array_equal(two.numpy().reshape(rows, LANE), want)


def test_two_step_gather_is_xn_hi_lo():
    """probe_twostep (probe_gather.py:55-75): g = xn[hi, lo] for absolute
    endpoints e, hi = e >> 7, lo = e & 127."""
    p2, rows = 32, CHUNK
    rng = np.random.default_rng(1)
    xn = rng.standard_normal((p2, LANE)).astype(np.float32)
    e = rng.integers(0, p2 * LANE, (rows, LANE)).astype(np.int32)
    hi, lo = e >> 7, e & (LANE - 1)
    want = xn[hi, lo]
    thi, tlo = two_level(T(e.reshape(-1)))
    np.testing.assert_array_equal(thi.numpy(), hi.reshape(-1))
    np.testing.assert_array_equal(tlo.numpy(), lo.reshape(-1))
    got = gather_plain(T(xn.reshape(-1)), tlo, thi)
    np.testing.assert_array_equal(got.numpy().reshape(rows, LANE), want)


@pytest.mark.parametrize("dt", [np.int16, np.int8, np.uint8])
def test_narrow_index_widens(dt):
    """probe_int16 (probe_gather.py:84-98): a narrow index plane widened to
    int32, + 1; here through the gather from a table holding i + 1."""
    a = np.arange(CHUNK * LANE, dtype=np.int32).reshape(CHUNK, LANE)
    lim = np.iinfo(dt).max
    a = (a % lim).astype(dt)
    want = a.astype(np.int32) + 1
    tab = torch.arange(1, lim + 2, dtype=torch.float32)
    got = gather(tab, T(a.reshape(-1)))
    np.testing.assert_array_equal(got.numpy().reshape(CHUNK, LANE),
                                  want.astype(np.float32))


@pytest.mark.parametrize("p_hi,wg", [(10, 5), (29, 5)])
def test_strip_gather_matches_bench_gather(p_hi, wg):
    """bench (bench_gather.py:14-88): the strip-wise sublane gather's check
    ``xn[hi_[:CHUNK], arange(LANE)]`` on the probe's own instance."""
    rng = np.random.default_rng(2)
    c = 336
    p2 = p_hi + 1
    nblk = (p2 + 7) // 8
    xn = rng.standard_normal((nblk * 8, LANE)).astype(np.float32)
    xn[p_hi:] = 0.0
    base = rng.integers(0, max(p_hi - wg, 1), (c, CHUNK)).astype(np.int32)
    off = rng.integers(0, wg * LANE, (c, CHUNK, LANE)).astype(np.int32)
    e = (base[..., None] * LANE + off).reshape(c * CHUNK, LANE)
    hi_ = (e >> 7).astype(np.int32)
    want = xn[hi_[:CHUNK], np.arange(LANE)[None, :]]
    got = gather(T(xn.reshape(-1)),
                 T(_lanes(CHUNK).astype(np.uint8).reshape(-1)),
                 hi=T(hi_[:CHUNK].astype(np.int16).reshape(-1)))
    np.testing.assert_array_equal(got.numpy().reshape(CHUNK, LANE), want)
    # the whole probe: every endpoint through the flat index
    np.testing.assert_array_equal(
        gather_plain(T(xn.reshape(-1)), T(e.reshape(-1))).numpy(),
        xn.reshape(-1)[e.reshape(-1)])


def test_two_level_covers_eight_million_entries():
    idx = torch.tensor([0, 127, 128, 2 ** 15 * 128, 2 ** 23 - 1])
    hi, lo = two_level(idx)
    assert hi.dtype == torch.int16 and lo.dtype == torch.uint8
    np.testing.assert_array_equal(
        ((hi.long() & 0xFFFF) * 128 + lo.long()).numpy(), idx.numpy())
    with pytest.raises(ValueError, match="2\\^23"):
        two_level(torch.tensor([2 ** 23]))


@pytest.mark.parametrize("rem", [0, 1, 2, 3])
@pytest.mark.parametrize("off", [0, 1, 2, 3])
def test_vector_plan_covers_every_entry_once(rem, off):
    """The kernel's walk (vector_plan's scalar head, its quads and the
    tail, strided over the grid's threads, two quads a thread a round)
    writes every entry exactly once, for n mod 4 = rem and indices starting
    at phase off; the quads start aligned; a two-level hi at another phase
    leaves every entry scalar."""
    for n in (rem, 4 + rem, 40 + rem, 1000 + rem):
        for hi_phase in (None, off, (off + 1) % 4):
            head, quads = vector_plan(n, off, hi_phase)
            assert 0 <= head and head + 4 * quads <= n
            assert n - head - 4 * quads < 4 or quads == 0
            if quads:
                assert (off + head) % 4 == 0 and head < 4
            if hi_phase is not None and hi_phase != off:
                assert (head, quads) == (n, 0)
            for threads in (1, 3, 256):
                got = [j for t in walk(n, head, quads, threads) for j in t]
                assert sorted(got) == list(range(n)), (n, hi_phase, threads)


@pytest.mark.parametrize("ntab", [1, 4, 5, 1155, 3651, 58_104, 58_105,
                                  65_536, 200_000, 500_000, 524_288])
def test_cluster_slices_are_a_bijection_onto_the_table(ntab):
    """Every table entry t lives in exactly one slice, rank t >> s at
    t & (2^s - 1); each slice (with the staging header and its alignment)
    fits a block's 232,448 bytes; the cluster is the smallest power of two
    that holds the table."""
    cluster, slice_log2 = cluster_plan(ntab)
    assert cluster & (cluster - 1) == 0 and 1 <= cluster <= MAX_CLUSTER
    slices = cluster_slices(ntab, cluster, slice_log2)
    assert [r for r, _, _ in slices] == list(range(cluster))
    owner = np.full(ntab, -1)
    for rank, first, count in slices:
        assert 16 + 4 * (3 + (1 << slice_log2)) <= 232_448
        assert 0 <= count <= 1 << slice_log2 <= SMEM_MAX_ENTRIES
        assert (owner[first:first + count] == -1).all()
        owner[first:first + count] = rank
    t = np.arange(ntab)
    np.testing.assert_array_equal(owner, t >> slice_log2)
    rank, at = t >> slice_log2, t & ((1 << slice_log2) - 1)
    np.testing.assert_array_equal(
        np.array([slices[r][1] for r in rank]) + at, t)
    if cluster > 1:  # half the cluster would not hold it
        half = -(-ntab // (cluster // 2))
        assert 1 << max(2, (half - 1).bit_length()) > SMEM_MAX_ENTRIES
    assert cluster_plan(500_000) == (16, 15)  # x_a at the headline


@pytest.mark.parametrize("ntab", [524_289, 929_792, 5_000_000, 1 << 23])
def test_cluster_plan_refuses_a_table_past_16_slices(ntab):
    with pytest.raises(TableNotStaged, match="16 slices"):
        cluster_plan(ntab)


# --- K14b: the stream -------------------------------------------------------

def _arc_planes(seed=4, m=1000, p=300):
    d, u, v, p = CASES["random"](np.random.default_rng(seed), m, p)
    x = np.random.default_rng(seed + 1).standard_normal(m).astype(np.float32)
    return T(d), T(u), T(v), T(x)


@pytest.mark.parametrize("threads", [128, 256, 512, 1024])
@pytest.mark.parametrize("apt", [1, 2, 4, 8])
def test_stream_layouts_agree_bitwise(threads, apt):
    d, u, v, x = _arc_planes()
    soa = stream(d, u, v, x, threads, apt)
    aos = stream_records(pack_records(d, u, v, x), threads, apt)
    assert torch.equal(soa, aos) and torch.equal(soa, stream_plain(d, u, v, x))


def test_stream_is_the_stream_blocks_function():
    """stream_blocks.py's y = d·x + 1e-30·(es + eo): the tiny term is far
    below y's ulp, and the plain version rounds each operation once."""
    d, u, v, x = _arc_planes()
    y = stream_plain(d, u, v, x).numpy()
    want = (d.numpy().astype(np.float64) * x.numpy()
            + 1e-30 * (u.numpy() + v.numpy().astype(np.float64)))
    np.testing.assert_allclose(y, want, rtol=2 ** -23, atol=1e-37)
    np.testing.assert_array_equal(y, (d * x).numpy())


def test_stream_records_pack_the_planes():
    d, u, v, x = _arc_planes()
    rec = pack_records(d, u, v, x)
    assert rec.shape == (1000, 4) and rec.is_contiguous()
    assert torch.equal(rec[:, 1].view(torch.int32), u)
    assert torch.equal(rec[:, 3], x)


@pytest.mark.parametrize("threads,apt", [(64, 1), (256, 3), (2048, 1)])
def test_stream_refuses_other_block_shapes(threads, apt):
    d, u, v, x = _arc_planes()
    with pytest.raises(ValueError, match="threads"):
        stream(d, u, v, x, threads, apt)


# --- K14c: the stages of K7 -------------------------------------------------

def _instance(case, seed=5):
    rng = np.random.default_rng(seed)
    d, u, v, p = CASES[case](rng)
    x = rng.standard_normal(len(d) + p).astype(np.float32)
    return d, u, v, p, x


@pytest.mark.parametrize("sc", [1.0, 0.5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_stages_full_matches_jax_streaming_matvec(case, sc):
    d, u, v, p, x = _instance(case)
    m = len(d)
    jl = SortedKKTLayout.build(d, u, v, p)
    arrs = tuple(jnp.asarray(a) for a in (
        jl.u.d2, jl.u.es2, jl.u.eo2, jl.u.gn3,
        jl.v.d2, jl.v.es2, jl.v.eo2, jl.v.gn3))
    wins = (jnp.asarray(jl.u.win), jnp.asarray(jl.v.win))
    xu, xv, xn = (jnp.asarray(a) for a in jl.pack(x))
    yu, _, yn = kkt_streaming_matvec(
        arrs, wins, xu, xv, xn, p_hi=jl.p_hi, c_chunks=jl.u.C, p2=jl.P2,
        wg_u=jl.u.wg, wg_v=jl.v.wg, interpret=True, e_scale=sc)
    ref = jl.unpack(yu, yn)
    lay = KKTLayout.build(d, u, v, p, CPU)
    y = stages(lay, T(x), "full", e_scale=sc).numpy()
    np.testing.assert_allclose(y, ref, rtol=0, atol=2e-5 * np.abs(ref).max())
    assert np.array_equal(y, kkt_shard_matvec(lay, T(x), sc).numpy())
    assert y.shape == (m + p,)


@pytest.mark.parametrize("mode", sorted(STAGE_MODES))
def test_stage_modes_split_k7(mode):
    """Each mode writes exactly its parts; a part it shares with full is
    full's, bit for bit; a skipped part stays zero."""
    d, u, v, p, x = _instance("random")
    m = len(d)
    lay = KKTLayout.build(d, u, v, p, CPU)
    xt = T(x)
    full = stages_plain(lay, xt, "full")
    param = {"alu": 0, "gather": 0}.get(mode, 0)
    y = stages(lay, xt, mode, param)
    arcs, nodes = y[:m], y[m:]
    if mode not in ARC_MODES:
        assert bool((arcs == 0).all())
    elif mode in ("full", "arc_only", "alu", "gather"):
        assert torch.equal(arcs, full[:m])  # alu 0 and gather 0 add nothing
    elif mode == "stream_only":
        assert torch.equal(arcs, lay.d * xt[:m])
    else:  # no_gather: the gathered values replaced by 1e-30·index
        want = (lay.d * xt[:m] + 1e-30 * lay.u.float()) - 1e-30 * lay.v.float()
        assert torch.equal(arcs, want)
    if mode not in NODE_MODES:
        assert bool((nodes == 0).all())
    elif "no_gather" in mode:
        terms = 1e-30 * np.arange(m, dtype=np.float64)
        want = np.zeros(p)
        np.add.at(want, u, terms)
        np.add.at(want, v, -terms)
        np.testing.assert_allclose(nodes.numpy(), want, rtol=1e-5,
                                   atol=1e-40)
    else:
        assert torch.equal(nodes, full[m:])


@pytest.mark.parametrize("scale", [None, 0.5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_node_sorted_copy_sums_bitwise_as_the_gather(case, scale):
    """node_sorted's walk: the signed copy read through the identity index,
    in kkt_node_row_warp's order (node_rows_in_warp_order), is bitwise the
    same walk gathering x_a through ent, in f32 and scaled f32; and the
    plain node_sorted's y_n is the plain full's."""
    d, u, v, p, x = _instance(case)
    m = len(d)
    lay = KKTLayout.build(d, u, v, p, CPU)
    xt = T(x)
    copy = node_sorted_copy(lay, xt)
    assert copy.index.dtype == torch.int32 and copy.xs.dtype == torch.float32
    assert torch.equal(copy.index, torch.arange(2 * m, dtype=torch.int32))
    ent = lay.ent.long()
    arcs = torch.where(ent >= 0, ent, ~ent)
    assert torch.equal(copy.xs.abs(), xt[:m][arcs].abs())
    assert bool((torch.sign(copy.xs) * torch.where(ent >= 0, 1.0, -1.0)
                 == torch.sign(xt[:m][arcs])).all())
    want = node_rows_in_warp_order(lay.ptr, lay.ent, xt[:m], scale)
    got = node_rows_in_warp_order(lay.ptr, copy.index, copy.xs, scale)
    assert torch.equal(got, want)
    e = 1.0 if scale is None else scale
    assert torch.equal(stages_plain(lay, xt, "node_sorted", e_scale=e)[m:],
                       kkt_shard_matvec(lay, xt, e)[m:])


@pytest.mark.parametrize("n_alu", [1, 4, 16])
def test_stage_alu_chain(n_alu):
    d, u, v, p, x = _instance("hub")
    m = len(d)
    lay = KKTLayout.build(d, u, v, p, CPU)
    y = stages(lay, T(x), "alu", n_alu).numpy()
    r = x[:m].copy()
    for _ in range(n_alu):
        r = (r * np.float32(0.999)).astype(np.float32) + np.float32(1e-3)
    full = kkt_shard_matvec(lay, T(x)).numpy()
    want = full[:m] + np.float32(1e-30) * r
    np.testing.assert_array_equal(y[:m], want.astype(np.float32))
    np.testing.assert_array_equal(y[m:], full[m:])


@pytest.mark.parametrize("n_gather", [1, 2, 4])
def test_stage_extra_gathers(n_gather):
    d, u, v, p, x = _instance("degree_zero")
    m = len(d)
    lay = KKTLayout.build(d, u, v, p, CPU)
    y = stages(lay, T(x), "gather", n_gather).numpy()
    xn = x[m:]
    acc = np.zeros(m, np.float32)
    for g in range(1, n_gather + 1):
        acc = acc + xn[(u.astype(np.int64) + g) % p]
    full = kkt_shard_matvec(lay, T(x)).numpy()
    np.testing.assert_array_equal(y[:m], full[:m] + np.float32(1e-30) * acc)


@pytest.mark.parametrize("mode,param", [("bogus", 0), ("gather", 300),
                                        ("alu", -1)])
def test_stages_refuse_bad_modes(mode, param):
    d, u, v, p, x = _instance("random")
    lay = KKTLayout.build(d, u, v, p, CPU)
    with pytest.raises(ValueError):
        stages(lay, T(x), mode, param)


# --- K14d: the pipeline -----------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_plain_is_k7(case):
    d, u, v, p, x = _instance(case)
    lay = KKTLayout.build(d, u, v, p, CPU)
    assert torch.equal(pipeline(lay, T(x)), kkt_shard_matvec(lay, T(x)))


@pytest.mark.parametrize("mode,param", bench.PIPELINE_MODES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_modes_are_bitwise_their_stage_twins(case, mode, param):
    """Each K14d mode is the K14c mode of the same name: the plain
    versions agree bit for bit, at e = 1 and 0.5, through pipeline() on
    the CPU too; the modes without a node part leave y_n zero."""
    d, u, v, p, x = _instance(case)
    m = len(d)
    lay = KKTLayout.build(d, u, v, p, CPU)
    xt = T(x)
    for e in (1.0, 0.5):
        want = stages_plain(lay, xt, mode, param, e)
        assert torch.equal(pipeline_plain(lay, xt, e, mode, param), want)
        assert torch.equal(pipeline(lay, xt, e, mode, param), want)
    y = pipeline_plain(lay, xt, mode=mode, param=param)
    assert bool((y[m:] == 0).all()) == (mode not in PIPELINE_NODE_MODES)
    assert PIPELINE_MODES[mode] == STAGE_MODES[mode]


@pytest.mark.parametrize("sc", [1.0, 0.5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_full_matches_jax_streaming_matvec(case, sc):
    """``full`` (man_full's function) against the JAX streaming matvec in
    interpret mode, within K7's tolerance, atol 2e-5·max|y|."""
    d, u, v, p, x = _instance(case)
    m = len(d)
    jl = SortedKKTLayout.build(d, u, v, p)
    arrs = tuple(jnp.asarray(a) for a in (
        jl.u.d2, jl.u.es2, jl.u.eo2, jl.u.gn3,
        jl.v.d2, jl.v.es2, jl.v.eo2, jl.v.gn3))
    wins = (jnp.asarray(jl.u.win), jnp.asarray(jl.v.win))
    xu, xv, xn = (jnp.asarray(a) for a in jl.pack(x))
    yu, _, yn = kkt_streaming_matvec(
        arrs, wins, xu, xv, xn, p_hi=jl.p_hi, c_chunks=jl.u.C, p2=jl.P2,
        wg_u=jl.u.wg, wg_v=jl.v.wg, interpret=True, e_scale=sc)
    ref = jl.unpack(yu, yn)
    lay = KKTLayout.build(d, u, v, p, CPU)
    y = pipeline(lay, T(x), sc).numpy()
    np.testing.assert_allclose(y, ref, rtol=0, atol=2e-5 * np.abs(ref).max())
    assert y.shape == (m + p,)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("rem", [0, 1, 2, 3])
def test_ring_plan_covers_every_arc_once(tile, rem):
    """The arc kernel's tiles: each tile's body (a multiple of 4 words, by
    bulk copy, 16-byte aligned at both ends) and its tail (up to 3 words,
    by the threads) cover every arc exactly once, for m mod 4 = rem, m
    below one tile and m = 0."""
    for m in (rem, 4 + rem, tile - 4 + rem, tile + rem, 5 * tile + 8 + rem):
        plan = ring_plan(m, tile)
        seen = np.zeros(m, dtype=int)
        for t in plan:
            assert t.base % tile == 0 and 0 < t.count <= tile
            assert t.body % 4 == 0 and 0 <= t.count - t.body <= 3
            assert (4 * t.base) % 16 == 0 and (4 * t.body) % 16 == 0
            seen[t.base:t.base + t.body] += 1       # bulk copy
            seen[t.base + t.body:t.base + t.count] += 1  # the threads
        assert (seen == 1).all(), (m, tile)
        assert len(plan) == -(-m // tile)
        # only the last tile may be ragged, and only it may have a tail
        assert all(t.count == tile for t in plan[:-1])
    assert ring_plan(0, tile) == []


@pytest.mark.parametrize("off", [0, 1, 2, 3])
def test_ring_plan_refuses_arrays_off_16_bytes(off):
    if off:
        with pytest.raises(ValueError, match="16-byte"):
            ring_plan(1000, 1024, off)
    else:
        assert ring_plan(1000, 1024, off)[0].body == 1000


class _MBarrier:
    """An mbarrier's phases: a phase completes when its arrivals (the
    init count) and its armed bytes are all in; try_wait.parity(P) passes
    once the phase of parity P has completed (a fresh barrier is in phase
    0, so P = 1 passes at once)."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def arrive(self, expect_tx=0):
        self.tx += expect_tx
        self.pending -= 1
        self._complete()

    def complete_tx(self, nbytes):
        self.tx -= nbytes
        self._complete()

    def _complete(self):
        assert self.pending >= 0
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def passes(self, parity):
        return (self.phase & 1) != parity


@pytest.mark.parametrize("stages", STAGE_COUNTS)
@pytest.mark.parametrize("ntiles,grid", [(1, 1), (5, 1), (13, 3), (40, 4)])
def test_ring_walk_parities_fill_and_drain_without_a_race(stages, ntiles,
                                                          grid):
    """The arc kernel's ring, run on emulated mbarriers by ring_walk's
    stages and parities under random schedules: the producer never
    refills a stage a consumer warp still reads, every consumer warp reads
    each of its block's tiles in order with that tile's bytes, and the
    ring never stalls (the empty barrier's count is the warps that
    arrive)."""
    warps = 8
    rng = np.random.default_rng(ntiles * 10 + stages)
    for walk in ring_walk(ntiles, grid, stages):
        assert [t for t, *_ in walk] == list(range(walk[0][0] if walk
                                                   else 0, ntiles, grid))
        for _ in range(20):
            full = [_MBarrier(1) for _ in range(stages)]
            empty = [_MBarrier(warps) for _ in range(stages)]
            slot = [None] * stages       # the tile a stage holds
            readers = [0] * stages       # warps still reading a stage
            inflight = []                # (stage, tile) copies not landed
            prod = 0
            cons = [0] * warps
            reading = [False] * warps
            while prod < len(walk) or min(cons) < len(walk) or inflight:
                moves = []
                if prod < len(walk):
                    t, s, _, pe = walk[prod]
                    if empty[s].passes(pe):
                        moves.append(("produce", None))
                if inflight:
                    moves.append(("land", None))
                for w in range(warps):
                    if cons[w] < len(walk):
                        t, s, pf, _ = walk[cons[w]]
                        if reading[w] or full[s].passes(pf):
                            moves.append(("consume", w))
                assert moves, "the ring stalled"
                kind, w = moves[rng.integers(len(moves))]
                if kind == "produce":
                    t, s, _, _ = walk[prod]
                    assert readers[s] == 0, "refilled a stage being read"
                    full[s].arrive(expect_tx=16)
                    inflight.append((s, t))
                    prod += 1
                elif kind == "land":
                    s, t = inflight.pop(rng.integers(len(inflight)))
                    slot[s] = t
                    full[s].complete_tx(16)
                elif not reading[w]:  # the warp passed the full barrier
                    t, s, _, _ = walk[cons[w]]
                    assert slot[s] == t, "read a stage before its copy"
                    reading[w] = True
                    readers[s] += 1
                else:  # done with the stage: the warp's lane 0 arrives
                    t, s, _, _ = walk[cons[w]]
                    reading[w] = False
                    readers[s] -= 1
                    empty[s].arrive()
                    cons[w] += 1


@pytest.mark.parametrize("mode,param", [
    ("bogus", 0), ("node_only", 0), ("gather", 1), ("alu", -1), ("full", 4),
    ("stream_only", 2)])
def test_pipeline_refuses_bad_modes(mode, param):
    d, u, v, p, x = _instance("random")
    lay = KKTLayout.build(d, u, v, p, CPU)
    for call in (pipeline, pipeline_plain):
        with pytest.raises(ValueError, match="mode|param"):
            call(lay, T(x), mode=mode, param=param)


@pytest.mark.parametrize("tile,stages,store", [
    (256, 3, "direct"), (4096, 3, "direct"), (1024, 1, "direct"),
    (1024, 5, "bulk"), (1024, 3, "tma")])
def test_pipeline_refuses_rings_it_has_no_instance_of(tile, stages, store):
    d, u, v, p, x = _instance("random")
    lay = KKTLayout.build(d, u, v, p, CPU)
    with pytest.raises(ValueError, match="the ring takes"):
        pipeline_cuda(lay, T(x), tile=tile, stages=stages, store=store)


# --- wrappers, records and the entry point ----------------------------------

@pytest.mark.parametrize("probe", ["gather", "stream", "stages", "pipeline"])
def test_kernel_wrappers_refuse_cpu_tensors(probe):
    d, u, v, p, x = _instance("random")
    lay = KKTLayout.build(d, u, v, p, CPU)
    xt = T(x)
    calls = {"gather": lambda: gather_cuda(xt, lay.u),
             "stream": lambda: stream_cuda(lay.d, lay.u, lay.v, xt[:len(d)]),
             "stages": lambda: stages_cuda(lay, xt),
             "pipeline": lambda: pipeline_cuda(lay, xt)}
    with pytest.raises(ValueError, match="CUDA"):
        calls[probe]()


@pytest.mark.parametrize("probe", sorted(probes.RUNS))
def test_run_refuses_the_cpu(probe):
    d, u, v, p, x = _instance("random")
    lay = KKTLayout.build(d, u, v, p, CPU)
    with pytest.raises(ValueError, match="card"):
        probes.run(probe, lay, T(x))


def test_entry_point_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the probes would run")
    proc = subprocess.run(
        [sys.executable, "-m", "two_pass_lanczos_tpu_torch.probes", "stages",
         "--arcs", "1000"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert "cuda" in proc.stderr and not proc.stdout


def test_records_and_bounds():
    m, p = 5_000_000, 3651
    assert bench.kkt_function_bytes(m, p) == 20 * m + 8 * p
    r = bench._record("stages", "full", 100_000_000, 100.0, 125.0)
    assert r["bound_us"] == pytest.approx(1e8 / 3.35e12 * 1e6)
    assert r["share"] == pytest.approx(r["bound_us"] / 100.0)
    assert r["gbps"] == pytest.approx(1000.0)
    assert r["share_cold"] < r["share"]


def test_stage_split_names_the_wall():
    def rec(variant, us):
        return bench._record("stages", variant, 100_000_000, us, us + 5)
    base = {"full": 120.0, "arc_only": 40.0, "node_only": 90.0,
            "node_no_gather": 20.0}
    text = probes.stage_split([rec(k, v) for k, v in base.items()])
    assert "bound by the node part" in text and "70.000 us" in text
    base["arc_only"] = 100.0
    text = probes.stage_split([rec(k, v) for k, v in base.items()])
    assert "bound by the arc part" in text
    assert "node-sorted" not in text


def _pipeline_records(alu_us):
    def rec(variant, us, **extra):
        return bench._record("pipeline", variant, 100_000_000, us, us + 5,
                             **extra)
    ring = {"tile": 1024, "stages": 3, "store": "direct",
            "blocks_per_sm": 4}
    out = [rec("pipeline", 120.0, **ring), rec("pipeline_serial", 150.0),
           rec("k7", 118.0), rec("k7_arc_only", 40.0),
           rec("k7_node_only", 90.0), rec("arc_only/direct", 35.0),
           rec("k14c/full", 118.0)]
    for n, us in alu_us.items():
        out += [rec(f"alu{n}/arcs/direct", us),
                rec(f"k14c/alu{n}", 118.0 + n / 4)]
    return out


def test_pipeline_split_answers_max_or_sum():
    """The ALU question: with the stream 40 µs cold and the chain at the
    f32 issue rate (2·N·m / 33.5e12 s), a ring time at the max is nearer
    the max, one at the sum nearer the sum."""
    m, p = 5_000_000, 3651
    alu = {n: 2 * n * m / 33.5e12 * 1e6 for n in (4, 16, 64)}
    text = probes.pipeline_split(_pipeline_records(
        {4: 35.0, 16: 35.0, 64: max(40.0, alu[64]) - 5}), m, p)
    lines = text.splitlines()
    assert "T1024xS3/direct, 4 blocks/SM" in lines[0]
    assert "against serialised 155.000" in lines[1]
    bound = (20 * m + 4 * p) / 3.35e12 * 1e6
    assert f"{bound / 40.0:.1%} of its {bound:.3f} us bound" in lines[2]
    assert all("nearer the max" in ln for ln in lines[3:])
    text = probes.pipeline_split(_pipeline_records(
        {n: 35.0 + alu[n] for n in alu}), m, p)
    assert all("nearer the sum" in ln for ln in text.splitlines()[3:])
    assert [ln.split()[1] for ln in text.splitlines()[3:]] == [
        "4:", "16:", "64:"]


def test_stage_split_prints_the_node_sorted_floor():
    def rec(variant, us):
        return bench._record("stages", variant, 100_000_000, us, us + 5)
    base = {"full": 120.0, "arc_only": 40.0, "node_only": 90.0,
            "node_no_gather": 20.0, "node_sorted": 45.0}
    text = probes.stage_split([rec(k, v) for k, v in base.items()])
    last = text.splitlines()[-1]
    assert "node-sorted copy: 45.000 us" in last
    assert "sector waste 45.000 us (50.0% of node_only" in last
    assert "cold 50.000 against 95.000 us" in last
    assert ("node_sorted", 0) in bench.STAGES
